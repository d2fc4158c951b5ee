// Fused pre-conv + dynamic-graph build + aggregation for DG-STGCN eval: the
// Hopper kernel that replaces the TPU kernel
// dsgcn_tpu/ops/pallas/dyn_graph.py:fused_dyn_graph_agg_eval (K5, the
// w_pre branch of _fwd_pallas -> _kernel).
//
// Same contract as the Pallas function: x (N, T, V, C) in float32 or
// bfloat16, the BatchNorm-folded pre-conv w_pre (C, K*Cm) in x's type and
// b_pre (K*Cm,) in float32, x1/x2 (N, K, Cm, V), A (K, V, V), alpha/beta
// (K,) float32; no edge attention (as in JAX); v_real masks padded sources
// of the ada softmax.  y (N, T, V, K*Cm) in x's type.  It is K1's forward
// with a prologue,
//   pre = relu(x w_pre + b_pre)
// summed in float32 and rounded to x's type as the TPU kernel rounds pre,
// so the (N, T, V, K*Cm) pre tensor never reaches device memory.
//
// Bound on the H100: operations at DG-STGCN's stages, the 1x1 product
// (2 C FLOP a pre element) before the aggregation's 2 V; bytes (x read, y
// written) close behind.  So the product runs on the tensor cores
// (pointwise_mma.cuh: mma.sync m16n8k8 TF32; float32 operands split
// 3xTF32; bfloat16 x and w_pre are exact in TF32, one term, the contract's
// bf16 x bf16 products summed in float32), and each x row is read once a
// block:
//
// A block owns (sample, tile of TT whole frames, chunk of CH channels of
// one or more subsets); a tile's chunks are neighbours in the grid.  It
// stages the x tile (R rows: TT*V padded to the warps' 32-row tiles) once
// in shared memory with 16-byte cp.async copies, streams w_pre[:, chunk]
// through a ring of panels into the tensor-core product, and its epilogue
// adds b_pre, takes the ReLU and rounds pre into shared memory (a channel
// a row).  Then the aggregation (graph_agg_tiled.cuh aggregate_staged:
// each graph entry built once a block, in registers, rounded to x's type
// as K1 rounds it) writes y.  Each (sample, subset)'s base = beta ada + A
// and exponential ctr tables are built once a call ahead of the blocks
// (graph_prep_kernel).  The wrapper's planner (ops/kernels/dyn_graph.py:
// eval_plan) picks TT and CH.  Every output is summed in one fixed order,
// no atomics: the same bits on every run.
//
// What bounds it now (PERF.md has the times): issue and latency, as in K6
// (dggcn_block.cu): the product's fragment loads and splits, one block of
// 16 warps an SM, the product and the aggregation in turn.
#include "pointwise_mma.cuh"

namespace dsgcn {

#if !defined(DSGCN_K5_PRE_NT) || !defined(DSGCN_K5_WN)
#error "the block geometry is defined by ops/kernels/_build.py (-D flags)"
#endif
constexpr int PRE_NT = DSGCN_K5_PRE_NT;  // n8 tiles of a pre chunk a warp
constexpr int AGG_WN = DSGCN_K5_WN;      // destination joints a thread

struct Eval {
  const void *x, *w_pre;
  const float *b_pre;
  void *y;
  tiled::Args g;  // the graph operands
  const float *t1, *t2, *tb;  // graph_prep_kernel's tables and base
  const int *flag;
  int T, C, TT, R, CH;
};

// Where a block's pieces lie in shared memory (bytes): the x tile (R rows
// of C rounded up to KP, pitch px), the pre chunk (CH rows of
// rp = pre_pitch(R) floats: a channel a row, as the aggregation reads
// it), the ring of w_pre panels, and the tables of the chunk's subsets.
struct EvalLayout {
  int px, rp, slot;
  size_t pre, ring, tab, bytes;
};

__host__ __device__ inline EvalLayout eval_layout(int R, int C, int CH, int V,
                                                  int Cm, int esize) {
  using namespace pw;
  EvalLayout L;
  L.px = pitch_a(round_up(C, KP) * esize);
  L.rp = pre_pitch(R);
  L.slot = slot_bytes(CH, esize);
  L.pre = (size_t)R * L.px;
  L.ring = L.pre + round_up(CH * L.rp * 4, 16);
  L.tab = L.ring + (size_t)STAGES * L.slot;
  const int S = CH > Cm ? CH / Cm : 1;
  L.bytes = L.tab + 4 * ((size_t)2 * S * Cm * row_stride(V) +
                         (size_t)S * V * V);
  return L;
}

template <typename Tio, int VB>
__global__ void __launch_bounds__(pw::THREADS, 1)
dyn_graph_eval_kernel(const __grid_constant__ Eval e) {
  using namespace pw;
  constexpr bool F32 = sizeof(Tio) == 4;   // operands need the hi/lo split
  extern __shared__ __align__(16) unsigned char smem[];
  const tiled::Args &a = e.g;
  const int V = a.V, Cm = a.Cm, KC = a.K * Cm, XS = row_stride(V);
  // the chunks of one tile are neighbours in the grid: their x tile is
  // read from device memory once and from L2 after
  const int n = blockIdx.z, q0 = blockIdx.x * e.CH, t0 = blockIdx.y * e.TT;
  const int frames = min(e.TT, e.T - t0), rows = frames * V;
  const int C = e.C, CH = e.CH, R = e.R, k0 = q0 / Cm;
  const int S = CH > Cm ? CH / Cm : 1;
  const EvalLayout L = eval_layout(R, C, CH, V, Cm, sizeof(Tio));
  unsigned char *xs = smem, *ring = smem + L.ring;
  float *pre_s = (float *)(smem + L.pre);
  float *xs1 = (float *)(smem + L.tab), *xs2 = xs1 + (size_t)S * Cm * XS;
  float *base = xs2 + (size_t)S * Cm * XS;
  const size_t row0 = ((size_t)n * e.T + t0) * V;   // the tile's first row

  // the x tile, the chunk's tables and the first w_pre panels in flight
  stage_rows<Tio>(xs, L.px, (const Tio *)e.x + row0 * C, rows, C,
                  round_up(C, KP),
                  (C * sizeof(Tio)) % 16 == 0 && (uintptr_t)e.x % 16 == 0);
  tiled::stage_tables(n, a.K, k0, S, Cm, V, e.t1, e.t2, e.tb, xs1, xs2,
                      base);
  cp_async_commit();
  // the x tile's rows past the frames zero, and pre's columns past R (the
  // aggregation reads past the frames into finite values)
  zero_rows<Tio>(xs, L.px, rows, R, round_up(C, KP));
  for (int i = threadIdx.x; i < CH * (L.rp - R); i += blockDim.x)
    pre_s[(i / (L.rp - R)) * L.rp + R + i % (L.rp - R)] = 0.f;
  const Weights<Tio> W((const Tio *)e.w_pre, KC, 0, C, q0, CH,
                       L.slot);
  ring_begin(ring, L.slot, W);

  // pre = relu(x w_pre + b_pre), rounded to x's type, into shared memory
  const WarpTile wp = warp_tile(R, CH);
  float acc[MT][PRE_NT][4];
  zero(acc);
  block_product<PRE_NT, F32, F32>(acc, Tile<Tio>(xs, L.px), ring, L.slot, W,
                                  wp);
  for_each(acc, wp, [&](int, int r, int c, float v0, float v1) {
    if (c < CH)
      pre_s[c * L.rp + r] = to_f32(from_f32<Tio>(
          fmaxf(v0 + __ldg(e.b_pre + q0 + c), 0.f)));
    if (c + 1 < CH)
      pre_s[(c + 1) * L.rp + r] = to_f32(from_f32<Tio>(
          fmaxf(v1 + __ldg(e.b_pre + q0 + c + 1), 0.f)));
  });
  cp_async_wait<0>();
  __syncthreads();

  // y = aggregate(pre, G), G rounded to x's type as K1 rounds it
  Tio *y = (Tio *)e.y + row0 * KC + q0;
  tiled::aggregate_staged<Tio, VB, AGG_WN>(
      a, e.flag, pre_s, L.rp, frames, n, q0, CH, xs1, xs2, base,
      [&](int t, int w, int c, float v, bool) {
        y[(size_t)(t * V + w) * KC + c] = from_f32<Tio>(v);
      });
}

// Sizes and plans the kernel does not take, shared memory aside: the
// planner (ops/kernels/dyn_graph.py eval_plan) refuses them first.
inline bool refuse(const Eval &e, int N) {
  using namespace pw;
  const tiled::Args &a = e.g;
  const int KC = a.K * a.Cm;
  if (a.V < 1 || a.V > VMAX || a.Cm < 1 || a.K < 1 || e.C < 1 || N < 1 ||
      N > 65535 || e.TT < 1 || e.CH < 1 || KC % e.CH ||
      (e.CH % a.Cm && a.Cm % e.CH) || (e.T + e.TT - 1) / e.TT > 65535 ||
      e.R % WARP_ROWS || WARPS % (e.R / WARP_ROWS) || e.TT * a.V > e.R)
    return true;
  return tiles_per_warp(e.R, e.CH) > PRE_NT;
}

template <typename Tio>
static int launch(const Eval &e, int N, cudaStream_t stream) {
  auto kernel = tiled::joint_bound(e.g.V) == 25
                    ? dyn_graph_eval_kernel<Tio, 25>
                    : dyn_graph_eval_kernel<Tio, 32>;
  const size_t smem =
      eval_layout(e.R, e.C, e.CH, e.g.V, e.g.Cm, sizeof(Tio)).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(e.g.K * e.g.Cm / e.CH, (e.T + e.TT - 1) / e.TT, N);
  kernel<<<grid, pw::THREADS, smem, stream>>>(e);
  return (int)cudaGetLastError();
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  TT (frames a
// block), R (its rows) and CH (channels a block) come from the wrapper's
// planner.  Returns a cudaError_t; the caller has checked shapes, types and
// devices.
extern "C" int dsgcn_dyn_graph_eval(const void *x, const void *w_pre,
                                    const float *b_pre, void *out, int bf16,
                                    const float *x1, const float *x2,
                                    const float *A, const float *alpha,
                                    const float *beta, int N, int T, int V,
                                    int C, int K, int Cm, int v_real, int TT,
                                    int R, int CH, float *t1, float *t2,
                                    float *tb, int *flag, void *stream) {
  using namespace dsgcn;
  tiled::Args g{nullptr, nullptr, x1,      x2,      A,  alpha, beta,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, T,
                V,       K,       Cm,      0,       0,  -1,    v_real,
                T,       0};
  const Eval e{x, w_pre, b_pre, out, g, t1, t2, tb, flag, T, C, TT, R, CH};
  if (refuse(e, N) ||
      eval_layout(R, C, CH, V, Cm, bf16 ? 2 : 4).bytes > pw::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = tiled::launch_prep(g, N, t1, t2, tb, flag, st);
  if (err != 0) return err;
  return bf16 ? launch<__nv_bfloat16>(e, N, st) : launch<float>(e, N, st);
}

extern "C" const char *dsgcn_dyn_graph_eval_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The block a plan launches: its threads and shared-memory bytes (which
// the kernel refuses over SMEM_LIMIT), and 0 where it refuses the plan for
// another reason (the accumulator tiles).  The planner's model
// (ops/kernels/dyn_graph.py eval_block) is held to it.
extern "C" void dsgcn_eval_block_geometry(int V, int C, int K, int Cm,
                                          int esize, int TT, int R, int CH,
                                          int *threads, int *smem) {
  using namespace dsgcn;
  Eval e{};
  e.g.V = V;
  e.g.K = K;
  e.g.Cm = Cm;
  e.C = C;
  e.TT = TT;
  e.R = R;
  e.CH = CH;
  *threads = pw::THREADS;
  *smem = refuse(e, 1) ? 0 : (int)eval_layout(R, C, CH, V, Cm, esize).bytes;
}
