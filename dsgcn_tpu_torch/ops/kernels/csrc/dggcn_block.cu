// The whole eval GCN block of DG-STGCN (DGGCN) and DS-GCN (DGPHGCN1) in one
// kernel: the Hopper kernel that replaces the TPU kernel
// dsgcn_tpu/ops/pallas/dggcn_block.py:fused_dggcn_block_eval (K6,
// _block_kernel):
//
//   pre = relu(x w_pre + b_pre)                     (T, V, K*Cm)
//   G_k = alpha_k ctr_k + (beta_k ada_k + A_k)      ctr_k optionally the
//                                                   edge-class ctr (edge_k)
//   y   = aggregate(pre, G)                         (T, V, K*Cm)
//   out = relu(y w_post + b_post + res),  res = x w_down + b_down, or x
//
// with every BatchNorm folded into its 1x1 (the wrapper's caller folds
// them, as _fold_block_params does).  Same contract as the Pallas function:
// x (N, T, V, C) float32 or bfloat16, the T-pooled queries x1/x2
// (N, K, Cm, V) built outside, every weight, bias and graph operand
// float32; pre, G and y in float32 (the TPU kernel lifts x to float32);
// out (N, T, V, Cout) in x's type.
//
// Bound on the H100: operations.  The three 1x1 products are
// 2 (C + Cout) K*Cm (+ 2 C Cout with the down path) FLOP a joint row
// against (C + Cout) elements moved, and the graph build and aggregation
// another ~2 V K*Cm on CUDA cores.  So the products run on the tensor
// cores (pointwise_mma.cuh: mma.sync m16n8k8 TF32, float32 operands split
// 3xTF32, a bfloat16 x exact in TF32 and two terms), and nothing but x and
// out touches device memory:
//
// A block owns one sample and a tile of TT whole frames (R rows: TT*V
// padded to the warps' 32-row tiles), staged once in shared memory.  The
// out accumulator (R x Cout) lives in registers, split over the 16 warps
// (32 rows x up to 64 columns each); the down 1x1 goes into it first.
// Then the block walks K*Cm in chunks of CH channels:
//   pre chunk  = x tile w_pre[:, chunk] on tensor cores, + b_pre, ReLU,
//                into shared memory (float32, a channel a row)
//   y chunk    = the aggregation of pre (graph_agg_tiled.cuh
//                aggregate_staged: each graph entry built once a tile, in
//                registers), into shared memory (float32)
//   out acc   += y chunk w_post[chunk, :] on tensor cores
// with each product's weight panels streaming through a cp.async ring (the
// post panels already in flight while the graph is built).  The epilogue
// adds b_post and the residual (b_down, or x from the staged tile), takes
// the ReLU and stores out.  Neither pre nor y reaches device memory.
// What the graph needs beyond a tile's channels is built once a call,
// ahead of the blocks: each (sample, subset)'s base = beta ada + A and
// exponential ctr tables (graph_prep_kernel), and the edge subset's ctr
// (K1's edge_proj_kernel and edge_ctr_kernel).  The wrapper's planner
// (ops/kernels/dggcn_block.py:block_plan) picks TT and CH; the graph
// entries a tile builds stay a small share of its work.  Every output is
// one fixed sequence of sums, no atomics: the same bits on every run.
//
// What bounds it now (PERF.md has the times): issue and latency, not the
// tensor cores' rate.  The mma.sync fragments and their hi/lo splits cost
// instructions on every k-step, the out accumulator takes half of a
// thread's registers, so one block of 16 warps fills an SM, and the
// products, the aggregation and the ring's barriers run in turn.  wgmma
// from shared memory and warps specialised by phase are the next steps.
#include "pointwise_mma.cuh"

namespace dsgcn {

#if !defined(DSGCN_K6_OUT_NT) || !defined(DSGCN_K6_PRE_NT) || \
    !defined(DSGCN_K6_WN) || !defined(DSGCN_K6_VC)
#error "the block geometry is defined by ops/kernels/_build.py (-D flags)"
#endif
constexpr int OUT_NT = DSGCN_K6_OUT_NT;  // n8 tiles of out a warp holds
constexpr int PRE_NT = DSGCN_K6_PRE_NT;  // n8 tiles of a pre chunk a warp
constexpr int AGG_WN = DSGCN_K6_WN;      // destination joints a thread
constexpr int AGG_VC = DSGCN_K6_VC;      // source joints a pass

struct Block {
  const void *x;
  void *out;
  const float *w_pre, *b_pre, *w_post, *b_post, *w_down, *b_down;
  tiled::Args g;  // the graph operands (x1, x2, A, gates, edge subset)
  const float *t1, *t2, *tb;  // graph_prep_kernel's tables and base
  const int *flag;
  int T, C, Cout, TT, R, CH;
};

// Where a block's pieces lie in shared memory (bytes): the x tile (R rows
// of C rounded up to KP, pitch px), the pre chunk (CH rows of
// rp = pre_pitch(R) floats: a channel a row, as the aggregation reads
// it), the y chunk (R rows of CH rounded up to KP, float32, pitch pp: the
// post product's A), the ring of weight panels, and the tables of the
// chunk's subsets.
struct Layout {
  int px, rp, pp, slot;
  size_t pre, y, ring, tab, bytes;
};

__host__ __device__ inline Layout block_layout(int R, int C, int CH, int Cout,
                                               int V, int Cm, int xsize) {
  using namespace pw;
  Layout L;
  L.px = pitch_a(round_up(C, KP) * xsize);
  L.rp = pre_pitch(R);
  L.pp = pitch_a(round_up(CH, KP) * 4);
  L.slot = slot_bytes(CH > Cout ? CH : Cout, 4);
  L.pre = (size_t)R * L.px;
  L.y = L.pre + round_up(CH * L.rp * 4, 16);
  L.ring = L.y + (size_t)R * L.pp;
  L.tab = L.ring + (size_t)STAGES * L.slot;
  const int S = CH > Cm ? CH / Cm : 1;
  L.bytes = L.tab + 4 * ((size_t)2 * S * Cm * row_stride(V) +
                         (size_t)S * V * V);
  return L;
}

template <typename Tio>
__global__ void __launch_bounds__(pw::THREADS, 1)
dggcn_block_kernel(const __grid_constant__ Block b) {
  using namespace pw;
  constexpr bool XF = sizeof(Tio) == 4;   // x needs the hi/lo split
  extern __shared__ __align__(16) unsigned char smem[];
  const tiled::Args &a = b.g;
  const int V = a.V, Cm = a.Cm, KC = a.K * Cm, XS = row_stride(V);
  const int n = blockIdx.y, t0 = blockIdx.x * b.TT;
  const int frames = min(b.TT, b.T - t0), rows = frames * V;
  const int C = b.C, Cout = b.Cout, CH = b.CH, R = b.R;
  const Layout L = block_layout(R, C, CH, Cout, V, Cm, sizeof(Tio));
  unsigned char *xs = smem, *ring = smem + L.ring;
  float *pre_s = (float *)(smem + L.pre), *y_s = (float *)(smem + L.y);
  float *xs1 = (float *)(smem + L.tab), *xs2 = xs1 + (size_t)(
      CH > Cm ? CH : Cm) * XS;
  float *base = xs2 + (size_t)(CH > Cm ? CH : Cm) * XS;
  const int S = CH > Cm ? CH / Cm : 1;
  const int pp = L.pp / 4;                         // floats a pre/y row
  const size_t row0 = ((size_t)n * b.T + t0) * V;  // the tile's first row
  const Tio *x = (const Tio *)b.x + row0 * C;

  // the x tile, its rows past the frames zero (their pre stays finite for
  // the aggregation's reads past the frames); y's columns past CH stay
  // zero (the post product's depth padding), pre's columns past R too
  stage_rows<Tio>(xs, L.px, x, rows, C, round_up(C, KP),
                  (C * sizeof(Tio)) % 16 == 0 && (uintptr_t)b.x % 16 == 0);
  cp_async_commit();
  zero_rows<Tio>(xs, L.px, rows, R, round_up(C, KP));
  const int CHp = round_up(CH, KP);
  for (int i = threadIdx.x; i < R * (CHp - CH); i += blockDim.x)
    y_s[(i / (CHp - CH)) * pp + CH + i % (CHp - CH)] = 0.f;
  for (int i = threadIdx.x; i < CH * (L.rp - R); i += blockDim.x)
    pre_s[(i / (L.rp - R)) * L.rp + R + i % (L.rp - R)] = 0.f;

  const WarpTile wo = warp_tile(R, Cout), wp = warp_tile(R, CH);
  float acc[MT][OUT_NT][4];
  zero(acc);
  if (b.w_down != nullptr) {
    const Weights<float> W(b.w_down, Cout, 0, C, 0, Cout, L.slot);
    ring_begin(ring, L.slot, W);
    block_product<OUT_NT, XF, true>(acc, Tile<Tio>(xs, L.px), ring, L.slot,
                                    W, wo);
  }

  for (int q0 = 0; q0 < KC; q0 += CH) {
    const int k0 = q0 / Cm;
    const bool tables = q0 % Cm == 0;   // the chunk starts new subsets
    {
      const Weights<float> W(b.w_pre, KC, 0, C, q0, CH, L.slot);
      ring_begin(ring, L.slot, W);
      if (tables)
        tiled::stage_tables(n, a.K, k0, S, Cm, V, b.t1, b.t2, b.tb, xs1, xs2,
                            base);
      cp_async_commit();
      float pacc[MT][PRE_NT][4];
      zero(pacc);
      block_product<PRE_NT, XF, true>(pacc, Tile<Tio>(xs, L.px), ring,
                                      L.slot, W, wp);
      for_each(pacc, wp, [&](int, int r, int c, float v0, float v1) {
        if (c < CH)
          pre_s[c * L.rp + r] = fmaxf(v0 + __ldg(b.b_pre + q0 + c), 0.f);
        if (c + 1 < CH)
          pre_s[(c + 1) * L.rp + r] =
              fmaxf(v1 + __ldg(b.b_pre + q0 + c + 1), 0.f);
      });
    }
    // the post panels fly while the graph is built
    const Weights<float> W(b.w_post, Cout, q0, q0 + CH, 0, Cout,
                           L.slot);
    ring_begin(ring, L.slot, W);
    cp_async_wait<STAGES - 1>();         // pre's panels and the tables
    __syncthreads();
    tiled::aggregate_staged<float, AGG_VC, AGG_WN>(
        a, b.flag, pre_s, L.rp, frames, n, q0, CH, xs1, xs2, base,
        [&](int t, int w, int c, float v, bool first) {
          float &y = y_s[(t * V + w) * pp + c];
          y = first ? v : y + v;
        });
    __syncthreads();
    block_product<OUT_NT, true, true>(
        acc, Tile<float>((const unsigned char *)y_s, L.pp), ring, L.slot, W,
        wo);
  }

  // out = relu(acc + b_post + res), res = b_down (the down product is in
  // acc) or x, stored from the accumulator fragments a pair of columns a
  // lane: a warp's store is 8 rows of 32 contiguous bytes (float32)
  Tio *out = (Tio *)b.out + row0 * Cout;
  const bool pairs = Cout % 2 == 0 && (uintptr_t)b.out % (2 * sizeof(Tio)) == 0;
  for_each(acc, wo, [&](int, int r, int c, float v0, float v1) {
    if (r >= rows || c >= Cout) return;
    float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = c + e < Cout ? c + e : c;
      const float res =
          b.w_down != nullptr
              ? __ldg(b.b_down + o)
              : to_f32(*(const Tio *)(xs + (size_t)r * L.px + o * sizeof(Tio)));
      v[e] = fmaxf(v[e] + __ldg(b.b_post + o) + res, 0.f);
    }
    Tio *o = out + (size_t)r * Cout + c;
    if (pairs) {
      store_pair(o, v[0], v[1]);
    } else {
      o[0] = from_f32<Tio>(v[0]);
      if (c + 1 < Cout) o[1] = from_f32<Tio>(v[1]);
    }
  });
}

// Sizes and plans the kernel does not take, shared memory aside: the
// planner (ops/kernels/dggcn_block.py block_plan) refuses them first.
inline bool refuse(const Block &b, int N, bool down) {
  using namespace pw;
  const tiled::Args &a = b.g;
  const int KC = a.K * a.Cm;
  if (a.V < 1 || a.V > VMAX || a.E > EMAX || a.Cm < 1 || a.K < 1 ||
      b.C < 1 || b.Cout < 1 || N < 1 || N > 65535 || b.TT < 1 ||
      b.CH < 1 || KC % b.CH || (b.CH % a.Cm && a.Cm % b.CH) ||
      b.R % WARP_ROWS || WARPS % (b.R / WARP_ROWS) || b.TT * a.V > b.R ||
      (!down && b.C != b.Cout))
    return true;
  return tiles_per_warp(b.R, b.Cout) > OUT_NT ||
         tiles_per_warp(b.R, b.CH) > PRE_NT;
}

template <typename Tio>
static int launch(const Block &b, int N, cudaStream_t stream) {
  auto kernel = dggcn_block_kernel<Tio>;
  const size_t smem = block_layout(b.R, b.C, b.CH, b.Cout, b.g.V, b.g.Cm,
                                   sizeof(Tio)).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b.T + b.TT - 1) / b.TT, N);
  kernel<<<grid, pw::THREADS, smem, stream>>>(b);
  return (int)cudaGetLastError();
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  w_down/b_down
// null: the residual is x (C == Cout).  TT (frames a block), R (its rows)
// and CH (channels a chunk) come from the wrapper's planner; p1s, p2s
// (N*E*V*Cm floats each) and ectr (N*V*V*Cm) are the edge subset's
// scratch, unused without one.  Returns a cudaError_t; the caller has
// checked shapes, types and devices.
extern "C" int dsgcn_dggcn_block(const void *x, void *out, int bf16,
                                 const float *x1, const float *x2,
                                 const float *w_pre, const float *b_pre,
                                 const float *A, const float *alpha,
                                 const float *beta, const float *w_post,
                                 const float *b_post, const float *w_down,
                                 const float *b_down, const float *edge_w,
                                 const float *bias_field, const float *sel,
                                 float *p1s, float *p2s, float *ectr,
                                 float *t1, float *t2, float *tb, int *flag,
                                 int N,
                                 int T, int V, int C, int K, int Cm, int Cout,
                                 int E, int edge_k, int TT, int R, int CH,
                                 void *stream) {
  using namespace dsgcn;
  tiled::Args g{nullptr, nullptr, x1,   x2,  A,      alpha, beta,
                edge_w,  nullptr, nullptr, sel, bias_field, ectr, T,
                V,       K,       Cm,   0,   E,      edge_k, -1,
                T,       0};
  const Block b{x,    out,  w_pre, b_pre, w_post, b_post, w_down,
                b_down, g,  t1,  t2,    tb,     flag,   T,
                C,    Cout, TT,    R,     CH};
  if (refuse(b, N, w_down != nullptr) ||
      block_layout(R, C, CH, Cout, V, Cm, bf16 ? 2 : 4).bytes >
          pw::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (edge_k >= 0) {
    // the edge subset's projections and ctr for the whole call; the bias
    // field is (Cm, V, V)
    tiled::Args e = g;
    const int err = tiled::launch_edge(e, N, p1s, p2s, V * V, V, st);
    if (err != 0) return err;
  }
  const int err = tiled::launch_prep(g, N, t1, t2, tb, flag, st);
  if (err != 0) return err;
  return bf16 ? launch<__nv_bfloat16>(b, N, st) : launch<float>(b, N, st);
}

extern "C" const char *dsgcn_dggcn_block_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The block a plan launches: its threads and shared-memory bytes (which
// the kernel refuses over SMEM_LIMIT), and 0 where it refuses the plan for
// another reason (the accumulator tiles).  The planner's model
// (ops/kernels/dggcn_block.py block_smem) is held to it.
extern "C" void dsgcn_dggcn_block_geometry(int V, int C, int K, int Cm,
                                           int Cout, int xsize, int TT, int R,
                                           int CH, int down, int *threads,
                                           int *smem) {
  using namespace dsgcn;
  tiled::Args g{};
  g.V = V;
  g.K = K;
  g.Cm = Cm;
  Block b{};
  b.g = g;
  b.C = C;
  b.Cout = Cout;
  b.TT = TT;
  b.R = R;
  b.CH = CH;
  b.T = TT;
  *threads = pw::THREADS;
  *smem = refuse(b, 1, down)
              ? 0
              : (int)block_layout(R, C, CH, Cout, V, Cm, xsize).bytes;
}
