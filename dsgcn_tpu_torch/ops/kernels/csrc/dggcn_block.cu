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
// float32; all arithmetic in float32 (the TPU kernel lifts x to float32 and
// keeps pre, G and y there); out (N, T, V, Cout) in x's type.
//
// Design: a block owns one sample and a tile of TT frames.  It computes pre
// for all K*Cm channels of its rows into shared memory, then per subset
// loads the subset's queries, builds ada, and per channel group builds each
// thread's graph column in registers (graph_agg.cuh, the edge-class column
// builder on the edge subset) and aggregates into a y tile in shared
// memory; then the post 1x1, the residual or down 1x1 and the final ReLU
// write out.  Only x is read and only out is written; the weights are read
// from global memory through L1/L2, not staged (at DG-STGCN's widest block,
// K*Cm = 512 and Cout = 256, one frame's pre and y tiles take 102 KB of
// shared memory).  TT is the largest tile (at most TT_MAX frames) whose
// tiles fit.  The graphs are rebuilt per tile, as the TPU kernel does.
//
// Bound on the H100: operations at DG-STGCN's and DS-GCN's stages: the
// three 1x1 products, 2*(C + Cout)*K*Cm (+ 2*C*Cout with down) FLOP per
// joint row on CUDA cores, against (C + Cout) elements moved.  A simple
// kernel: one output per thread and step, CUDA-core loops; register tiling
// and wgmma for the products are later work.
#include "graph_agg.cuh"

namespace dsgcn {

constexpr int BLOCK_THREADS = 512;   // >= CG * V for CG <= 16, V <= 32
constexpr int TT_MAX = 8;            // most frames per block
constexpr size_t SMEM_LIMIT = 232448;

// Shared memory of a block, in floats: pre and y tiles (TT, V, K*Cm), one
// subset's queries (Cm rows each), ada (V, V), the class projections of one
// channel group (edge subset only).
inline size_t block_smem_bytes(int TT, int V, int KC, int Cm, int CG, int E) {
  const int XS = row_stride(V);
  const size_t floats = 2 * (size_t)TT * V * KC + 2 * (size_t)Cm * XS +
                        (size_t)V * V + 2 * (size_t)E * CG * XS;
  return floats * sizeof(float);
}

// The largest frame tile that fits, or 0 when one frame does not.
inline int frame_tile(int T, int V, int KC, int Cm, int CG, int E) {
  for (int tt = TT_MAX < T ? TT_MAX : T; tt >= 1; --tt)
    if (block_smem_bytes(tt, V, KC, Cm, CG, E) <= SMEM_LIMIT) return tt;
  return 0;
}

template <typename Tio>
__global__ void __launch_bounds__(BLOCK_THREADS)
dggcn_block_kernel(const Tio *__restrict__ x, Tio *__restrict__ out,
                   const float *__restrict__ x1, const float *__restrict__ x2,
                   const float *__restrict__ w_pre,
                   const float *__restrict__ b_pre,
                   const float *__restrict__ A,
                   const float *__restrict__ alpha,
                   const float *__restrict__ beta,
                   const float *__restrict__ w_post,
                   const float *__restrict__ b_post,
                   const float *__restrict__ w_down,
                   const float *__restrict__ b_down,
                   const float *__restrict__ edge_w,
                   const float *__restrict__ bias_field,
                   const float *__restrict__ sel, int T, int V, int C, int K,
                   int Cm, int Cout, int CG, int TT, int E, int edge_k) {
  extern __shared__ float smem[];
  const int n = blockIdx.y, t0 = blockIdx.x * TT, rows = min(TT, T - t0);
  const int KC = K * Cm, XS = row_stride(V), VV = V * V;
  const int tid = threadIdx.x;
  float *pre_s = smem;                         // (TT, V, KC)
  float *y_s = pre_s + (size_t)TT * V * KC;    // (TT, V, KC)
  Smem s;
  s.xs1 = y_s + (size_t)TT * V * KC;
  s.xs2 = s.xs1 + Cm * XS;
  s.ada = s.xs2 + Cm * XS;
  s.p1s = s.ada + VV;
  s.p2s = s.p1s + (edge_k >= 0 ? E : 0) * CG * XS;
  s.pres = nullptr;
  const size_t row0 = ((size_t)n * T + t0) * V;   // first joint row of the tile

  // pre = relu(x w_pre + b_pre), every channel of the tile's rows
  for (int i = tid; i < rows * V * KC; i += blockDim.x) {
    const int o = i % KC;
    const Tio *xr = x + (row0 + i / KC) * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c)
      acc += to_f32(xr[c]) * __ldg(w_pre + (size_t)c * KC + o);
    pre_s[i] = fmaxf(acc + __ldg(b_pre + o), 0.f);
  }

  // per subset: graph columns in registers, y = aggregate(pre, G)
  const int cl = tid % CG, w = tid / CG;
  const bool active = tid < CG * V;
  for (int k = 0; k < K; ++k) {
    const bool edge = (k == edge_k);
    const size_t q = ((size_t)n * K + k) * Cm * V;
    __syncthreads();               // pre written / the last subset's read
    for (int j = tid; j < Cm * V; j += blockDim.x) {
      s.xs1[(j / V) * XS + j % V] = x1[q + j];
      s.xs2[(j / V) * XS + j % V] = x2[q + j];
    }
    __syncthreads();
    build_ada(s.ada, s.xs1, s.xs2, Cm, V, -1);   // syncs before reading
    for (int c0 = 0; c0 < Cm; c0 += CG) {
      if (edge) {
        edge_projections(s, edge_w, V, Cm, CG, c0, E);
        __syncthreads();
      }
      if (active) {
        float g[VMAX];
        graph_column<float>(g, c0 + cl, cl, w, s, V, CG, A + (size_t)k * VV,
                            alpha[k], beta[k], edge, E, sel, bias_field, VV,
                            V);
        const int ch = k * Cm + c0 + cl;
        for (int r = 0; r < rows; ++r) {
          const float *pr = pre_s + (size_t)r * V * KC + ch;
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < VMAX; ++v)
            if (v < V) acc += pr[v * KC] * g[v];
          y_s[((size_t)r * V + w) * KC + ch] = acc;
        }
      }
      if (edge) __syncthreads();   // the next group rebuilds p1s/p2s
    }
  }
  __syncthreads();                 // y complete

  // out = relu(y w_post + b_post + res)
  for (int i = tid; i < rows * V * Cout; i += blockDim.x) {
    const int o = i % Cout;
    const size_t rv = i / Cout;
    const float *yr = y_s + rv * KC;
    float acc = 0.f;
    for (int j = 0; j < KC; ++j)
      acc += yr[j] * __ldg(w_post + (size_t)j * Cout + o);
    acc += __ldg(b_post + o);
    const Tio *xr = x + (row0 + rv) * C;
    float res;
    if (w_down != nullptr) {
      res = 0.f;
      for (int c = 0; c < C; ++c)
        res += to_f32(xr[c]) * __ldg(w_down + (size_t)c * Cout + o);
      res += __ldg(b_down + o);
    } else {
      res = to_f32(xr[o]);
    }
    out[(row0 + rv) * Cout + o] = from_f32<Tio>(fmaxf(acc + res, 0.f));
  }
}

template <typename Tio>
static int launch(const void *x, void *out, const float *x1, const float *x2,
                  const float *w_pre, const float *b_pre, const float *A,
                  const float *alpha, const float *beta, const float *w_post,
                  const float *b_post, const float *w_down,
                  const float *b_down, const float *edge_w,
                  const float *bias_field, const float *sel, int N, int T,
                  int V, int C, int K, int Cm, int Cout, int E, int edge_k,
                  cudaStream_t stream) {
  const int CG = channel_group(Cm);
  const int e = edge_k >= 0 ? E : 0;
  const int TT = frame_tile(T, V, K * Cm, Cm, CG, e);
  if (TT == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes(TT, V, K * Cm, Cm, CG, e);
  cudaError_t err = cudaFuncSetAttribute(
      dggcn_block_kernel<Tio>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, N);
  dggcn_block_kernel<Tio><<<grid, BLOCK_THREADS, smem, stream>>>(
      (const Tio *)x, (Tio *)out, x1, x2, w_pre, b_pre, A, alpha, beta,
      w_post, b_post, w_down, b_down, edge_w, bias_field, sel, T, V, C, K, Cm,
      Cout, CG, TT, E, edge_k);
  return (int)cudaGetLastError();
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  w_down/b_down
// null: the residual is x (C == Cout).  Returns a cudaError_t; the caller
// has checked shapes, types and devices.
extern "C" int dsgcn_dggcn_block(const void *x, void *out, int bf16,
                                 const float *x1, const float *x2,
                                 const float *w_pre, const float *b_pre,
                                 const float *A, const float *alpha,
                                 const float *beta, const float *w_post,
                                 const float *b_post, const float *w_down,
                                 const float *b_down, const float *edge_w,
                                 const float *bias_field, const float *sel,
                                 int N, int T, int V, int C, int K, int Cm,
                                 int Cout, int E, int edge_k, void *stream) {
  using namespace dsgcn;
  if (V < 1 || V > VMAX || E > EMAX || Cm < 1 || C < 1 || Cout < 1 ||
      N > 65535 || (w_down == nullptr && C != Cout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, out, x1, x2, w_pre, b_pre, A, alpha,
                                      beta, w_post, b_post, w_down, b_down,
                                      edge_w, bias_field, sel, N, T, V, C, K,
                                      Cm, Cout, E, edge_k, st)
              : launch<float>(x, out, x1, x2, w_pre, b_pre, A, alpha, beta,
                              w_post, b_post, w_down, b_down, edge_w,
                              bias_field, sel, N, T, V, C, K, Cm, Cout, E,
                              edge_k, st);
}

extern "C" const char *dsgcn_dggcn_block_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
