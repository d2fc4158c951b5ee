// Fused pre-conv + dynamic-graph build + aggregation for DG-STGCN eval: the
// Hopper kernel that replaces the TPU kernel
// dsgcn_tpu/ops/pallas/dyn_graph.py:fused_dyn_graph_agg_eval (K5, the
// w_pre branch of _fwd_pallas -> _kernel).
//
// Same contract as the Pallas function: x (N, T, V, C) in float32 or
// bfloat16, the BatchNorm-folded pre-conv w_pre (C, K*Cm) in x's type and
// b_pre (K*Cm,) in float32, x1/x2 (N, K, Cm, V), A (K, V, V), alpha/beta
// (K,) float32; no edge attention (as in JAX); v_real masks padded sources
// of the ada softmax.  y (N, T, V, K*Cm) in x's type.  It is dyn_graph.cu's
// kernel (K1) with a prologue: each block computes its rows of
//   pre = relu(x w_pre + b_pre)
// for its channel group in shared memory, summed in float32 and rounded to
// x's type as the TPU kernel rounds pre, so the (N, T, V, K*Cm) pre tensor
// never reaches device memory.  The block's (C, CG) column slice of w_pre
// sits in shared memory (16 KB at C = 256, CG = 16); x rows are read
// through the L1/L2 caches.
//
// Bound on the H100: at DG-STGCN's stages the 1x1 product (2*C FLOP per
// pre element on CUDA cores) outweighs the bytes (x read, y written); each
// x row is read again by each of the K*Cm/CG channel groups, from L2.  A
// simple kernel: one pre element per thread and step; register tiling or
// wgmma for the product is later work.
#include "graph_agg.cuh"

namespace dsgcn {

template <typename Tio>
__global__ void __launch_bounds__(MAX_THREADS)
dyn_graph_eval_kernel(const Tio *__restrict__ x, const Tio *__restrict__ w_pre,
                      const float *__restrict__ b_pre, Tio *__restrict__ out,
                      const float *__restrict__ x1,
                      const float *__restrict__ x2,
                      const float *__restrict__ A,
                      const float *__restrict__ alpha,
                      const float *__restrict__ beta, int T, int V, int C,
                      int K, int Cm, int CG, int v_real) {
  extern __shared__ float smem[];
  const int ncg = Cm / CG;
  const int n = blockIdx.z, k = blockIdx.y / ncg, c0 = (blockIdx.y % ncg) * CG;
  const int KC = K * Cm, ch0 = k * Cm + c0;
  const Smem s = carve_smem(smem, V, Cm, CG, 0);
  float *ws = s.pres + T_TILE * V * CG;   // (C, CG): w_pre[:, ch0:ch0+CG]
  float *bs = ws + C * CG;                // (CG,)
  const int XS = row_stride(V);
  const int tid = threadIdx.x;

  const float *q1 = x1 + ((size_t)n * K + k) * Cm * V;    // (Cm, V)
  const float *q2 = x2 + ((size_t)n * K + k) * Cm * V;
  for (int i = tid; i < Cm * V; i += blockDim.x) {
    s.xs1[(i / V) * XS + i % V] = q1[i];
    s.xs2[(i / V) * XS + i % V] = q2[i];
  }
  for (int i = tid; i < C * CG; i += blockDim.x)
    ws[i] = to_f32(w_pre[(size_t)(i / CG) * KC + ch0 + i % CG]);
  for (int i = tid; i < CG; i += blockDim.x) bs[i] = b_pre[ch0 + i];
  __syncthreads();
  build_ada(s.ada, s.xs1, s.xs2, Cm, V, v_real);   // syncs before reading

  const int cl = tid % CG, w = tid / CG;
  const bool active = tid < CG * V;
  float g[VMAX];
  if (active)
    graph_column<Tio>(g, c0 + cl, cl, w, s, V, CG, A + (size_t)k * V * V,
                      alpha[k], beta[k], false, 0, nullptr, nullptr, 0, 0);
  const int t_begin = blockIdx.x * T_CHUNK;
  const int t_end = min(T, t_begin + T_CHUNK);
  for (int t0 = t_begin; t0 < t_end; t0 += T_TILE) {
    const int rows = min(T_TILE, t_end - t0);
    // the prologue: pre rows of the group, as the TPU kernel rounds them
    for (int i = tid; i < rows * V * CG; i += blockDim.x) {
      const int cc = i % CG, rv = i / CG;
      const Tio *xr = x + (((size_t)n * T + t0) * V + rv) * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += to_f32(xr[c]) * ws[c * CG + cc];
      s.pres[i] = to_f32(from_f32<Tio>(fmaxf(acc + bs[cc], 0.f)));
    }
    __syncthreads();
    if (active)
      contract_rows<Tio>(g, s.pres, out, n, T, V, KC, ch0, CG, cl, w, t0,
                         rows);
    __syncthreads();
  }
}

inline size_t eval_smem_bytes(int V, int Cm, int CG, int C) {
  return smem_bytes(V, Cm, CG, 0) + ((size_t)C * CG + CG) * sizeof(float);
}

template <typename Tio>
static int launch(const void *x, const void *w_pre, const float *b_pre,
                  void *out, const float *x1, const float *x2,
                  const float *A, const float *alpha, const float *beta,
                  int N, int T, int V, int C, int K, int Cm, int v_real,
                  cudaStream_t stream) {
  const int CG = channel_group(Cm);
  const dim3 grid((T + T_CHUNK - 1) / T_CHUNK, K * (Cm / CG), N);
  const int threads = (CG * V + 31) / 32 * 32;
  const size_t smem = eval_smem_bytes(V, Cm, CG, C);
  cudaError_t err = cudaFuncSetAttribute(
      dyn_graph_eval_kernel<Tio>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dyn_graph_eval_kernel<Tio><<<grid, threads, smem, stream>>>(
      (const Tio *)x, (const Tio *)w_pre, b_pre, (Tio *)out, x1, x2, A, alpha,
      beta, T, V, C, K, Cm, CG, v_real);
  return (int)cudaGetLastError();
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  Returns a
// cudaError_t; the caller has checked shapes, types and devices.
extern "C" int dsgcn_dyn_graph_eval(const void *x, const void *w_pre,
                                    const float *b_pre, void *out, int bf16,
                                    const float *x1, const float *x2,
                                    const float *A, const float *alpha,
                                    const float *beta, int N, int T, int V,
                                    int C, int K, int Cm, int v_real,
                                    void *stream) {
  using namespace dsgcn;
  if (V < 1 || V > VMAX || Cm < 1 || C < 1 || N > 65535 ||
      K * (Cm / channel_group(Cm)) > 65535 ||
      eval_smem_bytes(V, Cm, channel_group(Cm), C) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, w_pre, b_pre, out, x1, x2, A, alpha,
                                      beta, N, T, V, C, K, Cm, v_real, st)
              : launch<float>(x, w_pre, b_pre, out, x1, x2, A, alpha, beta, N,
                              T, V, C, K, Cm, v_real, st);
}

extern "C" const char *dsgcn_dyn_graph_eval_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
