// Per-subset dynamic-graph aggregation for DG-STGCN eval, the Hopper kernel
// that replaces the TPU kernel
// dsgcn_tpu/ops/pallas/bd_agg.py:bd_dyn_graph_agg_subset (K4).
//
// Same contract and layout as the Pallas function: pre2/y2 (N, T, V*K*Cm)
// in float32 or bfloat16, x1t (N, K, V, Cm), x2 (N, K, Cm, V), A (K, V, V),
// alpha/beta (K,), no edge attention; all graph operands float32.  The ada
// graph arrives precomputed as (N*K, V, V), as the Pallas wrapper builds it
// outside its kernel (bd_agg.py:275-281): it contracts over a subset's full
// Cm, so a block that holds one channel group cannot rebuild it, and the
// v_real source mask is applied there.  Each block builds only
// alpha*tanh(x1 - x2) + (beta*ada + A) for its channel group and
// aggregates (graph_agg.cuh).  The TPU kernel folds K and channel groups of
// g into its grid; here a block takes channel_group(Cm) channels of one
// subset whatever g is (the wrapper checks g), and reads pre2 / writes y2 in
// place with strides: the group-major relayouts, the block-diagonal matrix
// M, the column chunks and T tiles of the TPU kernel are not carried over.
//
// Bound on the H100: bytes, as bd_agg.cu: pre2 read once and y2 written
// once, 2*V FLOP per output element; the ada graph, queries and A are read
// once per block and are small.  Speed work (TMA staging, wgmma) is for
// later changes.
#include "graph_agg.cuh"

namespace dsgcn {

template <typename Tio>
__global__ void __launch_bounds__(MAX_THREADS)
bd_agg_subset_kernel(const Tio *__restrict__ pre, Tio *__restrict__ out,
                     const float *__restrict__ x1t,
                     const float *__restrict__ x2,
                     const float *__restrict__ ada,
                     const float *__restrict__ A,
                     const float *__restrict__ alpha,
                     const float *__restrict__ beta, int T, int V, int K,
                     int Cm, int CG) {
  extern __shared__ float smem[];
  const int ncg = Cm / CG;
  const int n = blockIdx.z, k = blockIdx.y / ncg, c0 = (blockIdx.y % ncg) * CG;
  // xs1/xs2 hold the group's CG channels only
  const Smem s = carve_smem(smem, V, CG, CG, 0);
  const int XS = row_stride(V);
  const int tid = threadIdx.x, VV = V * V;

  const float *q1 = x1t + ((size_t)n * K + k) * V * Cm;          // (V, Cm)
  const float *q2 = x2 + (((size_t)n * K + k) * Cm + c0) * V;    // (CG, V)
  const float *ad = ada + ((size_t)n * K + k) * VV;
  for (int i = tid; i < CG * V; i += blockDim.x) {
    const int cl = i % CG, v = i / CG;
    s.xs1[cl * XS + v] = q1[v * Cm + c0 + cl];
    s.xs2[(i / V) * XS + i % V] = q2[i];
  }
  for (int i = tid; i < VV; i += blockDim.x) s.ada[i] = ad[i];
  __syncthreads();

  const int cl = tid % CG, w = tid / CG;
  const bool active = tid < CG * V;
  float g[VMAX];
  if (active)
    graph_column<Tio>(g, cl, cl, w, s, V, CG, A + (size_t)k * VV, alpha[k],
                      beta[k], false, 0, nullptr, nullptr, 0, 0);
  const int t_begin = blockIdx.x * T_CHUNK;
  aggregate<Tio>(g, pre, out, s.pres, n, T, V, K * Cm, k * Cm + c0, CG, cl,
                 w, active, t_begin, min(T, t_begin + T_CHUNK));
}

template <typename Tio>
static int launch(const void *pre, void *out, const float *x1t,
                  const float *x2, const float *ada, const float *A,
                  const float *alpha, const float *beta, int N, int T, int V,
                  int K, int Cm, cudaStream_t stream) {
  const int CG = channel_group(Cm);
  const dim3 grid((T + T_CHUNK - 1) / T_CHUNK, K * (Cm / CG), N);
  const int threads = (CG * V + 31) / 32 * 32;
  const size_t smem = smem_bytes(V, CG, CG, 0);
  cudaError_t err = cudaFuncSetAttribute(
      bd_agg_subset_kernel<Tio>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bd_agg_subset_kernel<Tio><<<grid, threads, smem, stream>>>(
      (const Tio *)pre, (Tio *)out, x1t, x2, ada, A, alpha, beta, T, V, K, Cm,
      CG);
  return (int)cudaGetLastError();
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  Returns a
// cudaError_t; the caller has checked shapes, types and devices.
extern "C" int dsgcn_bd_agg_subset(const void *pre, void *out, int bf16,
                                   const float *x1t, const float *x2,
                                   const float *ada, const float *A,
                                   const float *alpha, const float *beta,
                                   int N, int T, int V, int K, int Cm,
                                   void *stream) {
  using namespace dsgcn;
  if (V < 1 || V > VMAX || Cm < 1 || N > 65535 ||
      K * (Cm / channel_group(Cm)) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(pre, out, x1t, x2, ada, A, alpha, beta,
                                      N, T, V, K, Cm, st)
              : launch<float>(pre, out, x1t, x2, ada, A, alpha, beta, N, T, V,
                              K, Cm, st);
}

extern "C" const char *dsgcn_bd_agg_subset_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
