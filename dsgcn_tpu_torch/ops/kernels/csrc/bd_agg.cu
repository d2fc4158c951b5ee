// Dynamic-graph aggregation for DS-GCN eval, the Hopper kernel that replaces
// the TPU kernel dsgcn_tpu/ops/pallas/bd_agg.py:bd_dyn_graph_agg (K3).
//
// Same contract and layout as the Pallas function: pre2/y2 (N, T, V*K*Cm)
// in float32 or bfloat16, x1t (N, K, V, Cm), x2 (N, K, Cm, V), A (K, V, V),
// alpha/beta (K,), and for the edge-class subset edge_k the precomputed
// projections p1t (N, E, V, Cm), p2 (N, E, Cm, V), the class mask sel
// (E, V, V) and the transposed bias field ebias (V, Cm, V); all graph
// operands float32.  The TPU mechanics (the block-diagonal matrix M, column
// chunks, T tiles sized to VMEM) are not carried over: the graph is built per
// thread block in registers and contracted channel by channel
// (graph_agg.cuh).
//
// Bound on the H100: bytes.  Each call reads pre once and writes y once
// (2 * N*T*V*K*Cm elements); the aggregation is 2*V FLOP per output element,
// 6.25 FLOP/B in f32 and 12.5 in bf16, under the card's 20 FLOP/B balance of
// f32 CUDA-core rate (67 TFLOP/s) to memory rate (3.35 TB/s).  So the floor
// is pre + y over 3.35 TB/s; the graph build is recomputed per block from
// tiny operands.  Speed work (TMA staging, wgmma, fusing the 1x1 convs around
// the aggregation) is for later changes.
#include "graph_agg.cuh"

namespace dsgcn {

template <typename Tio>
__global__ void __launch_bounds__(MAX_THREADS)
bd_agg_kernel(const Tio *__restrict__ pre, Tio *__restrict__ out,
              const float *__restrict__ x1t, const float *__restrict__ x2,
              const float *__restrict__ A, const float *__restrict__ alpha,
              const float *__restrict__ beta, const float *__restrict__ p1t,
              const float *__restrict__ p2, const float *__restrict__ sel,
              const float *__restrict__ ebias, int T, int V, int K, int Cm,
              int CG, int E, int edge_k, int v_real) {
  extern __shared__ float smem[];
  const int ncg = Cm / CG;
  const int n = blockIdx.z, k = blockIdx.y / ncg, c0 = (blockIdx.y % ncg) * CG;
  const bool edge = (k == edge_k);
  const Smem s = carve_smem(smem, V, Cm, CG, edge_k >= 0 ? E : 0);
  const int XS = row_stride(V);
  const int tid = threadIdx.x;

  // queries of subset k, as (channel, joint) tables
  const float *q1 = x1t + ((size_t)n * K + k) * V * Cm;   // (V, Cm)
  const float *q2 = x2 + ((size_t)n * K + k) * Cm * V;    // (Cm, V)
  for (int i = tid; i < Cm * V; i += blockDim.x) {
    s.xs1[(i % Cm) * XS + i / Cm] = q1[i];
    s.xs2[(i / V) * XS + i % V] = q2[i];
  }
  if (edge) {
    for (int i = tid; i < E * V * CG; i += blockDim.x) {
      const int cl = i % CG, v = (i / CG) % V, e = i / (CG * V);
      s.p1s[(e * CG + cl) * XS + v] =
          p1t[(((size_t)n * E + e) * V + v) * Cm + c0 + cl];
    }
    for (int i = tid; i < E * CG * V; i += blockDim.x) {
      const int w = i % V, cl = (i / V) % CG, e = i / (V * CG);
      s.p2s[(e * CG + cl) * XS + w] =
          p2[(((size_t)n * E + e) * Cm + c0 + cl) * V + w];
    }
  }
  __syncthreads();
  build_ada(s.ada, s.xs1, s.xs2, Cm, V, v_real);

  const int cl = tid % CG, w = tid / CG;
  const bool active = tid < CG * V;
  float g[VMAX];
  if (active)
    graph_column<Tio>(g, c0 + cl, cl, w, s, V, CG, A + (size_t)k * V * V,
                      alpha[k], beta[k], edge, E, sel, ebias, V, Cm * V);
  const int t_begin = blockIdx.x * T_CHUNK;
  aggregate<Tio>(g, pre, out, s.pres, n, T, V, K * Cm, k * Cm + c0, CG, cl,
                 w, active, t_begin, min(T, t_begin + T_CHUNK));
}

template <typename Tio>
static int launch(const void *pre, void *out, const float *x1t,
                  const float *x2, const float *A, const float *alpha,
                  const float *beta, const float *p1t, const float *p2,
                  const float *sel, const float *ebias, int N, int T, int V,
                  int K, int Cm, int E, int edge_k, int v_real,
                  cudaStream_t stream) {
  const int CG = channel_group(Cm);
  const dim3 grid((T + T_CHUNK - 1) / T_CHUNK, K * (Cm / CG), N);
  const int threads = (CG * V + 31) / 32 * 32;
  const size_t smem = smem_bytes(V, Cm, CG, edge_k >= 0 ? E : 0);
  cudaError_t err = cudaFuncSetAttribute(
      bd_agg_kernel<Tio>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bd_agg_kernel<Tio><<<grid, threads, smem, stream>>>(
      (const Tio *)pre, (Tio *)out, x1t, x2, A, alpha, beta, p1t, p2, sel,
      ebias, T, V, K, Cm, CG, E, edge_k, v_real);
  return (int)cudaGetLastError();
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  Returns a
// cudaError_t; the caller has checked shapes, types and devices.
extern "C" int dsgcn_bd_agg(const void *pre, void *out, int bf16,
                            const float *x1t, const float *x2, const float *A,
                            const float *alpha, const float *beta,
                            const float *p1t, const float *p2,
                            const float *sel, const float *ebias, int N, int T,
                            int V, int K, int Cm, int E, int edge_k,
                            int v_real, void *stream) {
  using namespace dsgcn;
  if (V < 1 || V > VMAX || E > EMAX || Cm < 1 || N > 65535 ||
      K * (Cm / channel_group(Cm)) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(pre, out, x1t, x2, A, alpha, beta, p1t,
                                      p2, sel, ebias, N, T, V, K, Cm, E,
                                      edge_k, v_real, st)
              : launch<float>(pre, out, x1t, x2, A, alpha, beta, p1t, p2, sel,
                              ebias, N, T, V, K, Cm, E, edge_k, v_real, st);
}

extern "C" const char *dsgcn_bd_agg_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
