// Fused dynamic-graph build + aggregation, forward: the Hopper kernel that
// replaces the forward of the TPU kernel
// dsgcn_tpu/ops/pallas/dyn_graph.py:fused_dyn_graph_agg (K1, _fwd_pallas ->
// _kernel).  Its backward (K2) is dyn_graph_bwd.cu; the two are one
// torch.autograd.Function in ops/kernels/dyn_graph.py.
//
// Same contract and layout as the Pallas forward: pre/y (N, T, V, K*Cm) in
// float32 or bfloat16, x1/x2 (N, K, Cm, V), A (K, V, V), alpha/beta (K,),
// and for the edge-class subset edge_k the 1x1 edge weights edge_w
// (Cm, E*Cm), the bias field (Cm, V, V) (built by the wrapper from edge_b,
// as _edge_specs_args does) and the class mask sel (E, V, V); all graph
// operands float32.  Unlike bd_agg.cu, the per-class projections
// P = edge_w^T x are computed inside the block.  The graph build and the
// aggregation are shared with bd_agg.cu (graph_agg.cuh); the TPU mechanics
// (T tiles sized to VMEM, the layout rotations) are not carried over.
//
// Bound on the H100: bytes, as bd_agg.cu: pre read once and y written once,
// 2*V FLOP per output element against 8 (f32) or 4 (bf16) bytes.  Speed work
// (TMA staging, wgmma, fusing the 1x1 convs) is for later changes.
#include "graph_agg.cuh"

namespace dsgcn {

template <typename Tio>
__global__ void __launch_bounds__(MAX_THREADS)
dyn_graph_fwd_kernel(const Tio *__restrict__ pre, Tio *__restrict__ out,
                     const float *__restrict__ x1, const float *__restrict__ x2,
                     const float *__restrict__ A,
                     const float *__restrict__ alpha,
                     const float *__restrict__ beta,
                     const float *__restrict__ edge_w,
                     const float *__restrict__ bias_field,
                     const float *__restrict__ sel, int T, int V, int K,
                     int Cm, int CG, int E, int edge_k, int v_real) {
  extern __shared__ float smem[];
  const int ncg = Cm / CG;
  const int n = blockIdx.z, k = blockIdx.y / ncg, c0 = (blockIdx.y % ncg) * CG;
  const bool edge = (k == edge_k);
  const Smem s = carve_smem(smem, V, Cm, CG, edge_k >= 0 ? E : 0);
  const int XS = row_stride(V);
  const int tid = threadIdx.x;

  const float *q1 = x1 + ((size_t)n * K + k) * Cm * V;    // (Cm, V)
  const float *q2 = x2 + ((size_t)n * K + k) * Cm * V;
  for (int i = tid; i < Cm * V; i += blockDim.x) {
    s.xs1[(i / V) * XS + i % V] = q1[i];
    s.xs2[(i / V) * XS + i % V] = q2[i];
  }
  __syncthreads();
  if (edge) edge_projections(s, edge_w, V, Cm, CG, c0, E);
  build_ada(s.ada, s.xs1, s.xs2, Cm, V, v_real);   // syncs before reading

  const int cl = tid % CG, w = tid / CG;
  const bool active = tid < CG * V;
  float g[VMAX];
  if (active)
    graph_column<Tio>(g, c0 + cl, cl, w, s, V, CG, A + (size_t)k * V * V,
                      alpha[k], beta[k], edge, E, sel, bias_field, V * V, V);
  const int t_begin = blockIdx.x * T_CHUNK;
  aggregate<Tio>(g, pre, out, s.pres, n, T, V, K * Cm, k * Cm + c0, CG, cl,
                 w, active, t_begin, min(T, t_begin + T_CHUNK));
}

template <typename Tio>
static int launch(const void *pre, void *out, const float *x1,
                  const float *x2, const float *A, const float *alpha,
                  const float *beta, const float *edge_w,
                  const float *bias_field, const float *sel, int N, int T,
                  int V, int K, int Cm, int E, int edge_k, int v_real,
                  cudaStream_t stream) {
  const int CG = channel_group(Cm);
  const dim3 grid((T + T_CHUNK - 1) / T_CHUNK, K * (Cm / CG), N);
  const int threads = (CG * V + 31) / 32 * 32;
  const size_t smem = smem_bytes(V, Cm, CG, edge_k >= 0 ? E : 0);
  cudaError_t err = cudaFuncSetAttribute(
      dyn_graph_fwd_kernel<Tio>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dyn_graph_fwd_kernel<Tio><<<grid, threads, smem, stream>>>(
      (const Tio *)pre, (Tio *)out, x1, x2, A, alpha, beta, edge_w,
      bias_field, sel, T, V, K, Cm, CG, E, edge_k, v_real);
  return (int)cudaGetLastError();
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  Returns a
// cudaError_t; the caller has checked shapes, types and devices.
extern "C" int dsgcn_dyn_graph_fwd(const void *pre, void *out, int bf16,
                                   const float *x1, const float *x2,
                                   const float *A, const float *alpha,
                                   const float *beta, const float *edge_w,
                                   const float *bias_field, const float *sel,
                                   int N, int T, int V, int K, int Cm, int E,
                                   int edge_k, int v_real, void *stream) {
  using namespace dsgcn;
  if (V < 1 || V > VMAX || E > EMAX || Cm < 1 || N > 65535 ||
      K * (Cm / channel_group(Cm)) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(pre, out, x1, x2, A, alpha, beta,
                                      edge_w, bias_field, sel, N, T, V, K, Cm,
                                      E, edge_k, v_real, st)
              : launch<float>(pre, out, x1, x2, A, alpha, beta, edge_w,
                              bias_field, sel, N, T, V, K, Cm, E, edge_k,
                              v_real, st);
}

extern "C" const char *dsgcn_dyn_graph_fwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
