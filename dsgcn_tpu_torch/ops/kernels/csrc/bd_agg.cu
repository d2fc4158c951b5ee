// Dynamic-graph aggregation for DS-GCN eval, the Hopper kernel that replaces
// the TPU kernel dsgcn_tpu/ops/pallas/bd_agg.py:bd_dyn_graph_agg (K3).
//
// Same contract and layout as the Pallas function: pre2/y2 (N, T, V*K*Cm)
// in float32 or bfloat16, x1t (N, K, V, Cm), x2 (N, K, Cm, V), A (K, V, V),
// alpha/beta (K,), and for the edge-class subset edge_k the precomputed
// projections p1t (N, E, V, Cm), p2 (N, E, Cm, V), the class mask sel
// (E, V, V) and the transposed bias field ebias (V, Cm, V); all graph
// operands float32.  The TPU mechanics (the block-diagonal matrix M, column
// chunks, T tiles sized to VMEM) are not carried over.
//
// Design (graph_agg_tiled.cuh): a block owns one (sample, subset, channel
// group, row range) picked by the wrapper's planner; it builds its graph
// columns once, into registers, and streams the rows of pre through a
// cp.async ring, each staged value feeding several destination joints.
// With an edge subset, edge_ctr_kernel first builds that subset's ctr for
// the whole call into the scratch ectr (N, V, V, Cm), which the wrapper
// allocates.
//
// Bound on the H100: bytes.  Each call reads pre once and writes y once
// (2 * N*T*V*K*Cm elements); the aggregation is 2*V FLOP per output element,
// 6.25 FLOP/B in f32 and 12.5 in bf16, under the card's 20 FLOP/B balance of
// f32 CUDA-core rate (67 TFLOP/s) to memory rate (3.35 TB/s).  So the floor
// is pre + y over 3.35 TB/s.
#include "graph_agg_tiled.cuh"

namespace dsgcn {

template <typename Tio, int VB>
__global__ void __launch_bounds__(tiled::MAX_THREADS, 2)
bd_agg_kernel(const tiled::Args a) {
  tiled::aggregate_block<Tio, VB, true>(a);
}

template <typename Tio>
static int launch(const tiled::Args &a, int N, cudaStream_t st) {
  auto kernel = tiled::joint_bound(a.V) == 25 ? bd_agg_kernel<Tio, 25>
                                              : bd_agg_kernel<Tio, 32>;
  return tiled::launch(kernel, a, N, sizeof(Tio), st);
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  CG (channels a
// block) and rows_per_block come from the wrapper's planner; ectr is the
// edge subset's ctr scratch (N*V*V*Cm floats, unused without one).
// Returns a cudaError_t; the caller has checked shapes, types and devices.
extern "C" int dsgcn_bd_agg(const void *pre, void *out, int bf16,
                            const float *x1t, const float *x2, const float *A,
                            const float *alpha, const float *beta,
                            const float *p1t, const float *p2,
                            const float *sel, const float *ebias, float *ectr,
                            int N, int T, int V, int K, int Cm, int E,
                            int edge_k, int v_real, int CG,
                            int rows_per_block, void *stream) {
  using namespace dsgcn;
  tiled::Args a{pre,   out,  x1t,   x2,  A,  alpha, beta, nullptr,
                p1t,   p2,   sel,   ebias, ectr, T,  V,    K,
                Cm,    CG,   E,     edge_k, v_real, rows_per_block, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (tiled::refuse(a, N)) return (int)cudaErrorInvalidValue;
  if (edge_k >= 0) {
    // ebias is (V, Cm, V)
    const int err = tiled::launch_edge(a, N, nullptr, nullptr, V, Cm * V, st);
    if (err != 0) return err;
  }
  return bf16 ? launch<__nv_bfloat16>(a, N, st) : launch<float>(a, N, st);
}

extern "C" const char *dsgcn_bd_agg_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
