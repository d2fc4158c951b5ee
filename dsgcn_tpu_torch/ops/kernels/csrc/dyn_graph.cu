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
// P = edge_w^T x are computed here, by edge_proj_kernel ahead of the edge
// subset's ctr (both into scratch the wrapper allocates).  The design is
// K3's (graph_agg_tiled.cuh); the TPU mechanics (T tiles sized to VMEM,
// the layout rotations) are not carried over.
//
// Bound on the H100: bytes, as bd_agg.cu: pre read once and y written once,
// 2*V FLOP per output element against 8 (f32) or 4 (bf16) bytes.
#include "graph_agg_tiled.cuh"

namespace dsgcn {

template <typename Tio, int VB>
__global__ void __launch_bounds__(tiled::MAX_THREADS, 2)
dyn_graph_fwd_kernel(const tiled::Args a) {
  tiled::aggregate_block<Tio, VB, false>(a);
}

template <typename Tio>
static int launch(const tiled::Args &a, int N, cudaStream_t st) {
  auto kernel = tiled::joint_bound(a.V) == 25 ? dyn_graph_fwd_kernel<Tio, 25>
                                              : dyn_graph_fwd_kernel<Tio, 32>;
  return tiled::launch(kernel, a, N, sizeof(Tio), st);
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  CG (channels a
// block) and rows_per_block come from the wrapper's planner; p1s, p2s
// (N*E*V*Cm floats each) and ectr (N*V*V*Cm) are the edge subset's scratch,
// unused without one.  Returns a cudaError_t; the caller has checked
// shapes, types and devices.
extern "C" int dsgcn_dyn_graph_fwd(const void *pre, void *out, int bf16,
                                   const float *x1, const float *x2,
                                   const float *A, const float *alpha,
                                   const float *beta, const float *edge_w,
                                   const float *bias_field, const float *sel,
                                   float *p1s, float *p2s, float *ectr, int N,
                                   int T, int V, int K, int Cm, int E,
                                   int edge_k, int v_real, int CG,
                                   int rows_per_block, void *stream) {
  using namespace dsgcn;
  tiled::Args a{pre,    out,     x1,      x2,    A,    alpha, beta,
                edge_w, nullptr, nullptr, sel,   bias_field, ectr, T,
                V,      K,       Cm,      CG,    E,    edge_k, v_real,
                rows_per_block, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (tiled::refuse(a, N)) return (int)cudaErrorInvalidValue;
  if (edge_k >= 0) {
    // the bias field is (Cm, V, V)
    const int err = tiled::launch_edge(a, N, p1s, p2s, V * V, V, st);
    if (err != 0) return err;
  }
  return bf16 ? launch<__nv_bfloat16>(a, N, st) : launch<float>(a, N, st);
}

extern "C" const char *dsgcn_dyn_graph_fwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The block K1 and K3 launch for a plan of CG channels: its threads and
// shared-memory bytes, for pre/y elements of esize bytes.  The planner's
// model of the block (ops/kernels/dyn_graph.py agg_block) is held to it.
extern "C" void dsgcn_agg_block(int V, int Cm, int CG, int esize,
                                int *threads, int *smem) {
  *threads = dsgcn::tiled::block_threads(V, CG);
  *smem = (int)dsgcn::tiled::smem_bytes(V, Cm, CG, (size_t)esize);
}
