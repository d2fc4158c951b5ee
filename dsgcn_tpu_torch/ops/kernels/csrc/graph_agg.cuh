// Shared device code of the dynamic-graph aggregation kernels K5 and K6
// (dyn_graph_eval.cu, dggcn_block.cu): the graph build and the per-channel
// aggregation.  K1-K4 (dyn_graph.cu, dyn_graph_bwd.cu, bd_agg.cu) use the
// tiled design of graph_agg_tiled.cuh and take only the limits, the type
// conversions and row_stride from here.
//
//   ctr[c,v,w] = tanh(x1[c,v] - x2[c,w])               (diff graph)
//   ctr[c,v,w] = tanh(sum_e sel[e,v,w] (P1[e,c,v] - P2[e,c,w]) + bias[c,v,w])
//                                                       (edge-class subset)
//   ada[v,w]   = softmax_v(sum_c x1[c,v] x2[c,w])      (v >= v_real masked)
//   G[c,v,w]   = alpha * ctr + (beta * ada + A[v,w])
//   y[t,w,c]   = sum_v pre[t,v,c] G[c,v,w]
//
// for one subset k of one sample n.  Work split: a thread block owns one
// (n, k, channel group, T-chunk); thread (c, w) builds its column G[c, :, w]
// in registers and reuses it for every row t of the chunk, so the graph
// never touches device memory.  Graph math is float32; with bfloat16 pre/y
// the graph is rounded to bfloat16 before the contraction and the sum runs
// in float32, as the TPU kernels' MXU contraction does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace dsgcn {

constexpr int VMAX = 32;     // most joints a graph may have
constexpr int EMAX = 16;     // most edge classes
constexpr int T_TILE = 4;    // rows of pre staged in shared memory per pass
constexpr int T_CHUNK = 32;  // rows of pre per thread block
constexpr int CG_MAX = 16;   // channels per thread block
constexpr int MAX_THREADS = CG_MAX * VMAX;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Channels per block: the largest divisor of Cm that is at most CG_MAX.
inline int channel_group(int Cm) {
  for (int g = CG_MAX < Cm ? CG_MAX : Cm; g > 1; --g)
    if (Cm % g == 0) return g;
  return 1;
}

// Odd row stride of the (channel, joint) tables, so that threads of one
// warp reading one joint of consecutive channels hit distinct banks.
__host__ __device__ inline int row_stride(int V) { return V | 1; }

// Shared memory of one block, in floats: x1, x2 (Cm rows), ada (V x V),
// P1 and P2 of the channel group (edge subset only), the staged pre tile.
inline size_t smem_bytes(int V, int Cm, int CG, int E) {
  const int XS = row_stride(V);
  size_t floats = 2 * (size_t)Cm * XS + (size_t)V * V +
                  2 * (size_t)E * CG * XS + (size_t)T_TILE * V * CG;
  return floats * sizeof(float);
}

struct Smem {
  float *xs1, *xs2, *ada, *p1s, *p2s, *pres;
};

__device__ inline Smem carve_smem(float *base, int V, int Cm, int CG, int E) {
  const int XS = row_stride(V);
  Smem s;
  s.xs1 = base;
  s.xs2 = s.xs1 + Cm * XS;
  s.ada = s.xs2 + Cm * XS;
  s.p1s = s.ada + V * V;
  s.p2s = s.p1s + E * CG * XS;
  s.pres = s.p2s + E * CG * XS;
  return s;
}

// ada[v*V + w] = softmax over the source joint v of sum_c x1[c,v] x2[c,w];
// sources v >= v_real (when 0 < v_real < V) are masked out.
__device__ inline void build_ada(float *ada, const float *xs1,
                                 const float *xs2, int Cm, int V,
                                 int v_real) {
  const int XS = row_stride(V);
  for (int i = threadIdx.x; i < V * V; i += blockDim.x) {
    const int v = i / V, w = i % V;
    float s = 0.f;
    for (int c = 0; c < Cm; ++c) s += xs1[c * XS + v] * xs2[c * XS + w];
    ada[i] = (v_real > 0 && v >= v_real) ? -1e30f : s;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < V; w += blockDim.x) {
    float m = -INFINITY;
    for (int v = 0; v < V; ++v) m = fmaxf(m, ada[v * V + w]);
    float sum = 0.f;
    for (int v = 0; v < V; ++v) {
      const float e = expf(ada[v * V + w] - m);
      ada[v * V + w] = e;
      sum += e;
    }
    const float inv = 1.f / sum;
    for (int v = 0; v < V; ++v) ada[v * V + w] *= inv;
  }
  __syncthreads();
}

// P1[e, cl, v] = sum_c edge_w[c, e*Cm + c0 + cl] x1[c, v], and P2 the same
// of x2, for the CG channels of the block's group from c0: the per-class
// projections of the edge subset's queries into p1s/p2s ([e][cl][joint],
// stride row_stride(V)).  The caller syncs before reading them.
__device__ inline void edge_projections(const Smem &s, const float *edge_w,
                                        int V, int Cm, int CG, int c0,
                                        int E) {
  const int XS = row_stride(V);
  for (int i = threadIdx.x; i < E * CG * V; i += blockDim.x) {
    const int v = i % V, cl = (i / V) % CG, e = i / (V * CG);
    const float *wcol = edge_w + e * Cm + c0 + cl;
    float a1 = 0.f, a2 = 0.f;
    for (int c = 0; c < Cm; ++c) {
      const float wv = __ldg(wcol + (size_t)c * E * Cm);
      a1 += wv * s.xs1[c * XS + v];
      a2 += wv * s.xs2[c * XS + v];
    }
    s.p1s[(e * CG + cl) * XS + v] = a1;
    s.p2s[(e * CG + cl) * XS + v] = a2;
  }
}

// ctr[c, v, w] of one subset.  c is the channel within the subset, cl its
// index in the block's channel group.  With ``edge``, ctr comes from the
// per-class projections p1s/p2s, the one-hot class mask sel (E, V, V) and
// the bias field, read at bias[c * bias_c + v * bias_v + w].
__device__ __forceinline__ float ctr_entry(int c, int cl, int v, int w,
                                           const Smem &s, int V, int CG,
                                           bool edge, int E,
                                           const float *sel,
                                           const float *bias, int bias_c,
                                           int bias_v) {
  const int XS = row_stride(V);
  if (!edge) return tanhf(s.xs1[c * XS + v] - s.xs2[c * XS + w]);
  float ea = __ldg(bias + c * bias_c + v * bias_v + w);
  for (int e = 0; e < E; ++e) {
    const float m = __ldg(sel + (e * V + v) * V + w);
    if (m != 0.f)
      ea += m * (s.p1s[(e * CG + cl) * XS + v] - s.p2s[(e * CG + cl) * XS + w]);
  }
  return tanhf(ea);
}

// G[c, v, w] of subset k (A_k its static graph), rounded to the working
// type of pre, in which the forward contraction runs (a no-op for f32).
template <typename Tio>
__device__ __forceinline__ float graph_entry(int c, int cl, int v, int w,
                                             const Smem &s, int V, int CG,
                                             const float *A_k, float alpha,
                                             float beta, bool edge, int E,
                                             const float *sel,
                                             const float *bias, int bias_c,
                                             int bias_v) {
  const float gv = ctr_entry(c, cl, v, w, s, V, CG, edge, E, sel, bias,
                             bias_c, bias_v) * alpha +
                   (s.ada[v * V + w] * beta + __ldg(A_k + v * V + w));
  return to_f32(from_f32<Tio>(gv));
}

// The graph-build function of the forward kernels: g[v] = G[c, v, w] of
// subset k for v < V, 0 beyond.
template <typename Tio>
__device__ inline void graph_column(float (&g)[VMAX], int c, int cl, int w,
                                    const Smem &s, int V, int CG,
                                    const float *A_k, float alpha, float beta,
                                    bool edge, int E, const float *sel,
                                    const float *bias, int bias_c,
                                    int bias_v) {
#pragma unroll
  for (int v = 0; v < VMAX; ++v)
    g[v] = v < V ? graph_entry<Tio>(c, cl, v, w, s, V, CG, A_k, alpha, beta,
                                    edge, E, sel, bias, bias_c, bias_v)
                 : 0.f;
}

// y[n, t0 + r, w, ch0 + cl] = sum_v pres[r, v, cl] g[v] for the rows
// r < rows staged in pres ((rows, V, CG)), y of row width KC.
template <typename Tio>
__device__ __forceinline__ void contract_rows(const float (&g)[VMAX],
                                              const float *pres, Tio *out,
                                              int n, int T, int V, int KC,
                                              int ch0, int CG, int cl, int w,
                                              int t0, int rows) {
  for (int r = 0; r < rows; ++r) {
    const float *pr = pres + r * V * CG + cl;
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < VMAX; ++v)
      if (v < V) acc += pr[v * CG] * g[v];
    out[(((size_t)n * T + t0 + r) * V + w) * KC + ch0 + cl] =
        from_f32<Tio>(acc);
  }
}

}  // namespace dsgcn
