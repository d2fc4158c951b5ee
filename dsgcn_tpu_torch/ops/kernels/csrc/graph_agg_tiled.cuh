// The dynamic-graph aggregation of K3 (bd_agg.cu) and K1's forward
// (dyn_graph.cu), tiled for Hopper:
//
//   ctr[c,v,w] = tanh(x1[c,v] - x2[c,w])               (diff graph)
//   ctr[c,v,w] = tanh(sum_e sel[e,v,w] (P1[e,c,v] - P2[e,c,w]) + bias[c,v,w])
//                                                       (edge-class subset)
//   ada[v,w]   = softmax_v(sum_c x1[c,v] x2[c,w])      (v >= v_real masked)
//   G[c,v,w]   = alpha * ctr + (beta * ada + A[v,w])
//   y[t,w,c]   = sum_v pre[t,v,c] G[c,v,w]
//
// One thread block owns one (sample n, subset k, channel group of CG
// channels, range of rows): the wrapper's planner (agg_plan in
// ops/kernels/dyn_graph.py) picks CG and the rows per block, so that a
// block covers all T when the grid has blocks enough for the SMs, and each
// graph column is built once per call then.  In a block:
//
// 1. The first pre tiles are requested (cp.async, 16-byte copies) before
//    the graph is built, so the loads overlap the build.
// 2. ada is built with one warp per destination joint w (lane = source
//    joint v; max and sum by shuffles), and folded with beta and A into
//    base[v,w] = beta*ada + A.
// 3. Thread (cl, j) builds G[c0+cl, :, w] in registers for its WN
//    destination joints w = j*WN .. j*WN+WN-1: one staged value of pre
//    feeds WN FMAs.  Lanes run over channels, so the staged row reads are
//    conflict-free and a warp's stores of y are runs of CG channels.
// 4. Rows of pre go through a STAGES-deep ring of ROWS-row tiles in shared
//    memory: while a tile is contracted, the next ones are in flight.
//
// The edge subset's ctr needs the class mask, the projections and the
// bias field, which are large next to one block's work, and built inside
// the block they made its blocks the call's tail.  So two small kernels
// ahead of the aggregation build that ctr for the whole call, spread over
// the card, into scratch that the wrapper allocates: edge_proj_kernel (K1
// only; K3 receives the projections) and edge_ctr_kernel, which reads sel
// once per (v, w) a block touches, as a mask of its nonzero classes in
// shared memory.  The edge subset's blocks then read their ctr in place of
// tanh(x1 - x2), and every block has the same shared memory.
//
// K5 and K6 (dyn_graph_eval.cu, dggcn_block.cu) compute pre inside their
// blocks, over a tile of whole frames staged in shared memory, and take the
// same graph (build_base's base, the edge subset's call-wide ctr) through
// graph_prep_kernel, stage_tables and aggregate_staged below.
//
// The block geometry (threads, rows a ring stage, stages, joints a thread)
// comes from the build: ops/kernels/_build.py defines it, for these
// kernels as -D flags and for the wrapper's planner.
//
// Every output is summed over v in order, with no atomics: the same bits
// on every run.  The graph math is float32 (tanhf, expf); with bfloat16
// pre/y the graph is rounded to bfloat16 and the sum runs in float32.
#pragma once

#include <stdint.h>

#include "graph_agg.cuh"

namespace dsgcn {
namespace tiled {

#if !defined(DSGCN_AGG_MAX_THREADS) || !defined(DSGCN_AGG_ROWS) || \
    !defined(DSGCN_AGG_STAGES) || !defined(DSGCN_AGG_WN25) ||         \
    !defined(DSGCN_AGG_WN32)
#error "the block geometry is defined by ops/kernels/_build.py (-D flags)"
#endif
constexpr int MAX_THREADS = DSGCN_AGG_MAX_THREADS;  // CG * ceil(V / WN)
constexpr int ROWS = DSGCN_AGG_ROWS;       // rows of pre per pipeline stage
constexpr int STAGES = DSGCN_AGG_STAGES;   // pre tiles in the ring
constexpr int EDGE_THREADS = 256;  // threads a block of the edge kernels
constexpr int CTR_ITEMS = 4;       // (n, v, w, c) items a thread, ctr kernel

// Joints held per thread (WN) for a compile-time joint bound VB >= V: the
// column registers are VB * WN floats.
template <int VB> struct Cols;
template <> struct Cols<25> { static constexpr int WN = DSGCN_AGG_WN25; };
template <> struct Cols<32> { static constexpr int WN = DSGCN_AGG_WN32; };

__host__ __device__ inline int joint_bound(int V) { return V <= 25 ? 25 : 32; }
__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// Threads of a block of CG channels: CG * ceil(V / WN), rounded to warps.
inline int block_threads(int V, int CG) {
  const int WN = joint_bound(V) == 25 ? Cols<25>::WN : Cols<32>::WN;
  return (CG * ((V + WN - 1) / WN) + 31) / 32 * 32;
}

// Shared memory of one block, in bytes: the ring of pre tiles; x1, x2 (Cm
// rows of stride row_stride(V)); base (V x V).
inline size_t smem_bytes(int V, int Cm, int CG, size_t esize) {
  const int VB = joint_bound(V), XS = row_stride(V);
  return align16((size_t)STAGES * ROWS * VB * CG * esize) +
         4 * (2 * (size_t)Cm * XS + (size_t)V * V);
}

// The operands of one call.  x1 is (N, K, Cm, V), or with PROJ (K3) the
// transposed x1t (N, K, V, Cm); x2 (N, K, Cm, V).  Edge subset: the class
// mask sel (E, V, V), the projections p1t (N, E, V, Cm) and p2 (K3's
// inputs, p2 (N, E, Cm, V); K1's made from edge_w (Cm, E*Cm) by
// edge_proj_kernel, both (N, E, V, Cm)), the bias field (K1's (Cm, V, V),
// K3's (V, Cm, V)) and the ctr scratch ectr (N, V, V, Cm).
struct Args {
  const void *pre;
  void *out;
  const float *x1, *x2, *A, *alpha, *beta;
  const float *edge_w, *p1t, *p2, *sel, *bias;
  float *ectr;
  int T, V, K, Cm, CG, E, edge_k, v_real, rows_per_block, vec;
};

__device__ __forceinline__ void cp_async16(void *dst, const void *src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void *dst, const void *src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// base[v, w] = beta * ada[v, w] (+ base[v, w] with ADD), ada = softmax_v(
// sum_c xs1[c, v] xs2[c, w]) over the (Cm, row_stride(V)) query tables
// (sources v >= v_real masked when 0 < v_real < V): one warp per
// destination joint w, lane = source joint.  With ADD, base holds A[k] on
// entry.  The caller syncs after it.
template <bool ADD>
__device__ __forceinline__ void build_base(float *base, const float *xs1,
                                           const float *xs2, int Cm, int V,
                                           int v_real, float beta) {
  const int XS = row_stride(V);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int w = warp; w < V; w += nwarps) {
    float s = -INFINITY;
    if (lane < V) {
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      int c = 0;
      for (; c + 4 <= Cm; c += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          s4[u] += xs1[(c + u) * XS + lane] * xs2[(c + u) * XS + w];
      }
      for (; c < Cm; ++c) s4[0] += xs1[c * XS + lane] * xs2[c * XS + w];
      s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      if (v_real > 0 && lane >= v_real) s = -1e30f;
    }
    const float m = warp_max(s);
    const float e = lane < V ? expf(s - m) : 0.f;
    const float inv = 1.f / warp_sum(e);
    if (lane < V)
      base[lane * V + w] = ADD ? (e * inv) * beta + base[lane * V + w]
                               : (e * inv) * beta;
  }
}

// K1's projections of the edge subset k = edge_k, both in K3's p1t layout
// (N, E, V, Cm): P1[n,e,v,c] = sum_c' edge_w[c', e*Cm + c] x1[n,k,c',v]
// and P2 the same of x2.  One thread per (n, e, v) and CPT channels,
// channels fastest: a weight load (16 bytes with CPT = 4) feeds 2*CPT
// FMAs, the query reads are shared by the warp, the stores coalesce.
template <int CPT>
__global__ void __launch_bounds__(EDGE_THREADS)
edge_proj_kernel(const Args a, int N, float *p1, float *p2) {
  const int Cm = a.Cm, V = a.V, E = a.E, CQ = Cm / CPT;
  const size_t total = (size_t)N * E * V * CQ;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % CQ) * CPT, v = (i / CQ) % V;
    const int e = (i / ((size_t)CQ * V)) % E;
    const int n = i / ((size_t)CQ * V * E);
    const size_t q = ((size_t)n * a.K + a.edge_k) * Cm * V + v;
    const float *wrow = a.edge_w + e * Cm + c;
    float s1[CPT], s2[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) s1[u] = s2[u] = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < Cm; ++cc) {
      float wv[CPT];
      if constexpr (CPT == 4) {
        const float4 w4 = __ldg((const float4 *)(wrow + (size_t)cc * E * Cm));
        wv[0] = w4.x;
        wv[1] = w4.y;
        wv[2] = w4.z;
        wv[3] = w4.w;
      } else {
#pragma unroll
        for (int u = 0; u < CPT; ++u)
          wv[u] = __ldg(wrow + (size_t)cc * E * Cm + u);
      }
      const float x1v = __ldg(a.x1 + q + (size_t)cc * V);
      const float x2v = __ldg(a.x2 + q + (size_t)cc * V);
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        s1[u] += wv[u] * x1v;
        s2[u] += wv[u] * x2v;
      }
    }
    const size_t o = (((size_t)n * E + e) * V + v) * Cm + c;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      p1[o + u] = s1[u];
      p2[o + u] = s2[u];
    }
  }
}

// The edge subset's ctr of every (n, v, w, c), c fastest, into a.ectr:
// tanh(bias + sum_e sel[e,v,w] (P1[n,e,v,c] - P2[n,e,c,w])) over the
// nonzero classes in order.  P1 is (N, E, V, Cm); P2 is read at
// (n*E + e)*V*Cm + c*p2_c + w*p2_w (K3's (Cm, V) rows or K1's (V, Cm)),
// the bias field at c*bias_c + v*bias_v + w.  A block takes SPAN
// consecutive items.  It first stages, for each (n, v, w) its items
// touch, the mask of the classes e with sel[e,v,w] != 0 (E reads of sel a
// pair, once a block), so an item reads sel only at its own classes: one
// with the one-hot NTU mask, all that are nonzero with a general one.
__global__ void __launch_bounds__(EDGE_THREADS)
edge_ctr_kernel(const Args a, int N, int p2_c, int p2_w, int bias_c,
                int bias_v) {
  constexpr int SPAN = EDGE_THREADS * CTR_ITEMS;
  // pairs of a block: at most (SPAN - 1) / Cm + 2 <= SPAN + 1
  __shared__ unsigned short classes[SPAN + 1];
  const int Cm = a.Cm, V = a.V, E = a.E;
  const size_t total = (size_t)N * V * V * Cm;
  const size_t i0 = (size_t)blockIdx.x * SPAN;
  const size_t i1 = i0 + SPAN < total ? i0 + SPAN : total;
  const size_t p0 = i0 / Cm;
  const int npairs = (int)((i1 - 1) / Cm - p0 + 1);
  for (int j = threadIdx.x; j < npairs; j += blockDim.x) {
    const int vw = (int)((p0 + j) % ((size_t)V * V));
    unsigned m = 0;
    for (int e = 0; e < E; ++e)
      if (__ldg(a.sel + (size_t)e * V * V + vw) != 0.f) m |= 1u << e;
    classes[j] = (unsigned short)m;
  }
  __syncthreads();
  for (size_t i = i0 + threadIdx.x; i < i1; i += EDGE_THREADS) {
    const int c = i % Cm, w = (i / Cm) % V, v = (i / ((size_t)Cm * V)) % V;
    const int n = i / ((size_t)Cm * V * V);
    float ea = __ldg(a.bias + c * bias_c + v * bias_v + w);
    for (unsigned m = classes[i / Cm - p0]; m != 0; m &= m - 1) {
      const int e = __ffs(m) - 1;
      const float s = __ldg(a.sel + (e * V + v) * V + w);
      const size_t pe = ((size_t)n * E + e) * V * Cm;
      ea += s * (__ldg(a.p1t + pe + (size_t)v * Cm + c) -
                 __ldg(a.p2 + pe + c * p2_c + w * p2_w));
    }
    a.ectr[i] = tanhf(ea);
  }
}

// Copy rows [t0, t0 + nrows) of the group's channels of ``src`` (pre's
// layout: a.pre, or K2's dy) into a ring slot laid out (row, VB joints, CG
// channels).  16-byte cp.async where the channel runs are 16-byte aligned
// (a.vec), else element by element.
template <typename Tio, int VB>
__device__ __forceinline__ void stage_rows(const Args &a, const void *src,
                                           Tio *slot, int n, int ch0, int t0,
                                           int nrows) {
  const Tio *pre = (const Tio *)src;
  const int V = a.V, CG = a.CG, KC = a.K * a.Cm;
  if (a.vec) {
    constexpr int PER = 16 / sizeof(Tio);
    const int CH = CG / PER;
    for (int q = threadIdx.x; q < nrows * V * CH; q += blockDim.x) {
      const int ch = q % CH, rv = q / CH, v = rv % V, r = rv / V;
      cp_async16(slot + (r * VB + v) * CG + ch * PER,
                 pre + (((size_t)n * a.T + t0 + r) * V + v) * KC + ch0 +
                     ch * PER);
    }
  } else {
    for (int q = threadIdx.x; q < nrows * V * CG; q += blockDim.x) {
      const int cc = q % CG, rv = q / CG, v = rv % V, r = rv / V;
      slot[(r * VB + v) * CG + cc] =
          pre[(((size_t)n * a.T + t0 + r) * V + v) * KC + ch0 + cc];
    }
  }
}

// G[c, v, w0+jj] into g (the whole column of each of the thread's WN
// joints), 0 outside the V x V graph.  EDGE: ctr from the edge subset's
// scratch ec (ec[(v*V + w) * Cm] for channel c), else tanh(x1 - x2).
template <typename Tio, int VB, int WN, bool EDGE>
__device__ __forceinline__ void build_columns(
    float (&g)[VB][WN], const Args &a, const float *xs1, const float *xs2,
    const float *base, const float *ec, int c, int w0, bool active,
    float alpha) {
  const int V = a.V, XS = row_stride(V);
#pragma unroll
  for (int v = 0; v < VB; ++v) {
#pragma unroll
    for (int jj = 0; jj < WN; ++jj) {
      const int w = w0 + jj;
      float gv = 0.f;
      if (active && v < V && w < V) {
        const float ctr = EDGE ? __ldg(ec + (size_t)(v * V + w) * a.Cm)
                               : tanhf(xs1[c * XS + v] - xs2[c * XS + w]);
        gv = to_f32(from_f32<Tio>(ctr * alpha + base[v * V + w]));
      }
      g[v][jj] = gv;
    }
  }
}

// One block of K3 (PROJ: x1 arrives transposed) or K1's forward.
template <typename Tio, int VB, bool PROJ>
__device__ __forceinline__ void aggregate_block(const Args &a) {
  constexpr int WN = Cols<VB>::WN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int V = a.V, Cm = a.Cm, CG = a.CG, K = a.K, T = a.T;
  const int XS = row_stride(V), KC = K * Cm;
  const int ncg = Cm / CG;
  const int n = blockIdx.z, k = blockIdx.y / ncg, c0 = (blockIdx.y % ncg) * CG;
  const int ch0 = k * Cm + c0;
  const int t_begin = blockIdx.x * a.rows_per_block;
  const int t_end = min(T, t_begin + a.rows_per_block);
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // carve (smem_bytes)
  Tio *ring = (Tio *)smem_raw;
  const int slot_elems = ROWS * VB * CG;
  float *xs1 = (float *)(smem_raw +
                         align16((size_t)STAGES * slot_elems * sizeof(Tio)));
  float *xs2 = xs1 + Cm * XS;
  float *base = xs2 + Cm * XS;

  // 1. the small operands (queries of subset k as (channel, joint) tables,
  // A[k]), then the first tiles, in flight
  const float *q1 = a.x1 + ((size_t)n * K + k) * Cm * V;
  const float *q2 = a.x2 + ((size_t)n * K + k) * Cm * V;
  const float *Ak = a.A + (size_t)k * V * V;
  for (int i = tid; i < Cm * V; i += nthreads) {
    if (PROJ)
      cp_async4(xs1 + (i % Cm) * XS + i / Cm, q1 + i);     // x1t: (V, Cm)
    else
      cp_async4(xs1 + (i / V) * XS + i % V, q1 + i);
    cp_async4(xs2 + (i / V) * XS + i % V, q2 + i);
  }
  for (int i = tid; i < V * V; i += nthreads) cp_async4(base + i, Ak + i);
  cp_async_commit();
  const int ntiles = (t_end - t_begin + ROWS - 1) / ROWS;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles)
      stage_rows<Tio, VB>(a, a.pre, ring + i * slot_elems, n, ch0,
                          t_begin + i * ROWS,
                          min(ROWS, t_end - t_begin - i * ROWS));
    cp_async_commit();
  }
  // joints V..VB-1 of every slot stay zero (their graph rows are zero too)
  if (VB > V) {
    const int pad = VB - V;
    for (int i = tid; i < STAGES * ROWS * pad * CG; i += nthreads) {
      const int cc = i % CG, rv = i / CG, v = V + rv % pad, r = rv / pad;
      ring[(r * VB + v) * CG + cc] = from_f32<Tio>(0.f);
    }
  }
  cp_async_wait<STAGES - 1>();   // the small operands
  __syncthreads();

  // 2. base[v, w] = beta * softmax_v(x1^T x2)[v, w] + A[k, v, w]
  build_base<true>(base, xs1, xs2, Cm, V, a.v_real, a.beta[k]);
  __syncthreads();

  // 3. this thread's graph columns
  const int cl = tid % CG, j = tid / CG, w0 = j * WN;
  const bool active = w0 < V;
  const int c = c0 + cl;
  const float alpha = a.alpha[k];
  float g[VB][WN];
  if (k == a.edge_k)
    build_columns<Tio, VB, WN, true>(
        g, a, xs1, xs2, base, a.ectr + (size_t)n * V * V * Cm + c, c, w0,
        active, alpha);
  else
    build_columns<Tio, VB, WN, false>(g, a, xs1, xs2, base, nullptr, c, w0,
                                      active, alpha);

  // 4. the contraction over the ring of tiles
  Tio *out = (Tio *)a.out;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < ntiles)
      stage_rows<Tio, VB>(a, a.pre, ring + (nxt % STAGES) * slot_elems, n,
                          ch0, t_begin + nxt * ROWS,
                          min(ROWS, t_end - t_begin - nxt * ROWS));
    cp_async_commit();
    if (!active) continue;
    const Tio *slot = ring + (i % STAGES) * slot_elems + cl;
    const int t0 = t_begin + i * ROWS, nrows = min(ROWS, t_end - t0);
    for (int r = 0; r < nrows; ++r) {
      const Tio *pr = slot + r * VB * CG;
      float acc[WN];
#pragma unroll
      for (int jj = 0; jj < WN; ++jj) acc[jj] = 0.f;
#pragma unroll
      for (int v = 0; v < VB; ++v) {
        const float p = to_f32(pr[v * CG]);
#pragma unroll
        for (int jj = 0; jj < WN; ++jj) acc[jj] += p * g[v][jj];
      }
      Tio *o = out + (((size_t)n * T + t0 + r) * V + w0) * KC + ch0 + cl;
#pragma unroll
      for (int jj = 0; jj < WN; ++jj)
        if (w0 + jj < V) o[(size_t)jj * KC] = from_f32<Tio>(acc[jj]);
    }
  }
  cp_async_wait<0>();
}

// K5 and K6 (dyn_graph_eval.cu, dggcn_block.cu) aggregate a tile of whole
// frames whose pre they computed into shared memory, over a chunk of CH
// channels of the K*Cm axis from channel q0: a chunk lies inside one
// subset (CH divides Cm) or covers S = CH / Cm whole subsets.  What a
// subset's graph needs beyond its channels' queries does not depend on the
// frames, so graph_prep_kernel builds it once a call, for every (sample,
// subset), ahead of the blocks (each frame tile of a sample would build it
// again): base = beta * ada + A (V x V), and the queries as exponential
// tables where they allow it.  A block's tables then hold, from the
// chunk's first subset k0 on, each subset's two tables (Cm rows of stride
// row_stride(V) each in xs1 and xs2) and base (V x V).

// Turn the staged queries of S subsets from k0 into exponential tables in
// place, xs1[c, v] <- exp(2 (x1[c, v] - m_c)) and the same of xs2, m_c the
// channel's largest query, so that tanh(x1 - x2) = (e1 - e2) / (e1 + e2)
// takes one division a graph entry in place of tanhf (about 1e-6 from it;
// K2 builds its ctr the same way).  Where a channel's queries spread over
// 40 the exponentials would underflow: the tables stay queries (their
// blocks take tanhf), and this returns false.  The edge subset's channels
// (their ctr comes from the scratch) are not held to the spread.  A warp
// a channel, a lane a joint; every thread of the block calls it, and it
// ends in a barrier.
__device__ __forceinline__ bool exp_tables(const Args &a, int k0, int S,
                                           float *xs1, float *xs2) {
  const int V = a.V, Cm = a.Cm, XS = row_stride(V);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  bool wide = false;
  for (int r = warp; r < S * Cm; r += nwarps) {
    const bool in = lane < V;
    const float q1 = in ? xs1[r * XS + lane] : 0.f;
    const float q2 = in ? xs2[r * XS + lane] : 0.f;
    const float hi = warp_max(in ? fmaxf(q1, q2) : -INFINITY);
    const float lo = -warp_max(in ? -fminf(q1, q2) : -INFINITY);
    if (k0 + r / Cm != a.edge_k) wide |= !(hi - lo <= 40.f);
  }
  if (__syncthreads_or(wide)) return false;
  for (int r = warp; r < S * Cm; r += nwarps) {
    const bool in = lane < V;
    const float q1 = in ? xs1[r * XS + lane] : 0.f;
    const float q2 = in ? xs2[r * XS + lane] : 0.f;
    const float hi = warp_max(in ? fmaxf(q1, q2) : -INFINITY);
    if (in) {
      xs1[r * XS + lane] = expf(2.f * (q1 - hi));
      xs2[r * XS + lane] = expf(2.f * (q2 - hi));
    }
  }
  __syncthreads();
  return true;
}

constexpr int PREP_THREADS = 256;

// Shared memory of a graph_prep_kernel block: x1, x2 and base.
inline size_t prep_smem_bytes(int V, int Cm) {
  return 4 * (2 * (size_t)Cm * row_stride(V) + (size_t)V * V);
}

// One block a (sample n, subset k): t1/t2 (N, K, Cm, V) get the subset's
// exponential tables (flag[n*K + k] = 1) or its queries (0), tb
// (N, K, V, V) base = beta_k ada + A_k.
__global__ void __launch_bounds__(PREP_THREADS)
graph_prep_kernel(const Args a, float *t1, float *t2, float *tb,
                  int *flag) {
  extern __shared__ float prep_smem[];
  const int V = a.V, Cm = a.Cm, XS = row_stride(V);
  const int n = blockIdx.x / a.K, k = blockIdx.x % a.K;
  float *xs1 = prep_smem, *xs2 = xs1 + Cm * XS, *base = xs2 + Cm * XS;
  const size_t q = ((size_t)n * a.K + k) * Cm * V;
  for (int i = threadIdx.x; i < Cm * V; i += blockDim.x) {
    xs1[(i / V) * XS + i % V] = __ldg(a.x1 + q + i);
    xs2[(i / V) * XS + i % V] = __ldg(a.x2 + q + i);
  }
  for (int i = threadIdx.x; i < V * V; i += blockDim.x)
    base[i] = __ldg(a.A + (size_t)k * V * V + i);
  __syncthreads();
  build_base<true>(base, xs1, xs2, Cm, V, a.v_real, a.beta[k]);
  __syncthreads();
  const bool ex = exp_tables(a, k, 1, xs1, xs2);
  for (int i = threadIdx.x; i < Cm * V; i += blockDim.x) {
    t1[q + i] = xs1[(i / V) * XS + i % V];
    t2[q + i] = xs2[(i / V) * XS + i % V];
  }
  for (int i = threadIdx.x; i < V * V; i += blockDim.x)
    tb[((size_t)n * a.K + k) * V * V + i] = base[i];
  if (threadIdx.x == 0) flag[(size_t)n * a.K + k] = ex;
}

// Launch graph_prep_kernel over the N * K (sample, subset) pairs.
inline int launch_prep(const Args &a, int N, float *t1, float *t2, float *tb,
                       int *flag, cudaStream_t stream) {
  const size_t smem = prep_smem_bytes(a.V, a.Cm);
  cudaError_t err = cudaFuncSetAttribute(
      graph_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  graph_prep_kernel<<<N * a.K, PREP_THREADS, smem, stream>>>(a, t1, t2, tb,
                                                              flag);
  return (int)cudaGetLastError();
}

// Copy the tables of the S subsets from k0 of sample n (graph_prep_kernel's
// t1, t2 and tb) into a block's xs1, xs2 and base, as cp.async copies (the
// caller commits and waits).
__device__ __forceinline__ void stage_tables(int n, int K, int k0, int S,
                                             int Cm, int V, const float *t1,
                                             const float *t2, const float *tb,
                                             float *xs1, float *xs2,
                                             float *base) {
  const int XS = row_stride(V);
  const size_t q = ((size_t)n * K + k0) * Cm * V;
  for (int i = threadIdx.x; i < S * Cm * V; i += blockDim.x) {
    const int o = (i / V) * XS + i % V;
    cp_async4(xs1 + o, t1 + q + i);
    cp_async4(xs2 + o, t2 + q + i);
  }
  const size_t b = ((size_t)n * K + k0) * V * V;
  for (int i = threadIdx.x; i < S * V * V; i += blockDim.x)
    cp_async4(base + i, tb + b + i);
}

// Where a channel's ctr comes from in aggregate_staged.
enum CtrKind { CTR_TANH, CTR_EXP, CTR_EDGE };

// g[u][jj] = G[c, v0 + u, w0 + jj] (Tg-rounded), 0 outside the V x V graph:
// one pass's graph entries of a channel, from its tables t1/t2 (tanhf of
// the queries, or the exponential tables), or the edge subset's scratch
// ec, with base bs and the gate alpha.  Branch-free: indices are clamped
// into the graph and the entries outside it set to 0 after.
template <int KIND, typename Tg, int VC, int WN>
__device__ __forceinline__ void build_pass(float (&g)[VC][WN],
                                           const float *t1, const float *t2,
                                           const float *bs, const float *ec,
                                           float alpha, int v0, int w0,
                                           int V, int Cm) {
#pragma unroll
  for (int u = 0; u < VC; ++u) {
    const int v = min(v0 + u, V - 1);
#pragma unroll
    for (int jj = 0; jj < WN; ++jj) {
      const int w = min(w0 + jj, V - 1);
      float ctr;
      if (KIND == CTR_EDGE) {
        ctr = __ldg(ec + (size_t)(v * V + w) * Cm);
      } else if (KIND == CTR_EXP) {
        const float e1 = t1[v], e2 = t2[w];
        ctr = __fdividef(e1 - e2, e1 + e2);
      } else {
        ctr = tanhf(t1[v] - t2[w]);
      }
      const float gv = to_f32(from_f32<Tg>(ctr * alpha + bs[v * V + w]));
      g[u][jj] = v0 + u < V && w0 + jj < V ? gv : 0.f;
    }
  }
}

// y[t, w, c] = sum_v pre[t, v, c] G[c, v, w] for the frames t < frames of
// the tile: pre_s holds the chunk's channel c (of CH) in row c, its joint
// rows t*V + v at column t*V + v, rows rp floats apart (rp odd, so lanes
// on channels hit distinct banks; a pass may read up to 31 columns past
// the tile's rows, which must hold finite values).  Thread (c, j) takes
// channel c and the WN
// destination joints from jWN.  It walks the sources in passes of VC
// joints: it builds G[c, v, w] of the pass in registers (build_pass; Tg
// rounds it as the forward kernels do: K5 to pre's type, K6 not; ctr from
// the exponential tables where flag[n*K + k] says so, else tanhf, the edge
// subset's from the scratch), then for every frame sums the pass's VC
// terms, each staged value of pre feeding WN FMAs, and hands the sum to
// store(t, w, c, value, first pass?).  Each graph entry is built once a
// tile; more than one pass (VC < V) keeps the registers few where K6
// holds its out accumulator meanwhile, and its store adds the passes in
// order.  Lanes run over channels: the staged reads are conflict-free.
// Each sum runs over v in a fixed order (even and odd sources apart, then
// added), no atomics.
template <typename Tg, int VC, int WN, typename Store>
__device__ __forceinline__ void aggregate_staged(
    const Args &a, const int *flag, const float *pre_s, int rp, int frames,
    int n, int q0, int CH, const float *xs1, const float *xs2,
    const float *base, Store store) {
  static_assert(VC <= 32, "a pass reads at most 31 columns past the tile");
  const int V = a.V, Cm = a.Cm, XS = row_stride(V), k0 = q0 / Cm;
  const int groups = (V + WN - 1) / WN;
  for (int i = threadIdx.x; i < CH * groups; i += blockDim.x) {
    const int cc = i % CH, w0 = (i / CH) * WN;
    const int k = (q0 + cc) / Cm, c = (q0 + cc) % Cm, s = k - k0;
    const float *t1 = xs1 + (s * Cm + c) * XS, *t2 = xs2 + (s * Cm + c) * XS;
    const float *bs = base + s * V * V;
    const float alpha = __ldg(a.alpha + k);
    const int kind = k == a.edge_k ? CTR_EDGE
                     : __ldg(flag + (size_t)n * a.K + k) ? CTR_EXP
                                                          : CTR_TANH;
    const float *ec = a.ectr + (size_t)n * V * V * Cm + c;
    for (int v0 = 0; v0 < V; v0 += VC) {
      float g[VC][WN];
      if (kind == CTR_EXP)
        build_pass<CTR_EXP, Tg>(g, t1, t2, bs, ec, alpha, v0, w0, V, Cm);
      else if (kind == CTR_EDGE)
        build_pass<CTR_EDGE, Tg>(g, t1, t2, bs, ec, alpha, v0, w0, V, Cm);
      else
        build_pass<CTR_TANH, Tg>(g, t1, t2, bs, ec, alpha, v0, w0, V, Cm);
      // sources past V read the next rows (finite) against zero entries
      const float *pr = pre_s + (size_t)cc * rp + v0;
      for (int t = 0; t < frames; ++t, pr += V) {
        float even[WN], odd[WN];
#pragma unroll
        for (int jj = 0; jj < WN; ++jj) even[jj] = odd[jj] = 0.f;
#pragma unroll
        for (int u = 0; u < VC; ++u) {
          const float p = pr[u];
#pragma unroll
          for (int jj = 0; jj < WN; ++jj) {
            if (u % 2)
              odd[jj] += p * g[u][jj];
            else
              even[jj] += p * g[u][jj];
          }
        }
#pragma unroll
        for (int jj = 0; jj < WN; ++jj)
          if (w0 + jj < V)
            store(t, w0 + jj, cc, even[jj] + odd[jj], v0 == 0);
      }
    }
  }
}

// Sizes the kernels do not take (the wrappers refuse them first).
inline bool refuse(const Args &a, int N) {
  return a.V < 1 || a.V > VMAX || a.E > EMAX || a.Cm < 1 || a.CG < 1 ||
         a.Cm % a.CG || a.rows_per_block < 1 || N > 65535 ||
         a.K * (a.Cm / a.CG) > 65535;
}

// Blocks of a grid-stride edge kernel over ``total`` items.
inline int edge_blocks(size_t total) {
  const size_t b = (total + EDGE_THREADS - 1) / EDGE_THREADS;
  return (int)(b < 132 * 16 ? b : 132 * 16);
}

// Build the edge subset's ctr of a call that has one (a.edge_k >= 0) into
// a.ectr: with p1_out/p2_out (K1) the projections first, into those
// buffers, which the ctr kernel then reads.  Returns a cudaError_t.
inline int launch_edge(Args &a, int N, float *p1_out, float *p2_out,
                       int bias_c, int bias_v, cudaStream_t stream) {
  int p2_c = a.V, p2_w = 1;                  // K3's p2 rows: (Cm, V)
  if (p1_out != nullptr) {
    const size_t items = (size_t)N * a.E * a.V * a.Cm;
    if (a.Cm % 4 == 0 && (uintptr_t)a.edge_w % 16 == 0)
      edge_proj_kernel<4><<<edge_blocks(items / 4), EDGE_THREADS, 0,
                             stream>>>(a, N, p1_out, p2_out);
    else
      edge_proj_kernel<1><<<edge_blocks(items), EDGE_THREADS, 0, stream>>>(
          a, N, p1_out, p2_out);
    a.p1t = p1_out;
    a.p2 = p2_out;
    p2_c = 1;                                // K1's: (V, Cm)
    p2_w = a.Cm;
  }
  const size_t items = (size_t)N * a.V * a.V * a.Cm;
  constexpr int SPAN = EDGE_THREADS * CTR_ITEMS;
  edge_ctr_kernel<<<(unsigned)((items + SPAN - 1) / SPAN), EDGE_THREADS, 0,
                    stream>>>(a, N, p2_c, p2_w, bias_c, bias_v);
  return (int)cudaGetLastError();
}

// Launch ``kernel`` (the aggregate_block instantiation for the call's
// joint bound) over the grid (row blocks, K * Cm/CG, N).  Returns a
// cudaError_t; refuses a plan the block cannot take.
inline int launch(void (*kernel)(Args), Args a, int N, size_t esize,
                  cudaStream_t stream) {
  if (refuse(a, N)) return (int)cudaErrorInvalidValue;
  const int threads = block_threads(a.V, a.CG);
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  a.vec = (a.CG * esize) % 16 == 0 && (a.Cm * esize) % 16 == 0 &&
          (uintptr_t)a.pre % 16 == 0;
  const size_t smem = smem_bytes(a.V, a.Cm, a.CG, esize);
  cudaError_t err = cudaFuncSetAttribute(
      (const void *)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + a.rows_per_block - 1) / a.rows_per_block,
                  a.K * (a.Cm / a.CG), N);
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tiled
}  // namespace dsgcn
