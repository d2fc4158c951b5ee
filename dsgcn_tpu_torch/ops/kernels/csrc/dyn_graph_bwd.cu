// Fused dynamic-graph build + aggregation, backward: the Hopper kernel that
// replaces the TPU kernel dsgcn_tpu/ops/pallas/dyn_graph.py:_bwd_pallas
// (K2, _bwd_kernel with _edge_ctr).  Forward: y[t,w,c] = sum_v pre[t,v,c]
// G[c,v,w] with G = alpha ctr + (beta ada + A) (graph_agg_tiled.cuh).  Per
// sample n and subset k, from the upstream gradient dy:
//
//   dpre[t,v,c] = sum_w dy[t,w,c] G[c,v,w]
//   dG[c,v,w]   = sum_t pre[t,v,c] dy[t,w,c]
//   ctr path:   dz = dG alpha (1 - ctr^2); dx1 += sum_w dz, dx2 -= sum_v dz,
//               on the edge subset through the class projections:
//               dP1[e,c,v] = sum_w sel[e,v,w] dz, dP2[e,c,w] = -sum_v sel dz,
//               dx1 = edge_w dP1, dx2 = edge_w dP2,
//               dedge_w = sum_n x1 dP1^T + x2 dP2^T, dedge_b = sum_nv dP1
//   ada path:   ds = beta sum_c dG; draw = ada (ds - sum_v ds ada) (softmax
//               VJP over the source axis v); dx1 += x2 draw^T, dx2 += x1 draw
//   dA = sum_n sum_c dG, dalpha = <dG, ctr>, dbeta = <sum_c dG, ada>.
//
// Same contract as the Pallas backward: pre/dy/dpre (N, T, V, K*Cm) float32
// or bfloat16, lifted to float32 on load; the graph (not rounded) and every
// gradient but dpre in float32.
//
// Design.  Every gradient but dpre is linear in dG, so a block that owns
// part of T or part of a subset's channels can chain its partial dG and
// write partial results, which later kernels add in a fixed order.  One
// call is a sequence of launches on the caller's stream:
//
// 1. With an edge subset: its per-class projections and ctr, once per call,
//    by K1's edge_proj_kernel and edge_ctr_kernel (graph_agg_tiled.cuh)
//    into scratch, as the forward builds them.
// 2. bwd_ada_kernel: ada of every (sample, subset), once.  Then
//    bwd_contract_kernel, the T-contractions.  A block owns (sample n,
//    subset k, channel group of CG channels, row range), picked by the
//    wrapper's planner (dyn_graph.bwd_plan).  Thread (cl, j) holds, for the
//    WN source joints i = j*WN.., the graph rows G[c, i, :] and the dG rows
//    dG[c, i, :] in registers.  pre and dy stream through STAGES-deep
//    cp.async rings of ROWS-row tiles; dy is staged (channel, joint), so a
//    thread reads four joints of its channel in one 16-byte load, and each
//    value feeds 2*WN FMAs (dpre's and dG's).  ctr comes from per-channel
//    exponential tables (one division a pair, no exponential).  After its
//    rows the block chains its partial dG in shared memory: the sum over
//    its channels (for dA, dbeta and the softmax VJP), its share of dalpha,
//    and dz; from dz, the ctr part of dx1/dx2, or on the edge subset
//    dP1/dP2, formed with each (v, w)'s mask of nonzero classes (one class
//    a pair with the one-hot NTU mask).  Those partials go to scratch, one
//    slice per block.
// 3. With an edge subset, edge_dx_kernel, a call-wide tiled product: the
//    edge part of its dx1/dx2, edge_w dP, in parts of the depth E*Cm.
// 4. bwd_finish_kernel, one block per (n, k): adds the slices in order,
//    runs the softmax VJP, and writes dx1/dx2 (the ctr or edge part plus
//    the ada part), this sample's dA, dalpha and dbeta.
// 5. With an edge subset, edge_dw_kernel forms dedge_w and dedge_b (the
//    (Cm+1) x 2NV by 2NV x E*Cm product, bias as a row of ones) in sample
//    slices that a last pass adds in order.
// 6. sum_over_samples_kernel adds dA, dalpha, dbeta over the samples.
//
// No atomics: every sum runs in a fixed order, the same bits on every run.
// The block geometry (threads, ring rows and stages, blocks an SM holds,
// joints a thread) comes from the build: ops/kernels/_build.py defines it
// once, as -D flags here and as constants for the planner.
//
// Bound on the H100: bytes (pre and dy read once, dpre written once).  The
// T-contractions are 4 V FLOP per element of pre against 12 (f32) or 6
// (bf16) bytes; the graph chain is O(Cm V^2) per (n, k), the edge products
// O(N V E Cm^2), both independent of T.  What holds it back is latency: the
// two rows of registers a thread keeps cap a block's warps, so the loads of
// the row loop and the block's fixed work are poorly hidden; tensor cores
// (a 3xTF32 split for float32) for the two contractions are later work.
#include "graph_agg_tiled.cuh"

namespace dsgcn {
namespace bwd {

#if !defined(DSGCN_BWD_MAX_THREADS) || !defined(DSGCN_BWD_ROWS) ||  \
    !defined(DSGCN_BWD_STAGES) || !defined(DSGCN_BWD_MIN_BLOCKS) ||   \
    !defined(DSGCN_BWD_WN25) || !defined(DSGCN_BWD_WN32) ||           \
    !defined(DSGCN_BWD_DX_PARTS)
#error "the block geometry is defined by ops/kernels/_build.py (-D flags)"
#endif
constexpr int MAX_THREADS = DSGCN_BWD_MAX_THREADS;  // CG * ceil(V / WN)
constexpr int ROWS = DSGCN_BWD_ROWS;       // rows of pre and dy a ring stage
constexpr int STAGES = DSGCN_BWD_STAGES;   // tiles in each ring
constexpr int MIN_BLOCKS = DSGCN_BWD_MIN_BLOCKS;  // an SM holds at once
constexpr int FIN_THREADS = 256;           // threads of a finish block
constexpr int GEMM_BN = 64, GEMM_BK = 32;  // edge products: columns, depth
constexpr int GEMM_BNP = GEMM_BN + 4;      // padded row of the B tile
constexpr int GEMM_MAX_M = 128;            // rows of an edge-product block
constexpr int GEMM_STAGES = 4;             // edge products' operand ring
constexpr int GEMM_FSPLIT = DSGCN_BWD_DX_PARTS;  // dx's depth over blocks

template <int VB> struct Cols;
template <> struct Cols<25> { static constexpr int WN = DSGCN_BWD_WN25; };
template <> struct Cols<32> { static constexpr int WN = DSGCN_BWD_WN32; };

using tiled::align16;
using tiled::joint_bound;

// The operands of one call: the graph operands and geometry as the forward
// takes them (g.pre = pre, g.out = dpre, g.ectr the edge subset's ctr), dy,
// the ada graph of every (sample, subset), and the per-block slices (S =
// row ranges * channel groups a subset):
//   sc_part (N, K, S, V, V)  sum over the block's channels of dG
//   da_part (N, K, S)        the block's share of dalpha
//   dx_part (N, K, R, 2, Cm, V) the ctr part of dx1/dx2 (not the edge
//                            subset's), R = row ranges
//   dp_part (N, R, 2, E*Cm, V)  dP1/dP2 of the edge subset
struct Args {
  tiled::Args g;
  const void *dy;
  float *ada;     // (N, K, V, V), bwd_ada_kernel's
  float *sc_part, *da_part, *dx_part, *dp_part;
  int nrr;
  int dy_pairs;   // bfloat16 dy: pairs of channels 4-byte aligned
};

__host__ __device__ inline int wn_of(int V) {
  return joint_bound(V) == 25 ? DSGCN_BWD_WN25 : DSGCN_BWD_WN32;
}
__host__ __device__ inline int plane_stride(int V) { return (V * V) | 1; }

// Threads of a contraction block of CG channels: CG * ceil(V / WN), rounded
// to warps.
inline int block_threads(int V, int CG) {
  const int WN = wn_of(V);
  return (CG * ((V + WN - 1) / WN) + 31) / 32 * 32;
}

// dy's ring slots hold rows of (channel, joint), the joints padded to a
// multiple of 4 (the pitch), so that a thread reads four joints of its
// channel in one 16-byte load; in bfloat16 channels go in pairs, (pair,
// joint, 2), so that one 4-byte copy moves two channels of a joint.  pre's
// slots hold rows of (joint, channel) as K1's do.
__host__ __device__ constexpr int dy_pitch(int VB) { return (VB + 3) / 4 * 4; }
__host__ __device__ inline size_t dy_slot_bytes(int VB, int CG, size_t esize) {
  return align16((size_t)ROWS * (esize == 2 ? (CG + 1) / 2 * 2 : CG) *
                 dy_pitch(VB) * esize);
}
__host__ __device__ inline size_t pre_slot_bytes(int VB, int CG,
                                                 size_t esize) {
  return align16((size_t)ROWS * VB * CG * esize);
}
// dy[t0 + r, w, ch0 + cc] in a slot
template <typename Tio>
__device__ __forceinline__ int dy_at(int r, int cc, int w, int CG, int JP) {
  return sizeof(Tio) == 2 ? ((r * ((CG + 1) / 2) + cc / 2) * JP + w) * 2 +
                                (cc & 1)
                          : (r * CG + cc) * JP + w;
}

// Copy rows [t0, t0 + nrows) of dy's group channels into a slot.  A thread
// keeps one channel (or pair) and strides over the joints, so the loop
// does no division; 4-byte cp.async where the copies are aligned (a pair
// of bfloat16 channels needs b.dy_pairs: CG, Cm and dy's address even in
// its elements), else element by element.
template <typename Tio, int VB>
__device__ __forceinline__ void stage_dy(const Args &b, Tio *slot, int n,
                                         int ch0, int t0, int nrows) {
  constexpr int JP = dy_pitch(VB);
  const tiled::Args &a = b.g;
  const Tio *dy = (const Tio *)b.dy;
  const int V = a.V, CG = a.CG, KC = a.K * a.Cm;
  const bool pairs = sizeof(Tio) == 2 && b.dy_pairs;
  const int lanes = pairs ? CG / 2 : CG;       // copies a joint
  const int per = blockDim.x / lanes;          // joints a sweep
  const int tid = threadIdx.x;
  if (tid >= per * lanes) return;
  const int cc = pairs ? 2 * (tid % lanes) : tid % lanes;
  for (int r = 0; r < nrows; ++r) {
    const Tio *row = dy + ((size_t)a.T * n + t0 + r) * V * KC + ch0 + cc;
    for (int v = tid / lanes; v < V; v += per) {
      Tio *d = slot + dy_at<Tio>(r, cc, v, CG, JP);
      if (sizeof(Tio) == 4 || pairs)
        tiled::cp_async4(d, row + (size_t)v * KC);
      else
        *d = row[(size_t)v * KC];
    }
  }
}

// The first region of a block's shared memory: the two rings (pre, dy)
// during the rows, then the dG / dz planes (CG, V*V | 1) and, on the edge
// subset (E > 0), dP1/dP2 of the block's channels (2, E, CG, row_stride).
__host__ __device__ inline size_t region_bytes(int V, int CG, int E,
                                               size_t esize) {
  const int VB = joint_bound(V);
  const size_t ring = STAGES * (pre_slot_bytes(VB, CG, esize) +
                                dy_slot_bytes(VB, CG, esize));
  const size_t post = 4 * ((size_t)CG * plane_stride(V) +
                           2 * (size_t)E * CG * row_stride(V));
  return align16(ring > post ? ring : post);
}

// Shared memory of a contraction block, in bytes: the region; the queries
// x1, x2 of the block's channels and their exponential tables (4 x CG rows
// of row_stride(V)); base (V x V); 32 floats for block sums; with an edge
// subset each (v, w)'s value at its first class (V x V floats) and its
// mask of classes (V x V shorts).
inline size_t smem_bytes(int V, int CG, int E, size_t esize) {
  return region_bytes(V, CG, E, esize) +
         4 * (4 * (size_t)CG * row_stride(V) + (size_t)V * V + 32) +
         (E > 0 ? 6 * (size_t)V * V : 0);
}

// Shared memory of a finish (and an ada) block: x1, x2, ada, the channel
// sum and the softmax VJP, and 32 floats for block sums.
inline size_t finish_smem_bytes(int V, int Cm) {
  return 4 * (2 * (size_t)Cm * row_stride(V) + 2 * (size_t)V * V +
              (size_t)V * row_stride(V) + 32);
}

// Sum of v over the block, the same value in every thread (the block is a
// whole number of warps), in a fixed order.  Its barriers also publish
// every shared-memory write made before the call.
__device__ inline float block_sum(float v, float *red) {
  v = tiled::warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                 // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// Where a thread's ctr comes from: the edge subset's scratch (ec = ectr +
// n*V*V*Cm + c), the exponential tables of its channel, or (a block whose
// queries spread too far for the tables) tanhf of the queries.
enum CtrFrom { EDGE_SCRATCH, EXP_TABLES, TANH };
struct CtrSrc {
  const float *ec;        // EDGE_SCRATCH
  const float *t1, *t2;   // EXP_TABLES: e1[i], e2[w]; TANH: x1[c, :], x2[c, :]
};

// ctr[c, i, w] of the block's subset.  With the tables, e1[i] = exp(2 (x1[c,
// i] - m)) and e2[w] the same of x2 (m the channel's largest query), and
// tanh(x1 - x2) = (e1 - e2) / (e1 + e2): one division a pair in place of an
// exponential, about 1e-6 from tanhf (the exponents are rounded to float32
// after the shift by m).
template <CtrFrom FROM>
__device__ __forceinline__ float ctr_at(const CtrSrc &s, int i, int w, int V,
                                        int Cm) {
  if (FROM == EDGE_SCRATCH) return __ldg(s.ec + (size_t)(i * V + w) * Cm);
  if (FROM == TANH) return tanhf(s.t1[i] - s.t2[w]);
  const float a = s.t1[i], b = s.t2[w];
  return __fdividef(a - b, a + b);
}

// g[jj][w] = G[c, w0 + jj, w] (float32, not rounded), 0 outside the graph.
template <int VB, int WN, CtrFrom FROM>
__device__ __forceinline__ void build_rows(float (&g)[WN][VB],
                                           const CtrSrc &src,
                                           const float *base, int w0,
                                           bool active, float alpha, int V,
                                           int Cm) {
#pragma unroll
  for (int jj = 0; jj < WN; ++jj) {
#pragma unroll
    for (int w = 0; w < VB; ++w) {
      const int i = w0 + jj;
      float gv = 0.f;
      if (active && i < V && w < V)
        gv = ctr_at<FROM>(src, i, w, V, Cm) * alpha + base[i * V + w];
      g[jj][w] = gv;
    }
  }
}

// After the rows: g <- ctr, plane <- dG, the thread's share of dalpha.
template <int VB, int WN, CtrFrom FROM>
__device__ __forceinline__ float chain_dg(float (&g)[WN][VB],
                                          const float (&dg)[WN][VB],
                                          float *plane, const CtrSrc &src,
                                          int w0, int V, int Cm) {
  float da = 0.f;
#pragma unroll
  for (int jj = 0; jj < WN; ++jj) {
#pragma unroll
    for (int w = 0; w < VB; ++w) {
      const int i = w0 + jj;
      if (i < V && w < V) {
        const float ct = ctr_at<FROM>(src, i, w, V, Cm);
        da += dg[jj][w] * ct;
        plane[i * V + w] = dg[jj][w];
        g[jj][w] = ct;
      }
    }
  }
  return da;
}

// Four consecutive joints of a thread's channel from a dy slot row: float32
// rows are the channel's own; a bfloat16 row holds its pair interleaved,
// and odd picks the second channel.
__device__ __forceinline__ void load_joints4(float (&d)[4], const float *row,
                                             int w4, int) {
  const float4 v = *(const float4 *)(row + w4);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ __forceinline__ void load_joints4(float (&d)[4],
                                             const __nv_bfloat16 *row, int w4,
                                             int odd) {
  const uint4 v = *(const uint4 *)(row + 2 * w4);
  const unsigned shift = odd ? 0 : 16;         // a bfloat16 is a float's top
  d[0] = __uint_as_float((v.x << shift) & 0xffff0000u);
  d[1] = __uint_as_float((v.y << shift) & 0xffff0000u);
  d[2] = __uint_as_float((v.z << shift) & 0xffff0000u);
  d[3] = __uint_as_float((v.w << shift) & 0xffff0000u);
}

// One contraction block (step 2 of the head comment).
template <typename Tio, int VB>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
bwd_contract_kernel(const Args b) {
  constexpr int WN = Cols<VB>::WN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tiled::Args &a = b.g;
  const int V = a.V, Cm = a.Cm, CG = a.CG, K = a.K, T = a.T, E = a.E;
  const int XS = row_stride(V), KC = K * Cm, VV = V * V, DZS = plane_stride(V);
  const int ncg = Cm / CG;
  const int n = blockIdx.z, k = blockIdx.y / ncg, cg = blockIdx.y % ncg;
  const int c0 = cg * CG, ch0 = k * Cm + c0, rr = blockIdx.x;
  const int t_begin = rr * a.rows_per_block;
  const int t_end = min(T, t_begin + a.rows_per_block);
  const bool edge = k == a.edge_k;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const size_t esize = sizeof(Tio);

  constexpr int JP = dy_pitch(VB);

  // carve (smem_bytes)
  const size_t pslot = pre_slot_bytes(VB, CG, esize) / esize;
  const size_t dslot = dy_slot_bytes(VB, CG, esize) / esize;
  Tio *pring = (Tio *)smem_raw;
  Tio *dring = pring + STAGES * pslot;
  float *plane = (float *)smem_raw;             // after the rows
  float *dp1s = plane + CG * DZS, *dp2s = dp1s + E * CG * XS;
  float *xs1 = (float *)(smem_raw +
                         region_bytes(V, CG, a.edge_k >= 0 ? E : 0, esize));
  float *xs2 = xs1 + CG * XS;                   // the block's channels
  float *es1 = xs2 + CG * XS, *es2 = es1 + CG * XS;
  float *base = es2 + CG * XS;
  float *red = base + VV;
  float *sel1 = red + 32;
  unsigned short *cls = (unsigned short *)(sel1 + VV);

  // 1. the queries of the block's channels, ada, then the first tiles in
  // flight
  const size_t q = (((size_t)n * K + k) * Cm + c0) * V;
  for (int i = tid; i < CG * V; i += nthreads) {
    tiled::cp_async4(xs1 + (i / V) * XS + i % V, a.x1 + q + i);
    tiled::cp_async4(xs2 + (i / V) * XS + i % V, a.x2 + q + i);
  }
  const float *ada = b.ada + ((size_t)n * K + k) * VV;
  for (int i = tid; i < VV; i += nthreads) tiled::cp_async4(base + i, ada + i);
  tiled::cp_async_commit();
  const int ntiles = (t_end - t_begin + ROWS - 1) / ROWS;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) {
      const int t0 = t_begin + i * ROWS, nr = min(ROWS, t_end - t0);
      tiled::stage_rows<Tio, VB>(a, a.pre, pring + i * pslot, n, ch0, t0, nr);
      stage_dy<Tio, VB>(b, dring + i * dslot, n, ch0, t0, nr);
    }
    tiled::cp_async_commit();
  }
  // what the copies never write stays zero: joints V..VB-1 of every slot
  // (their graph entries are zero) and a bfloat16 slot's unpaired channel
  if (VB > V) {
    const int pad = VB - V;
    for (int i = tid; i < STAGES * ROWS * pad * CG; i += nthreads) {
      const int cc = i % CG, rv = i / CG, v = V + rv % pad, r = rv / pad;
      pring[(r / ROWS) * pslot + ((r % ROWS) * VB + v) * CG + cc] =
          from_f32<Tio>(0.f);
      dring[(r / ROWS) * dslot + dy_at<Tio>(r % ROWS, cc, v, CG, JP)] =
          from_f32<Tio>(0.f);
    }
  }
  if (sizeof(Tio) == 2 && CG % 2)
    for (int i = tid; i < STAGES * ROWS * JP; i += nthreads)
      dring[(i / JP / ROWS) * dslot + dy_at<Tio>(i / JP % ROWS, CG, i % JP,
                                                 CG, JP)] = from_f32<Tio>(0.f);
  // the edge subset: each (v, w)'s mask of nonzero classes and the value
  // at the first of them
  if (edge) {
    for (int i = tid; i < VV; i += nthreads) {
      unsigned m = 0;
      float first = 0.f;
#pragma unroll
      for (int e = 0; e < EMAX; ++e) {
        const float sv = e < E ? __ldg(a.sel + (size_t)e * VV + i) : 0.f;
        if (sv != 0.f) {
          if (m == 0) first = sv;
          m |= 1u << e;
        }
      }
      cls[i] = (unsigned short)m;
      sel1[i] = first;
    }
  }
  tiled::cp_async_wait<STAGES - 1>();   // the small operands
  __syncthreads();
  // the largest query of each of the block's channels, then its tables
  // (a channel whose queries spread over 40 would underflow them: its block
  // takes tanhf)
  bool wide = false;
  if (!edge && tid < CG) {
    float hi = -INFINITY, lo = INFINITY;
    for (int v = 0; v < V; ++v) {
      const float q1 = xs1[tid * XS + v], q2 = xs2[tid * XS + v];
      hi = fmaxf(hi, fmaxf(q1, q2));
      lo = fminf(lo, fminf(q1, q2));
    }
    red[tid] = hi;
    wide = !(hi - lo <= 40.f);
  }
  // base = beta * ada + A[k]
  const float beta = a.beta[k];
  for (int i = tid; i < VV; i += nthreads)
    base[i] = beta * base[i] + __ldg(a.A + (size_t)k * VV + i);
  const CtrFrom from = edge ? EDGE_SCRATCH
                            : __syncthreads_or(wide) ? TANH : EXP_TABLES;
  if (from == EXP_TABLES) {
    for (int i = tid; i < CG * V; i += nthreads) {
      const int cc = i / V, v = i - cc * V;
      es1[cc * XS + v] = expf(2.f * (xs1[cc * XS + v] - red[cc]));
      es2[cc * XS + v] = expf(2.f * (xs2[cc * XS + v] - red[cc]));
    }
  }
  __syncthreads();

  // 2. this thread's graph rows
  const int cl = tid % CG, j = tid / CG, w0 = j * WN, c = c0 + cl;
  const bool active = w0 < V;
  const float alpha = a.alpha[k];
  auto source = [&]() {
    return from == EDGE_SCRATCH
               ? CtrSrc{a.ectr + (size_t)n * VV * Cm + c, nullptr, nullptr}
           : from == TANH ? CtrSrc{nullptr, xs1 + cl * XS, xs2 + cl * XS}
                          : CtrSrc{nullptr, es1 + cl * XS, es2 + cl * XS};
  };
  float g[WN][VB], dg[WN][VB];
  {
    const CtrSrc src = source();
    if (from == EDGE_SCRATCH)
      build_rows<VB, WN, EDGE_SCRATCH>(g, src, base, w0, active, alpha, V,
                                       Cm);
    else if (from == TANH)
      build_rows<VB, WN, TANH>(g, src, base, w0, active, alpha, V, Cm);
    else
      build_rows<VB, WN, EXP_TABLES>(g, src, base, w0, active, alpha, V, Cm);
  }
#pragma unroll
  for (int jj = 0; jj < WN; ++jj)
#pragma unroll
    for (int w = 0; w < VB; ++w) dg[jj][w] = 0.f;

  // 3. the rows: dpre out, dG into registers
  Tio *dpre = (Tio *)a.out;
  for (int it = 0; it < ntiles; ++it) {
    tiled::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < ntiles) {
      const int t0 = t_begin + nxt * ROWS, nr = min(ROWS, t_end - t0);
      tiled::stage_rows<Tio, VB>(a, a.pre, pring + (nxt % STAGES) * pslot, n,
                                 ch0, t0, nr);
      stage_dy<Tio, VB>(b, dring + (nxt % STAGES) * dslot, n, ch0, t0, nr);
    }
    tiled::cp_async_commit();
    if (!active) continue;
    const Tio *ps = pring + (it % STAGES) * pslot + cl;
    const Tio *ds = dring + (it % STAGES) * dslot;
    const int t0 = t_begin + it * ROWS, nrows = min(ROWS, t_end - t0);
    for (int r = 0; r < nrows; ++r) {
      const Tio *pr = ps + r * VB * CG;             // pre[t, v, c]
      const Tio *dr = ds + dy_at<Tio>(r, cl, 0, CG, JP) - (cl & 1) *
                                                              (esize == 2);
      float p[WN], acc[WN];
#pragma unroll
      for (int jj = 0; jj < WN; ++jj) {
        p[jj] = w0 + jj < V ? to_f32(pr[(w0 + jj) * CG]) : 0.f;
        acc[jj] = 0.f;
      }
#pragma unroll
      for (int w4 = 0; w4 < JP; w4 += 4) {
        float d[4];
        load_joints4(d, dr, w4, cl & 1);           // dy[t, w4..w4+3, c]
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (w4 + u >= VB) break;
#pragma unroll
          for (int jj = 0; jj < WN; ++jj) {
            acc[jj] += d[u] * g[jj][w4 + u];
            dg[jj][w4 + u] += p[jj] * d[u];
          }
        }
      }
      Tio *o = dpre + (((size_t)n * T + t0 + r) * V + w0) * KC + ch0 + cl;
#pragma unroll
      for (int jj = 0; jj < WN; ++jj)
        if (w0 + jj < V) o[(size_t)jj * KC] = from_f32<Tio>(acc[jj]);
    }
  }
  tiled::cp_async_wait<0>();
  __syncthreads();                      // the rings are free

  // 4. the chain of this block's partial dG
  float *pl = plane + cl * DZS;
  float da = 0.f;
  if (active) {
    const CtrSrc src = source();
    da = from == EDGE_SCRATCH
             ? chain_dg<VB, WN, EDGE_SCRATCH>(g, dg, pl, src, w0, V, Cm)
         : from == TANH ? chain_dg<VB, WN, TANH>(g, dg, pl, src, w0, V, Cm)
                        : chain_dg<VB, WN, EXP_TABLES>(g, dg, pl, src, w0, V,
                                                       Cm);
  }
  if (edge)
    for (int i = tid; i < 2 * E * CG * XS; i += nthreads) dp1s[i] = 0.f;
  da = block_sum(da, red);              // publishes the dG planes
  const int S = b.nrr * ncg, s = rr * ncg + cg;
  float *sc = b.sc_part + (((size_t)n * K + k) * S + s) * VV;
  for (int i = tid; i < VV; i += nthreads) {
    float sum = 0.f;
    for (int cc = 0; cc < CG; ++cc) sum += plane[cc * DZS + i];
    sc[i] = sum;
  }
  if (tid == 0) b.da_part[((size_t)n * K + k) * S + s] = da;
  __syncthreads();                      // the dG planes are read
  if (active) {
#pragma unroll
    for (int jj = 0; jj < WN; ++jj)
#pragma unroll
      for (int w = 0; w < VB; ++w)
        if (w0 + jj < V && w < V)
          pl[(w0 + jj) * V + w] =
              dg[jj][w] * alpha * (1.f - g[jj][w] * g[jj][w]);
  }
  __syncthreads();                      // dz published

  if (!edge) {
    // the ctr part of dx1[c, x] (sum over w) and dx2[c, x] (- sum over v)
    float *dxp = b.dx_part + (((size_t)n * K + k) * b.nrr + rr) * 2 * Cm * V;
    for (int i = tid; i < CG * V; i += nthreads) {
      const int cc = i % CG, x = i / CG;
      const float *pz = plane + cc * DZS;
      float d1 = 0.f, d2 = 0.f;
      for (int u = 0; u < V; ++u) {
        d1 += pz[x * V + u];
        d2 -= pz[u * V + x];
      }
      dxp[(c0 + cc) * V + x] = d1;
      dxp[Cm * V + (c0 + cc) * V + x] = d2;
    }
    return;
  }
  // the edge subset: dP1[e, c, x] = sum_u sel[e, x, u] dz[c, x, u] and
  // dP2[e, c, x] = -sum_u sel[e, u, x] dz[c, u, x], at each pair's classes;
  // the thread owns (c, x) of both
  for (int i = tid; i < CG * V; i += nthreads) {
    const int cc = i % CG, x = i / CG;
    const float *pz = plane + cc * DZS;
    float *d1 = dp1s + cc * XS + x, *d2 = dp2s + cc * XS + x;
    const int CX = CG * XS;
    for (int u = 0; u < V; ++u) {
      const int r = x * V + u, q = u * V + x;   // (x, u) and (u, x)
      unsigned m = cls[r];
      if (m != 0) {
        d1[(__ffs(m) - 1) * CX] += sel1[r] * pz[r];
        for (m &= m - 1; m != 0; m &= m - 1) {
          const int e = __ffs(m) - 1;
          d1[e * CX] += __ldg(a.sel + (size_t)e * VV + r) * pz[r];
        }
      }
      m = cls[q];
      if (m != 0) {
        d2[(__ffs(m) - 1) * CX] -= sel1[q] * pz[q];
        for (m &= m - 1; m != 0; m &= m - 1) {
          const int e = __ffs(m) - 1;
          d2[e * CX] -= __ldg(a.sel + (size_t)e * VV + q) * pz[q];
        }
      }
    }
  }
  __syncthreads();
  const size_t FV = (size_t)E * Cm * V;
  float *dpp = b.dp_part + ((size_t)n * b.nrr + rr) * 2 * FV;
  for (int i = tid; i < E * CG * V; i += nthreads) {
    const int x = i % V, cc = (i / V) % CG, e = i / (V * CG);
    const size_t o = ((size_t)e * Cm + c0 + cc) * V + x;
    dpp[o] = dp1s[(e * CG + cc) * XS + x];
    dpp[FV + o] = dp2s[(e * CG + cc) * XS + x];
  }
}

// Before the contraction, one block per (subset k, sample n): ada =
// softmax_v(x1^T x2) into b.ada, for the contraction and finish blocks.
__global__ void __launch_bounds__(FIN_THREADS) bwd_ada_kernel(const Args b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tiled::Args &a = b.g;
  const int V = a.V, Cm = a.Cm, XS = row_stride(V), VV = V * V;
  const int k = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  float *xs1 = (float *)smem_raw, *xs2 = xs1 + Cm * XS, *ada = xs2 + Cm * XS;
  const size_t q = ((size_t)n * a.K + k) * Cm * V;
  for (int i = tid; i < Cm * V; i += blockDim.x) {
    xs1[(i / V) * XS + i % V] = a.x1[q + i];
    xs2[(i / V) * XS + i % V] = a.x2[q + i];
  }
  __syncthreads();
  tiled::build_base<false>(ada, xs1, xs2, Cm, V, -1, 1.f);
  __syncthreads();
  float *out = b.ada + ((size_t)n * a.K + k) * VV;
  for (int i = tid; i < VV; i += blockDim.x) out[i] = ada[i];
}

// Step 4: one block per (subset k, sample n).  parts holds a row of W0 =
// K*V*V + 2*K floats a sample: [dA (K, V, V) | dalpha (K) | dbeta (K)]; dxe
// the edge subset's parts of dx (edge_dx_kernel's), fs of them.
__global__ void __launch_bounds__(FIN_THREADS)
bwd_finish_kernel(const Args b, float *dx1, float *dx2, float *parts,
                  const float *dxe, int fs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tiled::Args &a = b.g;
  const int V = a.V, Cm = a.Cm, K = a.K, XS = row_stride(V), VV = V * V;
  const int k = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int nthreads = blockDim.x, S = b.nrr * (Cm / a.CG);
  float *xs1 = (float *)smem_raw, *xs2 = xs1 + Cm * XS;
  float *ada = xs2 + Cm * XS, *sc = ada + VV, *draw = sc + VV;
  float *red = draw + V * XS;
  const size_t q = ((size_t)n * K + k) * Cm * V;
  for (int i = tid; i < Cm * V; i += nthreads) {
    xs1[(i / V) * XS + i % V] = a.x1[q + i];
    xs2[(i / V) * XS + i % V] = a.x2[q + i];
  }
  const float *scp = b.sc_part + ((size_t)n * K + k) * S * VV;
  const float *adap = b.ada + ((size_t)n * K + k) * VV;
  for (int i = tid; i < VV; i += nthreads) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += scp[(size_t)s * VV + i];
    sc[i] = sum;
    ada[i] = adap[i];
  }
  __syncthreads();

  // dbeta and the softmax VJP: one warp per destination joint w
  const float beta = a.beta[k];
  const int lane = tid & 31, warp = tid >> 5;
  float dbl = 0.f;
  for (int w = warp; w < V; w += nthreads >> 5) {
    const float p = lane < V ? sc[lane * V + w] * ada[lane * V + w] : 0.f;
    const float inner = beta * tiled::warp_sum(p);
    if (lane < V)
      draw[lane * XS + w] =
          ada[lane * V + w] * (beta * sc[lane * V + w] - inner);
    dbl += p;
  }
  const float dbeta = block_sum(dbl, red);      // publishes draw
  float *part = parts + (size_t)n * (K * VV + 2 * K);
  if (tid == 0) {
    float da = 0.f;
    const float *dap = b.da_part + ((size_t)n * K + k) * S;
    for (int s = 0; s < S; ++s) da += dap[s];
    part[K * VV + k] = da;
    part[K * VV + K + k] = dbeta;
  }
  for (int i = tid; i < VV; i += nthreads) part[k * VV + i] = sc[i];

  // dx1/dx2: the ctr part (the row ranges' parts, or on the edge subset
  // edge_dx_kernel's parts of edge_w dP) plus the ada part
  const bool edge = k == a.edge_k;
  const float *dxp = edge ? dxe + (size_t)n * fs * 2 * Cm * V
                          : b.dx_part + ((size_t)n * K + k) * b.nrr * 2 * Cm * V;
  const int nparts = edge ? fs : b.nrr;
  for (int i = tid; i < Cm * V; i += nthreads) {
    const int c = i / V, x = i % V;
    float d1 = 0.f, d2 = 0.f;
    for (int r = 0; r < nparts; ++r) {
      d1 += dxp[(size_t)r * 2 * Cm * V + i];
      d2 += dxp[(size_t)r * 2 * Cm * V + Cm * V + i];
    }
    float a1 = 0.f, a2 = 0.f;
    for (int u = 0; u < V; ++u) {
      a1 += xs2[c * XS + u] * draw[x * XS + u];
      a2 += xs1[c * XS + u] * draw[u * XS + x];
    }
    dx1[q + i] = d1 + a1;
    dx2[q + i] = d2 + a2;
  }
}

// The edge products, on CUDA cores.  Thread (tm, tn) of a block holds a
// 4 x 4 tile of the block's output; operands go through a GEMM_STAGES-deep
// shared-memory ring filled by 4-byte cp.async, so the next chunks are in
// flight while the current one is summed.
struct Edge {
  const float *ew;            // edge_w (Cm, F)
  const float *x1, *x2;       // (N, K, Cm, V)
  const float *dp;            // dp_part (N, R, 2, F, V); range 0 holds dP
  float *dxe;                 // dxe_part (N, FS, 2, Cm, V)
  float *dw_part;             // (NS, Cm + 1, F)
  int N, V, K, Cm, F, edge_k, nrr, ns, fs;
};

// dP = the sum of the row ranges' slices, in order, into range 0 (only
// when the plan splits T).
__global__ void edge_dp_sum_kernel(float *dp, int N, int nrr, int FV2) {
  const size_t total = (size_t)N * FV2;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float *d = dp + (i / FV2) * nrr * FV2 + i % FV2;
    float s = d[0];
    for (int r = 1; r < nrr; ++r) s += d[(size_t)r * FV2];
    d[0] = s;
  }
}

__device__ __forceinline__ void mma_step(float (&acc)[4][4], const float *a,
                                         const float *b) {
  const float4 a4 = *(const float4 *)a, b4 = *(const float4 *)b;
  const float av[4] = {a4.x, a4.y, a4.z, a4.w};
  const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] += av[i] * bv[jj];
}

// acc += the thread's tile of As^T Bs over ``depth`` rows (As rows of Mp,
// Bs rows of Np floats), eight rows unrolled so that loads run ahead.
__device__ __forceinline__ void mma_rows(float (&acc)[4][4], const float *As,
                                         const float *Bs, int depth, int Mp,
                                         int Np, int tm, int tn) {
  As += tm * 4;
  Bs += tn * 4;
  int kk = 0;
  for (; kk + 8 <= depth; kk += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      mma_step(acc, As + (kk + u) * Mp, Bs + (kk + u) * Np);
  }
  for (; kk < depth; ++kk) mma_step(acc, As + kk * Mp, Bs + kk * Np);
}

// Rows and columns of the edge products' blocks, padded to the 4 x 4 tiles;
// their threads, rounded to warps (the staging takes a warp a row).
__host__ __device__ inline int pad4(int x) { return (x + 3) / 4 * 4; }
inline int warps_of(int threads) { return (threads + 31) / 32 * 32; }

// Part s of the edge part of dx: dxe[n, s, which, c, v] = sum_f edge_w[c, f]
// dP{which}[n, f, v] over part s of f (GEMM_BK at a time, in order); a
// block a (sample, part), the (Cm x F/FS) by (F/FS x 2V) product, columns
// (which, v).  bwd_finish_kernel adds the parts in order.
__global__ void edge_dx_kernel(const Edge p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Cm = p.Cm, V = p.V, F = p.F, Mp = pad4(Cm), Np = pad4(2 * V);
  const int n = blockIdx.x, part = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tn = tid % (Np / 4), tm = tid / (Np / 4);
  float *As = (float *)smem_raw, *Bs = As + GEMM_STAGES * GEMM_BK * Mp;
  const float *dpn = p.dp + (size_t)n * p.nrr * 2 * F * V;
  const int nall = (F + GEMM_BK - 1) / GEMM_BK, per = (nall + p.fs - 1) / p.fs;
  const int ch0 = part * per, nchunks = min(nall, ch0 + per) - ch0;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  // a warp a depth row, lanes along its shared-memory row (no bank
  // conflicts; the strided reads of edge_w stay in L1)
  auto stage = [&](int buf, int f0) {
    float *a = As + buf * GEMM_BK * Mp, *b = Bs + buf * GEMM_BK * Np;
    for (int kk = warp; kk < GEMM_BK; kk += nwarps) {
      const int f = f0 + kk;
      for (int m = lane; m < Mp; m += 32) {
        if (m < Cm && f < F)
          tiled::cp_async4(a + kk * Mp + m, p.ew + (size_t)m * F + f);
        else
          a[kk * Mp + m] = 0.f;
      }
      for (int col = lane; col < Np; col += 32) {
        const int which = col >= V, v = col - which * V;
        if (col < 2 * V && f < F)
          tiled::cp_async4(b + kk * Np + col,
                           dpn + ((size_t)which * F + f) * V + v);
        else
          b[kk * Np + col] = 0.f;
      }
    }
  };
  float acc[4][4] = {};
#pragma unroll
  for (int i = 0; i < GEMM_STAGES - 1; ++i) {
    if (i < nchunks) stage(i, (ch0 + i) * GEMM_BK);
    tiled::cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    tiled::cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    const int nxt = ch + GEMM_STAGES - 1;
    if (nxt < nchunks) stage(nxt % GEMM_STAGES, (ch0 + nxt) * GEMM_BK);
    tiled::cp_async_commit();
    const int buf = ch % GEMM_STAGES;
    if (tm * 4 < Mp)
      mma_rows(acc, As + buf * GEMM_BK * Mp, Bs + buf * GEMM_BK * Np,
               GEMM_BK, Mp, Np, tm, tn);
  }
  tiled::cp_async_wait<0>();
  if (tm * 4 >= Mp) return;
  float *out = p.dxe + ((size_t)n * p.fs + part) * 2 * Cm * V;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tm * 4 + i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = tn * 4 + jj;
      if (c >= Cm || col >= 2 * V) continue;
      const int which = col >= V, v = col - which * V;
      out[((size_t)which * Cm + c) * V + v] = acc[i][jj];
    }
  }
}

// Slice s of dedge_w and dedge_b, GEMM_BN columns f: rows c < Cm of
// x{which}[n, edge_k, c, v], row Cm the bias's ones (which = 0) and zeros,
// by dP{which}[n, f, v], over depth (which, v) a sample, the slice's
// samples in order.
__global__ void edge_dw_kernel(const Edge p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Cm = p.Cm, V = p.V, F = p.F, M = Cm + 1, Mp = pad4(M);
  const int D = 2 * V, s = blockIdx.y, f0 = blockIdx.x * GEMM_BN;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tn = tid % 16, tm = tid / 16;
  float *As = (float *)smem_raw, *Bs = As + GEMM_STAGES * D * Mp;
  const int n_begin = (int)((long long)s * p.N / p.ns);
  const int n_end = (int)((long long)(s + 1) * p.N / p.ns);
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  // a warp a depth row, lanes along its shared-memory row (no bank
  // conflicts; the strided reads of the sample's tiles stay in L1)
  auto stage = [&](int buf, int n) {
    float *a = As + buf * D * Mp, *b = Bs + buf * D * GEMM_BNP;
    const size_t q = ((size_t)n * p.K + p.edge_k) * Cm * V;
    const float *dpn = p.dp + (size_t)n * p.nrr * 2 * F * V;
    for (int kk = warp; kk < D; kk += nwarps) {
      const int which = kk >= V, v = kk - which * V;
      const float *xq = (which ? p.x2 : p.x1) + q + v;
      for (int m = lane; m < Mp; m += 32) {
        if (m < Cm)
          tiled::cp_async4(a + kk * Mp + m, xq + (size_t)m * V);
        else
          a[kk * Mp + m] = m == Cm && !which ? 1.f : 0.f;
      }
      for (int fc = lane; fc < GEMM_BN; fc += 32) {
        const int f = f0 + fc;
        if (f < F)
          tiled::cp_async4(b + kk * GEMM_BNP + fc,
                           dpn + ((size_t)which * F + f) * V + v);
        else
          b[kk * GEMM_BNP + fc] = 0.f;
      }
    }
  };
  float acc[4][4] = {};
  const int nchunks = n_end - n_begin;
#pragma unroll
  for (int i = 0; i < GEMM_STAGES - 1; ++i) {
    if (i < nchunks) stage(i, n_begin + i);
    tiled::cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    tiled::cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    const int nxt = ch + GEMM_STAGES - 1;
    if (nxt < nchunks) stage(nxt % GEMM_STAGES, n_begin + nxt);
    tiled::cp_async_commit();
    const int buf = ch % GEMM_STAGES;
    if (tm * 4 < Mp)
      mma_rows(acc, As + buf * D * Mp, Bs + buf * D * GEMM_BNP, D, Mp,
               GEMM_BNP, tm, tn);
  }
  tiled::cp_async_wait<0>();
  if (tm * 4 >= Mp) return;
  float *out = p.dw_part + (size_t)s * M * F;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int m = tm * 4 + i, f = f0 + tn * 4 + jj;
      if (m < M && f < F) out[(size_t)m * F + f] = acc[i][jj];
    }
}

// Shared memory of the edge products' blocks, in bytes.
inline size_t edge_dx_smem(int V, int Cm) {
  return 4 * GEMM_STAGES * (size_t)GEMM_BK * (pad4(Cm) + pad4(2 * V));
}
inline size_t edge_dw_smem(int V, int Cm) {
  return 4 * GEMM_STAGES * (size_t)(2 * V) * (pad4(Cm + 1) + GEMM_BNP);
}

// out[j] = sum_s parts[s, j] in a fixed order: a block takes 32 columns,
// each of its SUM_WARPS warps a run of rows in order, then the runs' sums
// in order.
constexpr int SUM_WARPS = 8;
__global__ void __launch_bounds__(32 * SUM_WARPS)
sum_over_samples_kernel(const float *__restrict__ parts,
                        float *__restrict__ out, int S, int W) {
  __shared__ float run[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const int s0 = (int)((long long)warp * S / SUM_WARPS);
  const int s1 = (int)((long long)(warp + 1) * S / SUM_WARPS);
  float acc = 0.f;
  if (j < W) {
#pragma unroll 8
    for (int s = s0; s < s1; ++s) acc += parts[(size_t)s * W + j];
  }
  run[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && j < W) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < SUM_WARPS; ++w) total += run[w][lane];
    out[j] = total;
  }
}
inline int sum_blocks(int W) { return (W + 31) / 32; }

// Sizes the kernels do not take (the wrapper refuses them first).
inline bool refuse(const Args &b, int N) {
  const tiled::Args &a = b.g;
  const int nrr = (a.T + a.rows_per_block - 1) / a.rows_per_block;
  return tiled::refuse(a, N) || b.nrr != (nrr > 1 ? nrr : 1) ||
         block_threads(a.V, a.CG) > MAX_THREADS || a.K > 65535 ||
         (a.edge_k >= 0 && (a.Cm + 1 > GEMM_MAX_M || a.edge_k >= a.K));
}

template <typename Tio>
static int launch_bwd(Args b, int N, float *dx1, float *dx2, float *parts,
                      float *sums, float *p1s, float *p2s, float *dxe_part,
                      float *dw_part, int ns, cudaStream_t st) {
  tiled::Args &a = b.g;
  if (refuse(b, N) || (a.edge_k >= 0 && ns < 1))
    return (int)cudaErrorInvalidValue;
  const int V = a.V, K = a.K, Cm = a.Cm, E = a.E;
  const size_t esize = sizeof(Tio);
  a.vec = (a.CG * esize) % 16 == 0 && (Cm * esize) % 16 == 0 &&
          (uintptr_t)a.pre % 16 == 0;
  b.dy_pairs = a.CG % 2 == 0 && Cm % 2 == 0 && (uintptr_t)b.dy % 4 == 0;
  if (a.edge_k >= 0) {                     // the bias field is (Cm, V, V)
    const int err = tiled::launch_edge(a, N, p1s, p2s, V * V, V, st);
    if (err != 0) return err;
  }
  const size_t fsmem = finish_smem_bytes(V, Cm);
  cudaError_t err = cudaFuncSetAttribute(
      (const void *)bwd_ada_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fsmem);
  if (err != cudaSuccess) return (int)err;
  bwd_ada_kernel<<<dim3(K, N), FIN_THREADS, fsmem, st>>>(b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto contract = joint_bound(V) == 25 ? bwd_contract_kernel<Tio, 25>
                                       : bwd_contract_kernel<Tio, 32>;
  const size_t smem = smem_bytes(V, a.CG, a.edge_k >= 0 ? E : 0, esize);
  err = cudaFuncSetAttribute((const void *)contract,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  contract<<<dim3(b.nrr, K * (Cm / a.CG), N), block_threads(V, a.CG), smem,
             st>>>(b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int W0 = K * V * V + 2 * K, F = E * Cm;
  Edge p{a.edge_w, a.x1, a.x2, b.dp_part, dxe_part, dw_part, N, V, K, Cm, F,
         a.edge_k, b.nrr, ns,
         min(GEMM_FSPLIT, (F + GEMM_BK - 1) / GEMM_BK)};
  if (a.edge_k >= 0) {
    const int FV2 = 2 * F * V;
    if (b.nrr > 1)
      edge_dp_sum_kernel<<<tiled::edge_blocks((size_t)N * FV2),
                           tiled::EDGE_THREADS, 0, st>>>(b.dp_part, N, b.nrr,
                                                         FV2);
    const size_t es = edge_dx_smem(V, Cm);
    err = cudaFuncSetAttribute((const void *)edge_dx_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)es);
    if (err != cudaSuccess) return (int)err;
    edge_dx_kernel<<<dim3(N, p.fs), warps_of(pad4(Cm) / 4 * (pad4(2 * V) / 4)),
                     es, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  err = cudaFuncSetAttribute((const void *)bwd_finish_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)fsmem);
  if (err != cudaSuccess) return (int)err;
  bwd_finish_kernel<<<dim3(K, N), FIN_THREADS, fsmem, st>>>(
      b, dx1, dx2, parts, dxe_part, p.fs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (a.edge_k >= 0) {
    const size_t es = edge_dw_smem(V, Cm);
    err = cudaFuncSetAttribute((const void *)edge_dw_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)es);
    if (err != cudaSuccess) return (int)err;
    edge_dw_kernel<<<dim3((F + GEMM_BN - 1) / GEMM_BN, ns),
                     warps_of(pad4(Cm + 1) / 4 * 16), es, st>>>(p);
    const int Wd = (Cm + 1) * F;           // [dedge_w (Cm, F) | dedge_b (F)]
    sum_over_samples_kernel<<<sum_blocks(Wd), 32 * SUM_WARPS, 0, st>>>(
        dw_part, sums + W0, ns, Wd);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  sum_over_samples_kernel<<<sum_blocks(W0), 32 * SUM_WARPS, 0, st>>>(
      parts, sums, N, W0);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  CG (channels a
// contraction block) and rows_per_block come from the wrapper's planner,
// nrr = max(1, ceil(T / rows_per_block)).  Scratch the wrapper allocates
// (floats): ada N*K*V*V, sc_part N*K*S*V*V and da_part N*K*S (S = nrr *
// Cm/CG), dx_part
// N*K*nrr*2*Cm*V, parts N*W0 (W0 = K*V*V + 2*K); with an edge subset
// p1s, p2s N*E*V*Cm each, ectr N*V*V*Cm, dp_part N*nrr*2*E*Cm*V, dxe_part
// N*GEMM_FSPLIT*2*Cm*V and dw_part ns*(Cm+1)*E*Cm.  sums receives [dA | dalpha | dbeta] (W0) and,
// with an edge subset, [dedge_w (Cm, E*Cm) | dedge_b (E*Cm)].  Returns a
// cudaError_t; the caller has checked shapes, types and devices.
extern "C" int dsgcn_dyn_graph_bwd(
    const void *pre, const void *dy, void *dpre, int bf16, float *dx1,
    float *dx2, float *parts, float *sums, const float *x1, const float *x2,
    const float *A, const float *alpha, const float *beta,
    const float *edge_w, const float *bias_field, const float *sel,
    float *p1s, float *p2s, float *ectr, float *ada, float *sc_part,
    float *da_part,
    float *dx_part, float *dp_part, float *dxe_part, float *dw_part, int N,
    int T, int V,
    int K, int Cm, int E, int edge_k, int CG, int rows_per_block, int nrr,
    int ns, void *stream) {
  using namespace dsgcn;
  bwd::Args b{{pre,    dpre,    x1,      x2,      A,      alpha, beta,
               edge_w, nullptr, nullptr, sel,     bias_field, ectr, T,
               V,      K,       Cm,      CG,      E,      edge_k, -1,
               rows_per_block, 0},
              dy, ada, sc_part, da_part, dx_part, dp_part, nrr, 0};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? bwd::launch_bwd<__nv_bfloat16>(b, N, dx1, dx2, parts, sums,
                                               p1s, p2s, dxe_part, dw_part,
                                               ns, st)
              : bwd::launch_bwd<float>(b, N, dx1, dx2, parts, sums, p1s, p2s,
                                       dxe_part, dw_part, ns, st);
}

extern "C" const char *dsgcn_dyn_graph_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The contraction block K2 launches for a plan of CG channels: its threads
// and shared-memory bytes, for pre/dy elements of esize bytes and E edge
// classes (0 without an edge subset).  The planner's model of the block
// (ops/kernels/dyn_graph.py bwd_block) is held to it.
extern "C" void dsgcn_bwd_block(int V, int CG, int esize, int E,
                                int *threads, int *smem) {
  *threads = dsgcn::bwd::block_threads(V, CG);
  *smem = (int)dsgcn::bwd::smem_bytes(V, CG, E, (size_t)esize);
}
