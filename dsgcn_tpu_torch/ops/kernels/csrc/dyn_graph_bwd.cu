// Fused dynamic-graph build + aggregation, backward: the Hopper kernel that
// replaces the TPU kernel dsgcn_tpu/ops/pallas/dyn_graph.py:_bwd_pallas
// (K2, _bwd_kernel with _edge_ctr).  Forward: y[t,w,c] = sum_v pre[t,v,c]
// G[c,v,w] with G = alpha ctr + (beta ada + A) (graph_agg.cuh).  Per sample
// n and subset k, from the upstream gradient dy:
//
//   dpre[t,v,c] = sum_w dy[t,w,c] G[c,v,w]
//   dG[c,v,w]   = sum_t pre[t,v,c] dy[t,w,c]
//   ctr path:   dz = dG alpha (1 - ctr^2); dx1 += sum_w dz, dx2 -= sum_v dz,
//               on the edge subset through the class projections:
//               dP1[e,c,v] = sum_w sel[e,v,w] dz, dP2[e,c,w] = -sum_v sel dz,
//               dx1 = edge_w dP1, dx2 = edge_w dP2,
//               dedge_w = x1 dP1^T + x2 dP2^T, dedge_b = sum_v dP1
//   ada path:   ds = beta sum_c dG; draw = ada (ds - sum_v ds ada) (softmax
//               VJP over the source axis v); dx1 += x2 draw^T, dx2 += x1 draw
//   dA = sum_n sum_c dG, dalpha = <dG, ctr>, dbeta = <sum_c dG, ada>.
//
// Same contract as the Pallas backward: pre/dy/dpre (N, T, V, K*Cm) float32
// or bfloat16, lifted to float32 on load; the graph math and every gradient
// but dpre in float32.  What the TPU carried between grid steps, the card
// cannot (blocks run in no order), so:
//
// * one block owns one (sample, subset) and loops over all of T: the sums
//   over T stay in the block.  The block takes the subset's channels in
//   groups of CG, one group after the other (Pallas: subsets kg at a time,
//   _bwd_plan): thread (c, i) of a group keeps the dG column dG[c, :, i] in
//   registers and reads the graph row G[c, i, :] for dpre from shared
//   memory, where the block builds the group's G once (CG*V*V floats).  CG
//   is Cm while Cm*V threads fit a block (every DS-GCN subset), else the
//   largest divisor of Cm that fits (32 at DG-STGCN's Cm = 64, V = 25).
// * the sum over channels of dG feeds dA, dbeta and the softmax VJP.  Each
//   group adds its channels to a (V, V) sum in shared memory, groups in
//   order; the ctr part of dx1/dx2 is written per group, and the ada part
//   is added once every group is in.  The edge-class subset needs all its
//   channels at once (dx = edge_w dP mixes them), so edge attention takes
//   Cm*V <= 1024.
// * sums over samples (dA, dalpha, dbeta, dedge_w, dedge_b) are written per
//   sample to a scratch the wrapper allocates, and a second kernel of this
//   file adds them up in a fixed order: no atomics, the same bits in every
//   run.
//
// Bound on the H100: bytes (pre and dy read once, dpre written once); the
// graph-shaped work per block (build, chain through tanh, softmax and the
// edge classes) is O(Cm V^2 E) and independent of T.  A simple kernel: 4
// rows of pre/dy staged between barriers, one block per (n, k).  Faster
// designs (wgmma for the two T-contractions, TMA staging) are later work.
#include "graph_agg.cuh"

namespace dsgcn {

constexpr int BWD_ROWS = 4;            // rows of pre and dy staged per pass
constexpr int BWD_MAX_THREADS = 1024;  // CG * V, rounded up to a warp

// Channels per pass: all Cm when Cm*V threads fit a block, else the largest
// divisor of Cm that fits.
inline int bwd_channel_group(int Cm, int V) {
  for (int g = Cm; g > 1; --g)
    if (Cm % g == 0 && g * V <= BWD_MAX_THREADS) return g;
  return 1;
}

struct BwdSmem {
  Smem g;               // xs1, xs2 (all Cm channels), ada, p1s, p2s
  float *gbuf;          // (CG, V, V): G in the T loop, then dG, then dz
  float *sc;            // (V, V): sum over channels of dG
  float *draw;          // (V, V): the softmax VJP
  float *pre_s, *dy_s;  // (BWD_ROWS, V, CG) staged rows
  float *red;           // 32 floats for block sums
};

inline size_t bwd_smem_bytes(int V, int Cm, int CG, int E) {
  const int XS = row_stride(V);
  const size_t floats = 2 * (size_t)Cm * XS + (size_t)V * V +
                        2 * (size_t)E * Cm * XS + (size_t)CG * V * V +
                        2 * (size_t)V * V + 2 * (size_t)BWD_ROWS * V * CG + 32;
  return floats * sizeof(float);
}

__device__ inline BwdSmem carve_bwd(float *base, int V, int Cm, int CG,
                                    int E) {
  const int XS = row_stride(V);
  BwdSmem b;
  b.g.xs1 = base;
  b.g.xs2 = b.g.xs1 + Cm * XS;
  b.g.ada = b.g.xs2 + Cm * XS;
  b.g.p1s = b.g.ada + V * V;
  b.g.p2s = b.g.p1s + E * Cm * XS;
  b.g.pres = nullptr;
  b.gbuf = b.g.p2s + E * Cm * XS;
  b.sc = b.gbuf + CG * V * V;
  b.draw = b.sc + V * V;
  b.pre_s = b.draw + V * V;
  b.dy_s = b.pre_s + BWD_ROWS * V * CG;
  b.red = b.dy_s + BWD_ROWS * V * CG;
  return b;
}

// Sum of v over the block, the same value in every thread (the block is a
// whole number of warps).  Its barriers also publish every shared-memory
// write made before the call.
__device__ inline float block_sum(float v, float *red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                 // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// Per-sample partial sums, one row of W floats per sample:
// [dA (K, V, V) | dalpha (K) | dbeta (K) | dedge_w (Cm, E*Cm) | dedge_b].
// With edge attention (edge_k >= 0) the caller passes CG == Cm.
template <typename Tio>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
dyn_graph_bwd_kernel(const Tio *__restrict__ pre, const Tio *__restrict__ dy,
                     Tio *__restrict__ dpre, float *__restrict__ dx1,
                     float *__restrict__ dx2, float *__restrict__ parts,
                     const float *__restrict__ x1, const float *__restrict__ x2,
                     const float *__restrict__ A,
                     const float *__restrict__ alpha,
                     const float *__restrict__ beta,
                     const float *__restrict__ edge_w,
                     const float *__restrict__ bias_field,
                     const float *__restrict__ sel, int T, int V, int K,
                     int Cm, int CG, int E, int edge_k, int W) {
  extern __shared__ float smem[];
  const int k = blockIdx.x, n = blockIdx.y;
  const bool edge = (k == edge_k);
  const BwdSmem b = carve_bwd(smem, V, Cm, CG, edge_k >= 0 ? E : 0);
  const Smem &s = b.g;
  const int XS = row_stride(V);
  const int tid = threadIdx.x, KC = K * Cm, VV = V * V;
  // thread (channel cl of a group, joint i)
  const int cl = tid % CG, i = tid / CG;
  const bool active = tid < CG * V;
  const float a_k = alpha[k], b_k = beta[k];
  const float *A_k = A + (size_t)k * VV;
  float *part = parts + (size_t)n * W;

  // queries, their class projections (edge subset), the ada graph
  const size_t q = ((size_t)n * K + k) * Cm * V;
  for (int j = tid; j < Cm * V; j += blockDim.x) {
    s.xs1[(j / V) * XS + j % V] = x1[q + j];
    s.xs2[(j / V) * XS + j % V] = x2[q + j];
  }
  __syncthreads();
  if (edge) edge_projections(s, edge_w, V, Cm, Cm, 0, E);
  build_ada(s.ada, s.xs1, s.xs2, Cm, V, -1);   // syncs before reading
  for (int j = tid; j < VV; j += blockDim.x) b.sc[j] = 0.f;

  float da = 0.f;
  const size_t row0 = (size_t)n * T;
  for (int c0 = 0; c0 < Cm; c0 += CG) {
    const int c = c0 + cl;
    // G of the group, in float32 as the Pallas backward uses it
    if (active) {
      for (int v = 0; v < V; ++v)
        b.gbuf[(cl * V + v) * V + i] =
            graph_entry<float>(c, cl, v, i, s, V, CG, A_k, a_k, b_k, edge, E,
                               sel, bias_field, VV, V);
    }

    // the T loop: dpre out, dG into registers
    float dg[VMAX];
#pragma unroll
    for (int v = 0; v < VMAX; ++v) dg[v] = 0.f;
    for (int t0 = 0; t0 < T; t0 += BWD_ROWS) {
      const int rows = min(BWD_ROWS, T - t0);
      __syncthreads();                     // G built / the last tile read
      for (int j = tid; j < rows * V * CG; j += blockDim.x) {
        const size_t g =
            ((row0 + t0) * V + j / CG) * KC + k * Cm + c0 + j % CG;
        b.pre_s[j] = to_f32(pre[g]);
        b.dy_s[j] = to_f32(dy[g]);
      }
      __syncthreads();
      if (active) {
        const float *grow = b.gbuf + (cl * V + i) * V;  // G[c, i, :]
        for (int r = 0; r < rows; ++r) {
          const float *pr = b.pre_s + r * V * CG + cl;  // pre[t, v, c]
          const float *dr = b.dy_s + r * V * CG + cl;   // dy[t, w, c]
          const float dyi = dr[i * CG];
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < VMAX; ++v) {
            if (v < V) {
              dg[v] += pr[v * CG] * dyi;     // dG[c, v, i]
              acc += dr[v * CG] * grow[v];   // sum_w dy[t, w, c] G[c, i, w]
            }
          }
          dpre[((row0 + t0 + r) * V + i) * KC + k * Cm + c] =
              from_f32<Tio>(acc);
        }
      }
    }
    __syncthreads();                       // every thread is done with G

    // gbuf <- dG; sc += the group's sum over channels
    if (active) {
#pragma unroll
      for (int v = 0; v < VMAX; ++v)
        if (v < V) b.gbuf[(cl * V + v) * V + i] = dg[v];
    }
    __syncthreads();
    for (int j = tid; j < VV; j += blockDim.x) {
      float sum = b.sc[j];
      for (int cc = 0; cc < CG; ++cc) sum += b.gbuf[cc * VV + j];
      b.sc[j] = sum;
    }
    __syncthreads();                       // gbuf is read above

    // ctr path: dalpha and gbuf <- dz
    if (active) {
#pragma unroll
      for (int v = 0; v < VMAX; ++v) {
        if (v < V) {
          const float ct = ctr_entry(c, cl, v, i, s, V, CG, edge, E, sel,
                                     bias_field, VV, V);
          da += dg[v] * ct;
          b.gbuf[(cl * V + v) * V + i] = dg[v] * a_k * (1.f - ct * ct);
        }
      }
    }
    __syncthreads();                       // dz published

    // edge subset (CG == Cm): p1s/p2s <- dP1/dP2 (P is no longer read)
    if (edge) {
      for (int j = tid; j < E * Cm * V; j += blockDim.x) {
        const int v = j % V, cc = (j / V) % Cm, e = j / (V * Cm);
        const float *dz = b.gbuf + cc * VV;
        const float *se = sel + (size_t)e * VV;
        float d1 = 0.f, d2 = 0.f;
        for (int u = 0; u < V; ++u) {
          d1 += __ldg(se + v * V + u) * dz[v * V + u];   // over targets w = u
          d2 -= __ldg(se + u * V + v) * dz[u * V + v];   // over sources, w = v
        }
        s.p1s[(e * Cm + cc) * XS + v] = d1;
        s.p2s[(e * Cm + cc) * XS + v] = d2;
      }
      __syncthreads();
    }

    // the ctr part of dx1[c, i], dx2[c, i]
    if (active) {
      float d1 = 0.f, d2 = 0.f;
      if (edge) {
        const float *wrow = edge_w + (size_t)c * E * Cm;   // edge_w[c, :]
        for (int f = 0; f < E * Cm; ++f) {
          const float wv = __ldg(wrow + f);
          d1 += wv * s.p1s[f * XS + i];
          d2 += wv * s.p2s[f * XS + i];
        }
      } else {
        for (int u = 0; u < V; ++u) {
          d1 += b.gbuf[(cl * V + i) * V + u];    // sum_w dz[c, i, w]
          d2 -= b.gbuf[(cl * V + u) * V + i];    // -sum_v dz[c, v, i]
        }
      }
      dx1[q + c * V + i] = d1;
      dx2[q + c * V + i] = d2;
    }
    __syncthreads();                       // the next group rebuilds gbuf
  }

  // every group is in: this sample's dA, dalpha; the ada path
  for (int j = tid; j < VV; j += blockDim.x) part[k * VV + j] = b.sc[j];
  const float dalpha = block_sum(da, b.red);
  float dbl = 0.f;
  for (int w = tid; w < V; w += blockDim.x) {
    float inner = 0.f;
    for (int v = 0; v < V; ++v) {
      const float sc = b.sc[v * V + w], ad = s.ada[v * V + w];
      inner += b_k * sc * ad;
      dbl += sc * ad;
    }
    for (int v = 0; v < V; ++v)
      b.draw[v * V + w] = s.ada[v * V + w] * (b_k * b.sc[v * V + w] - inner);
  }
  const float dbeta = block_sum(dbl, b.red);   // publishes draw
  if (tid == 0) {
    part[K * VV + k] = dalpha;
    part[K * VV + K + k] = dbeta;
  }

  // the ada part of dx1, dx2: each thread adds to the entries it wrote
  for (int c0 = 0; c0 < Cm; c0 += CG) {
    if (!active) break;
    const int c = c0 + cl;
    float d1 = 0.f, d2 = 0.f;
    for (int u = 0; u < V; ++u) {
      d1 += s.xs2[c * XS + u] * b.draw[i * V + u];
      d2 += s.xs1[c * XS + u] * b.draw[u * V + i];
    }
    dx1[q + c * V + i] += d1;
    dx2[q + c * V + i] += d2;
  }

  // edge subset: this sample's dedge_w (Cm, E*Cm) and dedge_b (E*Cm)
  if (edge) {
    const int F = E * Cm;
    float *dew = part + K * VV + 2 * K;
    for (int j = tid; j < Cm * F; j += blockDim.x) {
      const int f = j % F, cc = j / F;
      float acc = 0.f;
      for (int u = 0; u < V; ++u)
        acc += s.xs1[cc * XS + u] * s.p1s[f * XS + u] +
               s.xs2[cc * XS + u] * s.p2s[f * XS + u];
      dew[j] = acc;
    }
    for (int f = tid; f < F; f += blockDim.x) {
      float acc = 0.f;
      for (int u = 0; u < V; ++u) acc += s.p1s[f * XS + u];
      dew[Cm * F + f] = acc;
    }
  }
}

// out[j] = sum_n parts[n, j], n in order.
__global__ void sum_over_samples_kernel(const float *__restrict__ parts,
                                        float *__restrict__ out, int N,
                                        int W) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  float acc = 0.f;
  for (int n = 0; n < N; ++n) acc += parts[(size_t)n * W + j];
  out[j] = acc;
}

inline int partial_width(int V, int K, int Cm, int E, int edge_k) {
  return K * V * V + 2 * K + (edge_k >= 0 ? Cm * E * Cm + E * Cm : 0);
}

template <typename Tio>
static int launch_bwd(const void *pre, const void *dy, void *dpre,
                      float *dx1, float *dx2, float *parts, float *sums,
                      const float *x1, const float *x2, const float *A,
                      const float *alpha, const float *beta,
                      const float *edge_w, const float *bias_field,
                      const float *sel, int N, int T, int V, int K, int Cm,
                      int E, int edge_k, cudaStream_t stream) {
  const int CG = edge_k >= 0 ? Cm : bwd_channel_group(Cm, V);
  const int threads = (CG * V + 31) / 32 * 32;
  const size_t smem = bwd_smem_bytes(V, Cm, CG, edge_k >= 0 ? E : 0);
  const int W = partial_width(V, K, Cm, E, edge_k);
  cudaError_t err = cudaFuncSetAttribute(
      dyn_graph_bwd_kernel<Tio>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dyn_graph_bwd_kernel<Tio><<<dim3(K, N), threads, smem, stream>>>(
      (const Tio *)pre, (const Tio *)dy, (Tio *)dpre, dx1, dx2, parts, x1,
      x2, A, alpha, beta, edge_w, bias_field, sel, T, V, K, Cm, CG, E, edge_k,
      W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_over_samples_kernel<<<(W + 255) / 256, 256, 0, stream>>>(parts, sums,
                                                              N, W);
  return (int)cudaGetLastError();
}

}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  parts is an
// (N, W) float32 scratch and sums its (W,) sum over samples, W as in
// partial_width.  Returns a cudaError_t; the caller has checked shapes,
// types and devices.
extern "C" int dsgcn_dyn_graph_bwd(const void *pre, const void *dy,
                                   void *dpre, int bf16, float *dx1,
                                   float *dx2, float *parts, float *sums,
                                   const float *x1, const float *x2,
                                   const float *A, const float *alpha,
                                   const float *beta, const float *edge_w,
                                   const float *bias_field, const float *sel,
                                   int N, int T, int V, int K, int Cm, int E,
                                   int edge_k, void *stream) {
  using namespace dsgcn;
  if (V < 1 || V > VMAX || E > EMAX || Cm < 1 ||
      (edge_k >= 0 && Cm * V > BWD_MAX_THREADS) || N > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_bwd<__nv_bfloat16>(pre, dy, dpre, dx1, dx2, parts,
                                          sums, x1, x2, A, alpha, beta,
                                          edge_w, bias_field, sel, N, T, V, K,
                                          Cm, E, edge_k, st)
              : launch_bwd<float>(pre, dy, dpre, dx1, dx2, parts, sums, x1,
                                  x2, A, alpha, beta, edge_w, bias_field, sel,
                                  N, T, V, K, Cm, E, edge_k, st);
}

extern "C" const char *dsgcn_dyn_graph_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
