// The eval multi-branch temporal conv region of STGCN++ (MSTCN) and of
// DG-STGCN / DS-GCN (DGMSTCN) in one kernel: the Hopper kernel that replaces
// the TPU kernel dsgcn_tpu/ops/pallas/ms_tcn.py:fused_dgmstcn_eval (K7,
// _kernel):
//
//   xg   = x, and with coeff the joint-mean pseudo-joint as row V     (T, R, C)
//   pre  = relu(xg w_pre + b_pre), zero outside [0, T)               (T, R, P)
//   feat = [ conv3_{d_i}(pre[branch i]) + b_i, i = 0..3              (Tp, R, C')
//          | maxpool3(pre[branch 4])
//          | xg[::stride] w11 + b11 ]
//   feat = feat[:V] + coeff[v] * feat[V]                 (with coeff only)
//   out  = (relu(feat a_tr + b_tr) w_tc + b_tc) a_out + b_out        (Tp, V, C')
//
// with every BatchNorm folded into an affine or a 1x1 by the caller
// (ops/tcn.py:fused_ms_eval).  The branches are those of DEFAULT_MS_CFG:
// branch 0 has rem channels, branches 1-5 mid, P = rem + 4 mid,
// C' = rem + 5 mid; each branch reads and writes its own columns, at the
// same offset in pre and in feat.  Same contract as the Pallas function: x
// (N, T, V, C) float32 or bfloat16, every weight float32, all arithmetic in
// float32, out (N, ceil(T / stride), V, C') rounded to x's type once.
//
// Design.  A block owns one sample, a tile of TO output frames and a group
// of JR joints (plus the pseudo-joint row with coeff: R = JR + 1 rows; its
// branch outputs are recomputed by every joint group).  The temporal halo:
// the tile's taps, maxpool and strided 1x1 read input frames
// t0 * stride - pad ... (t0 + TO - 1) * stride + pad, pad = max dilation,
// TI = (TO - 1) * stride + 2 pad + 1 of them; the block recomputes pre on
// those frames instead of exchanging it with its neighbours, and stages pre
// in shared memory one branch at a time (TI * R * rem floats), so the
// (TO * R, C') feat tile, which the transform 1x1 needs whole, fits beside
// it.  Zero pre rows outside [0, T) are the convs' zero padding and, as pre
// >= 0 after its ReLU, the maxpool's -inf padding.  The wrapper chooses
// (TO, JR) from a cost model of this kernel (ops/kernels/ms_tcn.py:
// tile_plan).  The pseudo-joint (the per-frame mean of x over the V joints,
// float32) comes from a small first kernel, so that a joint group need not
// read the other joints.
//
// The products (pre, taps, 1x1, transform) are CUDA-core FMA loops: a warp
// takes 128 rows x 4 columns, each lane 4 rows x 4 columns in registers,
// and steps k by 4 with 16-byte loads: per 64 FMAs a lane loads four
// 4-wide slices of its rows (shared memory, or x from global memory) and
// four 4-wide rows of the weights (warp-wide broadcasts through L1/L2).
// For that the wrapper zero-pads every weight matrix to widths and depths
// that are multiples of 4, x's channels too where C is not, and the
// shared-memory rows have strides of an odd number of 16-byte words (no
// bank conflicts).  Bound on the H100: operations (the pre and transform
// 1x1s are ~80% of them, ~2 FLOP per byte of x at C = 64); the halo
// recompute and the pseudo-joint row add to them.  wgmma and TMA are later
// work.
#include "graph_agg.cuh"

namespace dsgcn {
namespace ms {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANE_ROWS = 4;               // a lane's rows: m0 + 32 i
constexpr int TILE_ROWS = 32 * LANE_ROWS;  // a warp tile: 128 rows x 4 columns
constexpr int TILE_COLS = 4;
constexpr size_t SMEM_LIMIT = 232448;

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }
// a shared-memory row of n floats: an odd number of 16-byte words
__host__ __device__ inline int row_words(int n) { return 4 * ((round4(n) / 4) | 1); }

// Shared memory of a block: the (TO * R, C') feat tile and one branch's
// (TI * R, rem) pre tile, rows padded as row_words says.
inline size_t smem_bytes(int TO, int R, int stride, int pad, int Cp,
                         int rem) {
  const size_t TI = (size_t)(TO - 1) * stride + 2 * pad + 1;
  return ((size_t)TO * R * row_words(Cp) + TI * R * row_words(rem)) *
         sizeof(float);
}

__device__ __forceinline__ float4 load4(const float *p) {
  return *reinterpret_cast<const float4 *>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16 *p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2 *>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// out[m, o] = sum_{ko < KO, k < KI} A(m, ko * a_ostride + k) B[ko * KI + k, o]
// for m < M, o < NC, handed to epi(m, o, sum).  rows.ref(m) gives row m of
// A; B is (KO * KI, ldb) row-major in global memory.  KI, a_ostride and ldb
// are multiples of 4, B has round4(NC) columns, rows are 16-byte aligned.
template <class Rows, class Epi>
__device__ void product(int M, int NC, int KO, int KI, int a_ostride,
                        const Rows &rows, const float *__restrict__ B,
                        int ldb, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = (M + TILE_ROWS - 1) / TILE_ROWS;
  const int nt = (NC + TILE_COLS - 1) / TILE_COLS;
  for (int tile = warp; tile < mt * nt; tile += WARPS) {
    const int m0 = (tile % mt) * TILE_ROWS + lane;
    const int n0 = (tile / mt) * TILE_COLS;
    typename Rows::Ref a[LANE_ROWS];
#pragma unroll
    for (int i = 0; i < LANE_ROWS; ++i) a[i] = rows.ref(min(m0 + 32 * i, M - 1));
    float acc[LANE_ROWS][TILE_COLS] = {};
    for (int ko = 0; ko < KO; ++ko) {
      const float *b = B + (size_t)ko * KI * ldb + n0;
      const int off = ko * a_ostride;
      for (int k = 0; k < KI; k += 4) {
        float4 bv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          bv[kk] = __ldg(reinterpret_cast<const float4 *>(b + (size_t)(k + kk) * ldb));
#pragma unroll
        for (int i = 0; i < LANE_ROWS; ++i) {
          const float4 av = a[i].at4(off + k);
          const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[i][0] = fmaf(ak[kk], bv[kk].x, acc[i][0]);
            acc[i][1] = fmaf(ak[kk], bv[kk].y, acc[i][1]);
            acc[i][2] = fmaf(ak[kk], bv[kk].z, acc[i][2]);
            acc[i][3] = fmaf(ak[kk], bv[kk].w, acc[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < LANE_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < TILE_COLS; ++j)
        if (m0 + 32 * i < M && n0 + j < NC) epi(m0 + 32 * i, n0 + j, acc[i][j]);
  }
}

// Rows of xg for frames t_first + (m / R) * t_step (clamped into [0, T);
// the caller zeroes what lies outside): joint rows from x, the pseudo-joint
// row (r == jr) from the joint means.
template <typename Tio> struct XRows {
  const Tio *x;        // (T, V, C) of the sample
  const float *xm;     // (T, C) of the sample, or null
  int V, C, v0, jr, R, T, t_first, t_step;
  struct Ref {
    const Tio *px;
    const float *pf;
    __device__ float4 at4(int k) const {
      return px != nullptr ? load4(px + k) : __ldg(reinterpret_cast<const float4 *>(pf + k));
    }
  };
  __device__ Ref ref(int m) const {
    const int r = m % R;
    int t = t_first + (m / R) * t_step;
    t = t < 0 ? 0 : (t >= T ? T - 1 : t);
    if (r < jr) return Ref{x + ((size_t)t * V + v0 + r) * C, nullptr};
    return Ref{nullptr, xm + (size_t)t * C};
  }
};

struct SmemRef {
  const float *p;
  __device__ float4 at4(int k) const { return load4(p + k); }
};

// Rows of the staged pre for output row m = (frame j, row r): input frame
// j * stride + first (the first tap); the taps step d * R rows.
struct PreRows {
  const float *pre;
  int PS, R, stride, first;
  using Ref = SmemRef;
  __device__ Ref ref(int m) const {
    return Ref{pre + ((size_t)((m / R) * stride + first) * R + m % R) * PS};
  }
};

// The joint rows of the feat tile, row m = (frame m / jr, joint m % jr).
struct FeatRows {
  const float *feat;
  int FS, R, jr;
  using Ref = SmemRef;
  __device__ Ref ref(int m) const {
    return Ref{feat + ((size_t)(m / jr) * R + m % jr) * FS};
  }
};

// Zero-padded weights (ops/kernels/ms_tcn.py:pack_weights): per branch b,
// w_pre (C, round4(cb_b)) and b_pre; per conv branch (3, round4(cb),
// round4(cb)) taps; w11 (C, round4(mid)); w_tc (round4(C'), round4(C')).
struct Params {
  const float *w_pre, *b_pre, *taps, *bias, *w11, *a_tr, *b_tr, *w_tc,
      *b_tc, *a_out, *b_out, *coeff, *xmean;
  int T, V, C, Cp, rem, mid, stride, Tp, pad, TO, JR;
  int dil[4];
};

// The pseudo-joint: xm[n, t, c] = mean_v x[n, t, v, c], float32.
template <typename Tio>
__global__ void joint_mean_kernel(const Tio *__restrict__ x,
                                  float *__restrict__ xm, int V, int C) {
  const size_t nt = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < V; ++v) s += to_f32(x[(nt * V + v) * C + c]);
    xm[nt * C + c] = s / V;
  }
}

template <typename Tio>
__global__ void __launch_bounds__(THREADS)
ms_tcn_kernel(const Tio *__restrict__ x, Tio *__restrict__ out, Params p) {
  extern __shared__ float4 smem4[];
  float *smem = reinterpret_cast<float *>(smem4);
  const int n = blockIdx.z, v0 = blockIdx.y * p.JR, t0 = blockIdx.x * p.TO;
  const int g = p.coeff != nullptr;
  const int jr = min(p.JR, p.V - v0), R = jr + g;
  const int TOe = min(p.TO, p.Tp - t0);
  const int TIe = (TOe - 1) * p.stride + 2 * p.pad + 1;
  const int FS = row_words(p.Cp), PS = row_words(p.rem);
  const int Cp4 = round4(p.Cp), rem4 = round4(p.rem), mid4 = round4(p.mid);
  const int t_in0 = t0 * p.stride - p.pad;   // the tile's first input frame
  float *feat = smem;                                    // (TO * R, FS)
  float *pre = smem + (size_t)p.TO * (p.JR + g) * FS;    // (TI * R, PS)
  const Tio *xn = x + (size_t)n * p.T * p.V * p.C;
  const float *xmn = g ? p.xmean + (size_t)n * p.T * p.C : nullptr;

  // branch 5: the strided 1x1 on xg (input frames t' * stride)
  {
    const XRows<Tio> rows{xn, xmn, p.V, p.C, v0, jr, R, p.T,
                          t0 * p.stride, p.stride};
    const int slot = p.Cp - p.mid;
    product(TOe * R, p.mid, 1, p.C, 0, rows, p.w11, mid4,
            [&](int m, int o, float acc) {
              feat[m * FS + slot + o] = acc + __ldg(p.bias + slot + o);
            });
  }
  const XRows<Tio> in_rows{xn, xmn, p.V, p.C, v0, jr, R, p.T, t_in0, 1};
  const float *w_pre = p.w_pre, *b_pre = p.b_pre, *taps = p.taps;
  for (int b = 0; b < 5; ++b) {
    const int cb = b == 0 ? p.rem : p.mid, cb4 = b == 0 ? rem4 : mid4;
    const int slot = b == 0 ? 0 : p.rem + (b - 1) * p.mid;
    __syncthreads();                 // the last branch has read pre
    // this branch's pre on the tile's input frames (its zero-padded
    // columns come out 0)
    product(TIe * R, cb4, 1, p.C, 0, in_rows, w_pre, cb4,
            [&](int m, int c, float acc) {
              const int t = t_in0 + m / R;
              pre[m * PS + c] = (t >= 0 && t < p.T)
                  ? fmaxf(acc + __ldg(b_pre + c), 0.f) : 0.f;
            });
    w_pre += (size_t)p.C * cb4;
    b_pre += cb4;
    __syncthreads();
    if (b < 4) {                     // k = 3 conv, dilation d, pad d
      const int d = p.dil[b];
      const PreRows rows{pre, PS, R, p.stride, p.pad - d};
      product(TOe * R, cb, 3, cb4, d * R * PS, rows, taps, cb4,
              [&](int m, int o, float acc) {
                feat[m * FS + slot + o] = acc + __ldg(p.bias + slot + o);
              });
      taps += (size_t)3 * cb4 * cb4;
    } else {                         // maxpool 3, pad 1 (bias 0)
      for (int i = threadIdx.x; i < TOe * R * cb; i += blockDim.x) {
        const int c = i % cb, m = i / cb;
        const float *q =
            pre + ((size_t)((m / R) * p.stride + p.pad - 1) * R + m % R) * PS + c;
        feat[m * FS + slot + c] =
            fmaxf(fmaxf(q[0], q[(size_t)R * PS]), q[(size_t)2 * R * PS]);
      }
    }
  }
  __syncthreads();                   // feat complete

  // the pseudo-joint's branch outputs onto every joint, the transform BN
  // and ReLU (the pseudo-joint row is only read); columns past C' zeroed
  for (int i = threadIdx.x; i < TOe * jr * Cp4; i += blockDim.x) {
    const int c = i % Cp4, m = i / Cp4, j = m / jr, r = m % jr;
    float *f = feat + (size_t)(j * R + r) * FS + c;
    if (c >= p.Cp) {
      *f = 0.f;
      continue;
    }
    float v = *f;
    if (g) v += feat[(size_t)(j * R + jr) * FS + c] * __ldg(p.coeff + v0 + r);
    *f = fmaxf(v * __ldg(p.a_tr + c) + __ldg(p.b_tr + c), 0.f);
  }
  __syncthreads();

  // transform 1x1 and the output BN
  const FeatRows rows{feat, FS, R, jr};
  Tio *on = out + ((size_t)n * p.Tp + t0) * p.V * p.Cp;
  product(TOe * jr, p.Cp, 1, Cp4, 0, rows, p.w_tc, Cp4,
          [&](int m, int o, float acc) {
            const float y = (acc + __ldg(p.b_tc + o)) * __ldg(p.a_out + o) +
                            __ldg(p.b_out + o);
            on[((size_t)(m / jr) * p.V + v0 + m % jr) * p.Cp + o] =
                from_f32<Tio>(y);
          });
}

template <typename Tio>
static int launch(const void *x, void *out, const Params &p, int N,
                  cudaStream_t stream) {
  const int g = p.coeff != nullptr;
  const size_t smem = smem_bytes(p.TO, p.JR + g, p.stride, p.pad, p.Cp, p.rem);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (g) {
    const int threads = p.C < THREADS ? (p.C + 31) / 32 * 32 : THREADS;
    joint_mean_kernel<Tio><<<N * p.T, threads, 0, stream>>>(
        (const Tio *)x, const_cast<float *>(p.xmean), p.V, p.C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      ms_tcn_kernel<Tio>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tp + p.TO - 1) / p.TO, (p.V + p.JR - 1) / p.JR, N);
  ms_tcn_kernel<Tio><<<grid, THREADS, smem, stream>>>((const Tio *)x,
                                                      (Tio *)out, p);
  return (int)cudaGetLastError();
}

}  // namespace ms
}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  The weights are
// zero-padded as Params says; bias (C'): the branches' biases at their
// columns, 0 at the maxpool's; coeff null for MSTCN (then xmean is
// unused), else xmean is an (N, T, C) float32 scratch.  C a multiple of 4,
// x 16-byte aligned.  (TO, JR): the block's output frames and joints.
// Returns a cudaError_t; the caller has checked shapes, types and devices.
extern "C" int dsgcn_ms_tcn(const void *x, void *out, int bf16, float *xmean,
                            const float *w_pre, const float *b_pre,
                            const float *taps, const float *bias,
                            const float *w11, const float *a_tr,
                            const float *b_tr, const float *w_tc,
                            const float *b_tc, const float *a_out,
                            const float *b_out, const float *coeff, int N,
                            int T, int V, int C, int Cp, int rem, int mid,
                            int d0, int d1, int d2, int d3, int stride, int TO,
                            int JR, void *stream) {
  using namespace dsgcn::ms;
  const int dil[4] = {d0, d1, d2, d3};
  int pad = 0;
  for (int d : dil) {
    if (d < 1) return (int)cudaErrorInvalidValue;
    pad = d > pad ? d : pad;
  }
  if (N < 1 || N > 65535 || T < 1 || V < 1 || C < 4 || C % 4 != 0 ||
      mid < 1 || rem < mid || Cp != rem + 5 * mid || stride < 1 || TO < 1 ||
      JR < 1 || JR > V || (coeff != nullptr && xmean == nullptr) ||
      (size_t)x % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{w_pre, b_pre, taps, bias, w11, a_tr, b_tr, w_tc, b_tc, a_out,
           b_out, coeff, xmean, T, V, C, Cp, rem, mid, stride,
           (T + stride - 1) / stride, pad, TO, JR, {d0, d1, d2, d3}};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, out, p, N, st)
              : launch<float>(x, out, p, N, st);
}

extern "C" const char *dsgcn_ms_tcn_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
