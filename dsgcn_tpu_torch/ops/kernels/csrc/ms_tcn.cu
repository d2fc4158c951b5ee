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
// Bound on the H100: operations.  Four fifths of the work are the pre and
// transform 1x1s (2 C P and 2 C'^2 FLOP a joint row against C + C'
// elements moved), most of the rest the taps and the strided 1x1.  So every
// product runs on the tensor cores (pointwise_mma.cuh: mma.sync m16n8k8
// TF32, float32 operands split 3xTF32; a bfloat16 x is exact in TF32, so
// the pre product takes two terms there), and nothing but x and out (and
// the pseudo-joint's rows) touches device memory:
//
// A block owns one sample, a tile of TO output frames and a group of JR
// joints, rows ordered (frame, joint).  Its input frames are the tile's
// frames times the stride and a halo of pad = max dilation frames on each
// side; those inside [0, T) stream through a cp.async ring, R_in rows of
// x by KP channels a panel beside the panel of [w_pre | w11] they meet, so
// x is read once and never staged whole (a C = 256 tile would not fit).
// The epilogue puts relu(pre) into the pre tile (float32, shared; frames
// outside [0, T) stay zero: the convs' zero padding, and, as pre >= 0, the
// maxpool's -inf padding) and the strided 1x1's columns of the tile's
// output frames into the feat tile.  Each conv branch is then one product
// of depth 3 cb over row-shifted views of the pre tile (its taps' weights
// packed (3, cb8, cb4), each tap its own k8 steps, the rows of tap q moved
// by q d JR), the maxpool runs on CUDA cores, the broadcast of the
// pseudo-joint, the transform BN and ReLU go in place, and the transform
// 1x1 reads the feat tile, its epilogue storing 32-byte runs of a row.
// Strided views are row maps (A sources giving a warp's rows by address),
// not copies.  Each product's first weight panels are
// put in flight before the last product's epilogue; the epilogues'
// biases and affines sit in shared memory.  The halo's pre is recomputed
// by both neighbours; the planner (ops/kernels/ms_tcn.py:tile_plan)
// charges it and takes long tiles, all of a sample's frames where they
// fit.
//
// The pseudo-joint.  Its branch outputs are linear in its own row, so a
// first launch of the same kernel (MEAN) computes them once per (sample,
// output frame): the joint mean of x folded into its x panels, pre, taps,
// maxpool and 1x1 of that one row, into an (N, Tp, C') float32 scratch.
// The main launch's blocks hold joint rows only and add coeff[v] times the
// scratch row before the transform BN.
//
// Every output is one fixed sequence of sums, no atomics: the same bits on
// every run.  What bounds it now (PERF.md has the times and rates):
// latency, not the tensor cores' rate.  The four branch products are
// 10-46 columns wide, a tile or two a warp, and each of their k8 steps
// waits on its fragment loads and a chain of three dependent MMAs; one
// block of 16 warps an SM (128 registers a thread) leaves little to hide
// that with, and every product ends in a barrier.  The pseudo-joint's
// launch reads all of x once more.
#include "pointwise_mma.cuh"

namespace dsgcn {
namespace ms {

#if !defined(DSGCN_K7_NT)
#error "the block geometry is defined by ops/kernels/_build.py (-D flags)"
#endif
constexpr int NT = DSGCN_K7_NT;  // n8 tiles a warp holds a pass
using pw::KP;
using pw::MT;
using pw::STAGES;
using pw::THREADS;
using pw::WARP_ROWS;
using pw::WARPS;
using pw::WarpTile;
using pw::Weights;
using pw::pitch_a;
using pw::pitch_b;
using pw::round_up;
using pw::slot_row;
constexpr int MAX_ROWS = WARP_ROWS * WARPS;  // rows of a product
constexpr int NCONST = 7;  // bq, bias, a_tr, b_tr, b_tc, a_out, b_out

// Row pitch of a streamed x panel: 16 bytes times an odd number, so that the
// 8 rows x 4 columns of a fragment load fall on distinct banks.
__host__ __device__ inline int pitch_x(int bytes) {
  return 16 * (((bytes + 15) / 16) | 1);
}

// Where a block's pieces lie in shared memory (bytes), for a plan of TO
// output frames and JR joints: the pre tile (RP = TI * JR rows over the TI
// input frames, PW columns: P and the taps' reads past it), the feat tile
// (RO rows: TO * JR padded to the warps' 32-row tiles, C' rounded up to 8
// columns), the epilogues' constants (NCONST rows of round4(C')), and the
// ring: each slot an x panel (RI rows: the input frames inside [0, T) times
// JR, padded; KP channels) and a weight panel of KP rows of C' columns (a
// narrower product's weight panels take more rows).
struct Layout {
  int TI, RP, PW, pp, RO, CW, pf, RI, pa, slot;
  size_t feat, cst, ring, bytes;
};

__host__ __device__ inline Layout layout(int T, int Cp, int P, int stride,
                                         int pad, int TO, int JR,
                                         int xsize) {
  Layout L;
  L.TI = (TO - 1) * stride + 2 * pad + 1;
  L.RP = L.TI * JR;
  L.PW = round_up(P + 7, 8);
  L.pp = pitch_a(L.PW * 4);
  L.RO = round_up(TO * JR, WARP_ROWS);
  L.CW = round_up(Cp, 8);
  L.pf = pitch_a(L.CW * 4);
  L.RI = round_up((L.TI < T ? L.TI : T) * JR, WARP_ROWS);
  L.pa = pitch_x(KP * xsize);
  L.slot = L.RI * L.pa + KP * pitch_b(L.CW * 4);
  L.feat = (size_t)L.RP * L.pp;
  L.cst = L.feat + (size_t)L.RO * L.pf;
  L.ring = L.cst + (size_t)NCONST * round_up(Cp, 4) * 4;
  L.bytes = L.ring + (size_t)STAGES * L.slot;
  return L;
}

// Folded, packed weights (ops/kernels/ms_tcn.py:pack_weights): wq = [w_pre
// | w11] (C, round4(C')); per conv branch its taps (3, round8(cb),
// round4(cb)); w_tc (C', round4(C')); consts (NCONST, round4(C')): bq =
// [b_pre | b11], the conv branches' biases at their columns, a_tr, b_tr,
// b_tc, a_out, b_out.  g: the pseudo-joint's feat rows (N, Tp, C'), null
// for MSTCN.
struct Params {
  const void *x;
  void *out;
  float *g;
  const float *wq, *taps, *w_tc, *consts, *coeff;
  int T, V, C, Cp, rem, mid, stride, Tp, pad, TO, JR;
  int dil[4];
};

template <bool MEAN, typename Tio> struct AType { using T = Tio; };
template <typename Tio> struct AType<true, Tio> { using T = float; };

// Columns of one pass of an R-row product: all of ncols where each warp's
// share fits its NT accumulator tiles, else NT tiles a warp column.
__device__ __forceinline__ int pass_width(int R, int ncols) {
  const int WC = WARPS / (R / WARP_ROWS);
  return (ncols + 7) / 8 <= NT * WC ? ncols : NT * 8 * WC;
}

// A streamed through the ring (a pw source): the block's x rows (input
// frame a + m / jr, joint v0 + m % jr; rows past `rows` repeat the last,
// their results are dropped), KP channels a panel at the slot's start,
// channels past C zero.
// MEAN: the one row of each frame is the joint mean of x, in float32.
// vec: x's rows 16-byte aligned (cp.async, or 16-byte loads for the mean).
template <typename Tio, bool MEAN> struct XPanels {
  using TA = typename AType<MEAN, Tio>::T;
  const Tio *x;  // the sample's (T, V, C)
  int C, V, v0, jr, a, rows, R, pa, boff;
  bool vec;

  __device__ void stage(unsigned char *dst, int kp, int p) const {
    const int k0 = p * kp;
    if (MEAN && vec) {
      // 16 bytes of channels a thread and eight joints' loads in flight,
      // each channel summed over the joints in order
      constexpr int PER = 16 / sizeof(Tio);
      const int q = kp / PER;
      for (int i = threadIdx.x; i < R * q; i += blockDim.x) {
        const int m = i / q, c = (i - m * q) * PER;
        float s[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e) s[e] = 0.f;
        if (k0 + c < C) {
          const uint4 *qv = (const uint4 *)(
              x + (size_t)(a + min(m, rows - 1)) * V * C + k0 + c);
          const size_t step = C / PER;
          for (int v = 0; v < V; v += 8) {
            uint4 u[8];
#pragma unroll
            for (int w = 0; w < 8; ++w)
              if (v + w < V) u[w] = __ldg(qv + (v + w) * step);
#pragma unroll
            for (int w = 0; w < 8; ++w)
              if (v + w < V) {
                const Tio *e8 = (const Tio *)&u[w];
#pragma unroll
                for (int e = 0; e < PER; ++e) s[e] += to_f32(e8[e]);
              }
          }
        }
        float *d = (float *)(dst + (size_t)m * pa) + c;
#pragma unroll
        for (int e = 0; e < PER; ++e) d[e] = s[e] / V;
      }
    } else if (MEAN) {
      for (int i = threadIdx.x; i < R * kp; i += blockDim.x) {
        const int m = i / kp, k = i - m * kp;
        float s = 0.f;
        if (k0 + k < C) {
          const Tio *q = x + (size_t)(a + min(m, rows - 1)) * V * C + k0 + k;
          for (int v = 0; v < V; ++v) s += to_f32(q[(size_t)v * C]);
          s /= V;
        }
        *(float *)(dst + (size_t)m * pa + k * 4) = s;
      }
    } else if (vec) {
      constexpr int PER = 16 / sizeof(Tio);
      const int q = kp / PER;
      for (int i = threadIdx.x; i < R * q; i += blockDim.x) {
        const int m = i / q, c = (i - m * q) * PER;
        const int mm = min(m, rows - 1), j = mm / jr;
        unsigned char *d = dst + (size_t)m * pa + c * sizeof(Tio);
        if (k0 + c < C)
          pw::cp_async16(d, x + ((size_t)(a + j) * V + v0 + mm - j * jr) * C +
                                k0 + c);
        else
          *(uint4 *)d = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int i = threadIdx.x; i < R * kp; i += blockDim.x) {
        const int m = i / kp, k = i - m * kp;
        const int mm = min(m, rows - 1), j = mm / jr;
        *(Tio *)(dst + (size_t)m * pa + k * sizeof(Tio)) =
            k0 + k < C
                ? x[((size_t)(a + j) * V + v0 + mm - j * jr) * C + k0 + k]
                : from_f32<Tio>(0.f);
      }
    }
  }

  template <int NT_, bool SA, bool SB, typename TB>
  __device__ void panel(float (&acc)[MT][NT_][4], const unsigned char *slot,
                        int, int ksteps, int pb, const WarpTile &wt) const {
    const TA *rows_[MT];
    int d[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      rows_[i] = (const TA *)(slot + (size_t)slot_row(wt, 2 * i) * pa);
      d[i] = 8 * pa;
    }
    pw::warp_panel<NT_, SA, SB, TA, TB>(acc, rows_, d, slot + boff, pb,
                                        ksteps, wt);
  }
};

// A resident in shared memory (a pw source: the pre or the feat tile,
// pitch floats a row): product row m < M (rows past M repeat row M - 1)
// reads tile row ((m / jr) * stride + off) * jr + m % jr from column col0;
// the depth comes in groups of `group` (a multiple of 8), group q's rows
// moved by q * gstep floats (a conv's taps).
struct TileRows : pw::Resident {
  const float *base[MT];  // slot 2 i's row, slot 2 i + 1's d[i] bytes on
  int d[MT];
  int group, gstep;

  __device__ TileRows(const float *tile, int pitch, int M, int jr,
                      int stride, int off, int col0, int group_, int gstep_,
                      const WarpTile &wt)
      : group(group_), gstep(gstep_) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      int row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(slot_row(wt, 2 * i + h), M - 1), j = m / jr;
        row[h] = (j * stride + off) * jr + m - j * jr;
      }
      base[i] = tile + (size_t)row[0] * pitch + col0;
      d[i] = (row[1] - row[0]) * pitch * (int)sizeof(float);
    }
  }

  template <int NT_, bool SA, bool SB, typename TB>
  __device__ void panel(float (&acc)[MT][NT_][4], const unsigned char *slot,
                        int k0, int ksteps, int pb, const WarpTile &wt) const {
    const int kend = k0 + 8 * ksteps;
    for (int k = k0; k < kend;) {
      const int q = k / group, kin = k - q * group;
      const int n8 = min(group - kin, kend - k) / 8;
      const float *rows_[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) rows_[i] = base[i] + q * gstep + kin;
      pw::warp_panel<NT_, SA, SB, float, TB>(acc, rows_, d,
                                             slot + (k - k0) * pb, pb, n8,
                                             wt);
      k += 8 * n8;
    }
  }
};

template <typename Tio, bool MEAN>
__global__ void __launch_bounds__(THREADS, 1)
ms_tcn_kernel(const __grid_constant__ Params p) {
  using TA = typename AType<MEAN, Tio>::T;
  constexpr bool SX = sizeof(TA) == 4;   // x needs the hi/lo split
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.z, t0 = blockIdx.x * p.TO, v0 = blockIdx.y * p.JR;
  const int jr = min(p.JR, p.V - v0), s = p.stride, pad = p.pad, T = p.T;
  const int TOe = min(p.TO, p.Tp - t0), M = TOe * jr;
  const int P = p.rem + 4 * p.mid, Cp = p.Cp, Cp4 = round_up(Cp, 4);
  const Layout L = layout(T, Cp, P, s, pad, p.TO, p.JR, sizeof(TA));
  // input frames [a, b] of the tile's [f_lo, f_hi], the rest zero
  const int f_lo = t0 * s - pad;
  const int a = max(f_lo, 0), b = min((t0 + TOe - 1) * s + pad, T - 1);
  const int rows_in = (b - a + 1) * jr;
  const int R_in = round_up(rows_in, WARP_ROWS);
  const int R_out = round_up(M, WARP_ROWS);
  float *pre = (float *)smem, *feat = (float *)(smem + L.feat);
  const float *cst = (const float *)(smem + L.cst);
  unsigned char *ring = smem + L.ring;
  const int ppf = L.pp / 4, pff = L.pf / 4;
  const float *bq = cst, *bias = cst + Cp4, *a_tr = cst + 2 * Cp4,
              *b_tr = cst + 3 * Cp4, *b_tc = cst + 4 * Cp4,
              *a_out = cst + 5 * Cp4, *b_out = cst + 6 * Cp4;
  float acc[MT][NT][4];

  // the constants and the first panels in flight (the first cp.async
  // group), the pre tile zeroed meanwhile
  for (int i = threadIdx.x; i < NCONST * Cp4 / 4; i += blockDim.x)
    pw::cp_async16(smem + L.cst + 16 * i, p.consts + 4 * i);
  const XPanels<Tio, MEAN> X{
      (const Tio *)p.x + (size_t)n * T * p.V * p.C, p.C, p.V, v0, jr, a,
      rows_in, R_in, L.pa, L.RI * L.pa,
      (p.C * sizeof(Tio)) % 16 == 0 && (uintptr_t)p.x % 16 == 0};
  const int xwidth = pass_width(R_in, Cp4);
  auto xw = [&](int n0) {
    const int nc = min(xwidth, Cp4 - n0);
    return Weights<float>(p.wq, Cp4, 0, p.C, n0, nc,
                          KP * pitch_b(round_up(nc, 8) * 4));
  };
  pw::ring_begin(ring, L.slot, xw(0), X);
  for (int i = threadIdx.x; i < (int)(L.feat / 16); i += blockDim.x)
    ((float4 *)pre)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the taps' weights: branch br at its offset, n0 its pass's first column
  const int widths[4] = {p.rem, p.mid, p.mid, p.mid};
  auto tw = [&](int br, int n0, int width) {
    const int cb = widths[br], cb8 = round_up(cb, 8), cb4 = round_up(cb, 4);
    const float *w = p.taps;
    if (br > 0)
      w += 3 * round_up(p.rem, 8) * round_up(p.rem, 4) +
           (br - 1) * 3 * round_up(p.mid, 8) * round_up(p.mid, 4);
    return Weights<float>(w, cb4, 0, 3 * cb8, n0, min(width, cb4 - n0),
                          L.slot);
  };
  const int twidth0 = pass_width(R_out, round_up(p.rem, 4));
  const int owidth = pass_width(R_out, Cp4);
  auto ow = [&](int n0) {
    return Weights<float>(p.w_tc, Cp4, 0, Cp, n0, min(owidth, Cp4 - n0),
                          L.slot);
  };

  // pre = relu(x w_pre + b_pre) into the pre tile and the strided 1x1
  // x w11 + b11 into the feat tile's last mid columns, one product over
  // [w_pre | w11]; the 1x1 kept on the rows of the tile's output frames
  for (int n0 = 0; n0 < Cp4; n0 += xwidth) {
    const Weights<float> W = xw(n0);
    const WarpTile wt = pw::warp_tile<true>(R_in, W.ncols);
    pw::zero(acc);
    pw::block_product<NT, SX, true>(acc, X, ring, L.slot, W, wt);
    if (n0 + xwidth < Cp4)
      pw::ring_begin(ring, L.slot, xw(n0 + xwidth), X);
    else
      pw::ring_begin(ring, L.slot, tw(0, 0, twidth0));
    int prow[2 * MT], frow[2 * MT];
#pragma unroll
    for (int ri = 0; ri < 2 * MT; ++ri) {
      const int m = slot_row(wt, ri), j = m / jr;
      const int rel = a + j - t0 * s;
      prow[ri] = m < rows_in ? (a - f_lo) * jr + m : -1;
      frow[ri] = m < rows_in && rel >= 0 && rel % s == 0 && rel / s < TOe
                     ? (rel / s) * jr + m - j * jr : -1;
    }
    pw::for_each(acc, wt, [&](int ri, int, int c, float y0, float y1) {
      const float y[2] = {y0, y1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = n0 + c + e;
        if (cc < P) {
          if (prow[ri] >= 0)
            pre[(size_t)prow[ri] * ppf + cc] = fmaxf(y[e] + bq[cc], 0.f);
        } else if (cc < Cp && frow[ri] >= 0) {
          feat[(size_t)frow[ri] * pff + cc] = y[e] + bq[cc];
        }
      }
    });
  }

  // the four conv branches: each one product of depth 3 cb8 over the pre
  // tile, tap q's rows q * d frames on (its first barrier orders the pre
  // tile's stores before its reads)
  int slot = 0;
  for (int br = 0; br < 4; ++br) {
    const int cb = widths[br], cb4 = round_up(cb, 4), d = p.dil[br];
    const int width = pass_width(R_out, cb4);
    for (int n0 = 0; n0 < cb4; n0 += width) {
      const Weights<float> W = tw(br, n0, width);
      const WarpTile wt = pw::warp_tile<true>(R_out, W.ncols);
      const TileRows A(pre, ppf, M, jr, s, pad - d, slot, round_up(cb, 8),
                       d * jr * ppf, wt);
      pw::zero(acc);
      pw::block_product<NT, true, true>(acc, A, ring, L.slot, W, wt);
      if (n0 + width < cb4)
        pw::ring_begin(ring, L.slot, tw(br, n0 + width, width));
      else if (br < 3)
        pw::ring_begin(ring, L.slot, tw(br + 1, 0, pass_width(
            R_out, round_up(widths[br + 1], 4))));
      else if (!MEAN)
        pw::ring_begin(ring, L.slot, ow(0));
      pw::for_each(acc, wt, [&](int, int m, int c, float y0, float y1) {
        if (m >= M) return;
        const float y[2] = {y0, y1};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = n0 + c + e;
          if (cc < cb)
            feat[(size_t)m * pff + slot + cc] = y[e] + bias[slot + cc];
        }
      });
    }
    slot += cb;
  }

  // branch 4: maxpool 3, pad 1, on CUDA cores (pre >= 0: the zero frames
  // stand in for -inf)
  for (int i = threadIdx.x; i < M * p.mid; i += blockDim.x) {
    const int m = i / p.mid, c = i - m * p.mid, j = m / jr;
    const float *q =
        pre + (size_t)((j * s + pad - 1) * jr + m - j * jr) * ppf + slot + c;
    feat[(size_t)m * pff + slot + c] =
        fmaxf(fmaxf(q[0], q[(size_t)jr * ppf]), q[(size_t)2 * jr * ppf]);
  }
  __syncthreads();                       // feat complete

  if (MEAN) {                            // the pseudo-joint's rows
    for (int i = threadIdx.x; i < M * Cp; i += blockDim.x) {
      const int m = i / Cp, c = i - m * Cp;
      p.g[((size_t)n * p.Tp + t0 + m) * Cp + c] = feat[(size_t)m * pff + c];
    }
    return;
  }

  // the pseudo-joint's branch outputs onto every joint, the transform BN
  // and ReLU in place, a warp four rows at a time (their scratch rows'
  // loads in flight together); columns past C' zero (the transform's
  // depth padding)
  for (int m0 = (threadIdx.x >> 5) * 4; m0 < M; m0 += 4 * WARPS) {
    const float *gr[4];
    float cf[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = min(m0 + u, M - 1), j = m / jr;
      gr[u] = p.g == nullptr ? nullptr
                             : p.g + ((size_t)n * p.Tp + t0 + j) * Cp;
      cf[u] = p.g == nullptr ? 0.f : __ldg(p.coeff + v0 + m - j * jr);
    }
    for (int c = threadIdx.x & 31; c < L.CW; c += 32) {
      float add[4] = {0.f, 0.f, 0.f, 0.f};
      if (p.g != nullptr && c < Cp)
#pragma unroll
        for (int u = 0; u < 4; ++u) add[u] = cf[u] * __ldg(gr[u] + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (m0 + u >= M) break;
        float *f = feat + (size_t)(m0 + u) * pff + c;
        *f = c < Cp ? fmaxf((*f + add[u]) * a_tr[c] + b_tr[c], 0.f) : 0.f;
      }
    }
  }

  // transform 1x1 and the output BN, stored a pair of columns a lane: a
  // warp's store is 8 rows of 32 contiguous bytes (float32); its first
  // barrier orders the BN pass's stores before its reads
  Tio *out = (Tio *)p.out;
  const bool pairs = Cp % 2 == 0 && (uintptr_t)p.out % (2 * sizeof(Tio)) == 0;
  for (int n0 = 0; n0 < Cp4; n0 += owidth) {
    const Weights<float> W = ow(n0);
    const WarpTile wt = pw::warp_tile<true>(R_out, W.ncols);
    const TileRows A(feat, pff, M, jr, 1, 0, 0, 1 << 30, 0, wt);
    pw::zero(acc);
    pw::block_product<NT, true, true>(acc, A, ring, L.slot, W, wt);
    if (n0 + owidth < Cp4) pw::ring_begin(ring, L.slot, ow(n0 + owidth));
    Tio *orow[2 * MT];
#pragma unroll
    for (int ri = 0; ri < 2 * MT; ++ri) {
      const int m = slot_row(wt, ri), j = m / jr;
      orow[ri] = m < M ? out + (((size_t)n * p.Tp + t0 + j) * p.V + v0 + m -
                                j * jr) * Cp
                       : nullptr;
    }
    pw::for_each(acc, wt, [&](int ri, int, int c, float y0, float y1) {
      const int o = n0 + c;
      if (orow[ri] == nullptr || o >= Cp) return;
      float y[2] = {y0, y1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int oe = o + e < Cp ? o + e : o;
        y[e] = (y[e] + b_tc[oe]) * a_out[oe] + b_out[oe];
      }
      if (pairs) {
        pw::store_pair(orow[ri] + o, y[0], y[1]);
      } else {
        orow[ri][o] = from_f32<Tio>(y[0]);
        if (o + 1 < Cp) orow[ri][o + 1] = from_f32<Tio>(y[1]);
      }
    });
  }
}

// Plans the kernel does not take, shared memory aside: the planner
// (ops/kernels/ms_tcn.py:tile_plan) refuses them first.
inline bool refuse(const Layout &L) {
  return L.RI > MAX_ROWS || L.RO > MAX_ROWS;
}

template <typename Tio, bool MEAN>
static int launch(const Params &p, int N, cudaStream_t stream) {
  using TA = typename AType<MEAN, Tio>::T;
  const Layout L = layout(p.T, p.Cp, p.rem + 4 * p.mid, p.stride, p.pad,
                          p.TO, p.JR, sizeof(TA));
  if (refuse(L) || L.bytes > pw::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kernel = ms_tcn_kernel<Tio, MEAN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Tp + p.TO - 1) / p.TO,
                  MEAN ? 1 : (p.V + p.JR - 1) / p.JR, N);
  kernel<<<grid, THREADS, L.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The pseudo-joint's rows first (a plan of TOg frames and one row a
// frame), then the joints.
template <typename Tio>
static int launch_all(const Params &p, int N, int TOg, cudaStream_t stream) {
  if (p.g != nullptr) {
    Params q = p;
    q.TO = TOg;
    q.JR = 1;
    const int err = launch<Tio, true>(q, N, stream);
    if (err != 0) return err;
  }
  return launch<Tio, false>(p, N, stream);
}

}  // namespace ms
}  // namespace dsgcn

// C interface, bound with ctypes (ops/kernels/_build.py).  The weights are
// packed as Params says (16-byte aligned); g null for MSTCN (coeff null
// too), else an (N, Tp, C') float32 scratch for the pseudo-joint's rows.
// (TO, JR): the main blocks' output frames and joints; TOg: the
// pseudo-joint blocks' frames.
// Returns a cudaError_t; the caller has checked shapes, types and devices.
extern "C" int dsgcn_ms_tcn(const void *x, void *out, int bf16, float *g,
                            const float *wq, const float *taps,
                            const float *w_tc, const float *consts,
                            const float *coeff, int N, int T, int V, int C,
                            int Cp, int rem, int mid, int d0, int d1, int d2,
                            int d3, int stride, int TO, int JR, int TOg,
                            void *stream) {
  using namespace dsgcn::ms;
  const int dil[4] = {d0, d1, d2, d3};
  int pad = 0;
  for (int d : dil) {
    if (d < 1) return (int)cudaErrorInvalidValue;
    pad = d > pad ? d : pad;
  }
  const int Tp = T < 1 || stride < 1 ? 0 : (T + stride - 1) / stride;
  if (N < 1 || N > 65535 || T < 1 || V < 1 || C < 1 || mid < 1 ||
      rem < mid || Cp != rem + 5 * mid || stride < 1 || TO < 1 || TO > Tp ||
      JR < 1 || JR > V || (V + JR - 1) / JR > 65535 ||
      (coeff != nullptr) != (g != nullptr) || (g != nullptr && (TOg < 1 ||
                                                             TOg > Tp)))
    return (int)cudaErrorInvalidValue;
  Params p{x,  out, g,      wq,  taps, w_tc, consts, coeff,
           T,  V,   C,      Cp,  rem,  mid,  stride, Tp,
           pad, TO, JR,     {d0, d1, d2, d3}};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_all<__nv_bfloat16>(p, N, TOg, st)
              : launch_all<float>(p, N, TOg, st);
}

extern "C" const char *dsgcn_ms_tcn_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The block a plan launches: its threads and shared-memory bytes (which
// the kernel refuses over SMEM_LIMIT), and 0 where it refuses the plan for
// another reason (over MAX_ROWS rows a product).  The planner's model
// (ops/kernels/ms_tcn.py:tile_smem) is held to it.
extern "C" void dsgcn_ms_tcn_geometry(int T, int Cp, int rem, int mid,
                                      int stride, int pad, int TO, int JR,
                                      int xsize, int *threads, int *smem) {
  using namespace dsgcn::ms;
  const Layout L = layout(T, Cp, rem + 4 * mid, stride, pad, TO, JR, xsize);
  *threads = THREADS;
  *smem = refuse(L) ? 0 : (int)L.bytes;
}
