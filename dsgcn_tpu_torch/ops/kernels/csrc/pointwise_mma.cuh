// Pointwise (1x1) products over a tile of joint rows on Hopper's tensor
// cores, shared by K5 (dyn_graph_eval.cu), K6 (dggcn_block.cu) and K7
// (ms_tcn.cu):
//
//   acc[r, n] += sum_k A[r, k] W[k0 + k, n0 + n]
//
// A comes from a source (Tile below, or K7's own): K5's and K6's is a tile
// of whole frames of one sample staged once in shared memory (the x tile,
// or K6's y chunk), its rows padded to the warps' 32-row tiles; a source
// gives a warp's A rows by address, so a strided or shifted view of a
// staged tile needs no copy, and may stream its own part of each ring
// slot.  W is a row-major weight matrix in device memory whose panels
// stream through a STAGES-deep ring of 16-byte cp.async copies.  A ring
// slot holds KP rows of PANEL_WIDTH columns or more; a narrower product
// takes as many more rows a panel as fit, so that each barrier of the
// ring is worth a few dozen MMAs a warp.
// The block's warps form a WR x WC grid over the product: warp (wr, wc)
// holds rows [32 wr, 32 wr + 32) and up to NT n8 tiles of the columns as
// mma.sync m16n8k8 TF32 accumulators in registers.
//
// Precision.  TF32 keeps 11 significant bits.  A float32 operand is split
// into hi, its top 11 bits rounded (an integer add and a mask), and
// lo = a - hi (exact; the tensor core keeps its top 11 bits), and a
// product is summed as lo_a hi_b + hi_a lo_b + hi_a hi_b ("3xTF32": each
// product within about 2^-20 of float32's, against the 1e-4 the kernels are
// held to).  A bfloat16 operand is exact in TF32 and has no lo part: two
// terms where one operand is bfloat16, one where both are.
//
// Bank layout.  An A row pitch of 16 mod 128 bytes puts the 8 rows x 4
// columns a fragment load touches on distinct banks (float32) or distinct
// words (bfloat16); a B pitch of 32 mod 128 bytes does the same for the
// 4 rows x 8 columns of a B fragment.  Both keep rows 16-byte aligned.
//
// The geometry (threads, panel depth, ring stages) comes from the build:
// ops/kernels/_build.py defines it, for these kernels as -D flags and for
// the wrappers' planners.
#pragma once

#include <stdint.h>

#include "graph_agg_tiled.cuh"

namespace dsgcn {
namespace pw {

#if !defined(DSGCN_PW_THREADS) || !defined(DSGCN_PW_KP) || \
    !defined(DSGCN_PW_STAGES) || !defined(DSGCN_PW_PANEL_WIDTH) || \
    !defined(DSGCN_PW_WARP_ROWS)
#error "the block geometry is defined by ops/kernels/_build.py (-D flags)"
#endif
constexpr int THREADS = DSGCN_PW_THREADS;  // threads of a block
constexpr int WARPS = THREADS / 32;
constexpr int KP = DSGCN_PW_KP;            // least depth of a weight panel
constexpr int PANEL_WIDTH = DSGCN_PW_PANEL_WIDTH;  // least width a slot
constexpr int STAGES = DSGCN_PW_STAGES;    // weight panels in the ring
constexpr int WARP_ROWS = DSGCN_PW_WARP_ROWS;  // rows of a warp's tile
constexpr int MT = WARP_ROWS / 16;             // its m16 tiles
constexpr size_t SMEM_LIMIT = 232448;
static_assert(KP % 8 == 0, "a panel holds whole k8 steps");
static_assert(WARP_ROWS % 16 == 0, "a warp holds whole m16 tiles");

using tiled::cp_async16;
using tiled::cp_async_commit;
using tiled::cp_async_wait;

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// the smallest row pitch >= bytes that is 16 (A) or 32 (B) mod 128
__host__ __device__ inline int pitch_a(int bytes) {
  return (bytes + 111) / 128 * 128 + 16;
}
__host__ __device__ inline int pitch_b(int bytes) {
  return (bytes + 95) / 128 * 128 + 32;
}
// Row pitch (floats) of a staged pre chunk, a channel a row: room for 31
// floats past the tile's R rows (the aggregation reads up to 31 past
// them), odd (the aggregation's lanes on consecutive channels hit
// distinct banks) and 5 mod 32 (a warp's epilogue stores, 8 rows x 4
// column pairs, at most 2-way conflicted); R is a multiple of 32.
__host__ __device__ inline int pre_pitch(int R) { return R + 37; }
// bytes of a ring slot: KP rows as wide as the widest panel, and at least
// PANEL_WIDTH columns
__host__ __device__ inline int slot_bytes(int widest, int esize) {
  return KP * pitch_b(round_up(widest > PANEL_WIDTH ? widest : PANEL_WIDTH,
                               8) * esize);
}

// The rows of the tile a warp takes and its n8 tiles of an ncols-wide
// product: rows [row0, row0 + 32), tiles [col0 / 8, col0 / 8 + nt).
struct WarpTile {
  int row0, col0, nt;
};

// The warps form a WR x WC grid over R rows (WR = R / 32).  IDLE: WR
// need not divide the warps, and those past WR * WC idle (nt = 0); K5's
// and K6's R is 32 times a power of two.
template <bool IDLE = false>
__device__ __forceinline__ WarpTile warp_tile(int R, int ncols) {
  const int warp = threadIdx.x >> 5, WR = R / WARP_ROWS, WC = WARPS / WR;
  const int wr = warp / WC, wc = warp % WC;
  const int tiles = (ncols + 7) / 8, per = (tiles + WC - 1) / WC;
  const int nt = !IDLE || wr < WR ? min(per, max(0, tiles - wc * per)) : 0;
  return {wr * WARP_ROWS, wc * per * 8, nt};
}

// The row of the warp's tile whose entries this lane holds in fragment
// slot ri = 2 i + h: row0 + 16 i + g + 8 h (g = lane / 4).
__device__ __forceinline__ int slot_row(const WarpTile &wt, int ri) {
  return wt.row0 + (ri >> 1) * 16 + ((threadIdx.x & 31) >> 2) + 8 * (ri & 1);
}

// n8 tiles a warp holds for an ncols-wide product over R rows (the
// planner's count: csrc and ops/kernels agree on it).
__host__ __device__ inline int tiles_per_warp(int R, int ncols) {
  const int WC = WARPS / (R / WARP_ROWS);
  return ((ncols + 7) / 8 + WC - 1) / WC;
}

// hi/lo of a float32 operand (SPLIT), or the exact TF32 bits of a value
// that came from bfloat16 (lo unused).  Two integer operations and a
// subtraction: cvt.rna.tf32 is emulated on this card and costs several
// times more.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t &hi, uint32_t &lo) {
  if (SPLIT) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT_, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT_][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT_; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// (row, column) of the items threadIdx.x, threadIdx.x + blockDim.x, ... of
// a walk over rows of q items, stepped without a division an item.
struct Walk {
  int r, c, dr, dc, q;
  __device__ explicit Walk(int q_) : q(q_) {
    r = threadIdx.x / q;
    c = threadIdx.x - r * q;
    dr = blockDim.x / q;
    dc = blockDim.x - dr * q;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= q) {
      c -= q;
      ++r;
    }
  }
};

// Rows [0, nrows) of a row-major (., cols) matrix at src into shared
// memory at dst (pitch bytes a row), columns [cols, cols_pad) zero: 16-byte
// cp.async copies where the rows are 16-byte aligned (vec), else element by
// element.  The caller commits.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char *dst, int pitch,
                                           const T *src, int nrows, int cols,
                                           int cols_pad, bool vec) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    const int q = cols / PER;
    Walk it(q);
    for (int i = threadIdx.x; i < nrows * q; i += blockDim.x, it.next()) {
      const int c = it.c * PER;
      cp_async16(dst + (size_t)it.r * pitch + c * sizeof(T),
                 src + (size_t)it.r * cols + c);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * cols; i += blockDim.x) {
      const int r = i / cols, c = i % cols;
      *(T *)(dst + (size_t)r * pitch + c * sizeof(T)) =
          src[(size_t)r * cols + c];
    }
  }
  const int pad = cols_pad - cols;
  for (int i = threadIdx.x; i < nrows * pad; i += blockDim.x)
    *(T *)(dst + (size_t)(i / pad) * pitch + (cols + i % pad) * sizeof(T)) =
        from_f32<T>(0.f);
}

// Zero rows [from, to) of a staged tile, columns [0, cols) (pitch bytes a
// row).
template <typename T>
__device__ __forceinline__ void zero_rows(unsigned char *dst, int pitch,
                                          int from, int to, int cols) {
  for (int i = threadIdx.x; i < (to - from) * cols; i += blockDim.x)
    *(T *)(dst + (size_t)(from + i / cols) * pitch + (i % cols) * sizeof(T)) =
        from_f32<T>(0.f);
}

// The B operand of one product: rows [k0, k_end) and columns [n0, n0 +
// ncols) of the row-major weight matrix w (row stride ldw).  Panels are
// kp rows (as many whole k8 steps as a slot of ``slot`` bytes holds, no
// more than the depth needs) of ncols rounded up to 8 columns, rows at or
// past k_end and the padding columns zero.
template <typename T>
struct Weights {
  const T *w;
  int ldw, k0, k_end, n0, ncols;
  int pitch;  // bytes a panel row in the ring
  int kp;     // rows a panel
  bool vec;   // 16-byte copies

  __device__ Weights(const T *w_, int ldw_, int k0_, int k_end_, int n0_,
                     int ncols_, int slot)
      : w(w_), ldw(ldw_), k0(k0_), k_end(k_end_), n0(n0_), ncols(ncols_) {
    pitch = pitch_b(round_up(ncols, 8) * (int)sizeof(T));
    kp = min(slot / pitch / 8 * 8, round_up(k_end - k0, 8));
    vec = (ncols * sizeof(T)) % 16 == 0 && (n0 * sizeof(T)) % 16 == 0 &&
          (ldw * sizeof(T)) % 16 == 0 && (uintptr_t)w % 16 == 0;
  }
  __device__ int panels() const { return (k_end - k0 + kp - 1) / kp; }
};

template <typename T>
__device__ __forceinline__ void stage_panel(unsigned char *slot,
                                            const Weights<T> &W, int p) {
  const int kb = W.k0 + p * W.kp;
  if (W.vec) {
    constexpr int PER = 16 / sizeof(T);
    const int q = W.ncols / PER;
    Walk it(q);
    for (int i = threadIdx.x; i < W.kp * q; i += blockDim.x, it.next()) {
      const int r = it.r, c = it.c * PER;
      unsigned char *d = slot + r * W.pitch + c * sizeof(T);
      if (kb + r < W.k_end)
        cp_async16(d, W.w + (size_t)(kb + r) * W.ldw + W.n0 + c);
      else
        *(uint4 *)d = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < W.kp * W.ncols; i += blockDim.x) {
      const int r = i / W.ncols, c = i % W.ncols;
      *(T *)(slot + r * W.pitch + c * sizeof(T)) =
          kb + r < W.k_end ? W.w[(size_t)(kb + r) * W.ldw + W.n0 + c]
                           : from_f32<T>(0.f);
    }
  }
  const int pad = round_up(W.ncols, 8) - W.ncols;
  for (int i = threadIdx.x; i < W.kp * pad; i += blockDim.x)
    *(T *)(slot + (i / pad) * W.pitch + (W.ncols + i % pad) * sizeof(T)) =
        from_f32<T>(0.f);
}

// ksteps k8 steps of the warp's tile.  A rows by address: a[i] is the
// panel's first column in row slot_row(wt, 2 i), and row slot_row(wt,
// 2 i + 1) lies d[i] bytes from it (8 rows' pitch in a plain tile; any
// offset in a row map).  B from the weight panel at B (pb bytes a row).
template <int NT, bool SA, bool SB, typename TA, typename TB>
__device__ __forceinline__ void warp_panel(float (&acc)[MT][NT][4],
                                           const TA *const (&a)[MT],
                                           const int (&d)[MT],
                                           const unsigned char *B, int pb,
                                           int ksteps, const WarpTile &wt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const TA *r0 = a[i] + ks * 8 + t;
      const TA *r1 = (const TA *)((const unsigned char *)r0 + d[i]);
      split<SA>(to_f32(r0[0]), ah[i][0], al[i][0]);
      split<SA>(to_f32(r1[0]), ah[i][1], al[i][1]);
      split<SA>(to_f32(r0[4]), ah[i][2], al[i][2]);
      split<SA>(to_f32(r1[4]), ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < wt.nt) {
        const TB *b0 =
            (const TB *)(B + (ks * 8 + t) * pb) + wt.col0 + j * 8 + g;
        const TB *b1 = (const TB *)((const unsigned char *)b0 + 4 * pb);
        uint32_t bh0, bl0, bh1, bl1;
        split<SB>(to_f32(*b0), bh0, bl0);
        split<SB>(to_f32(*b1), bh1, bl1);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (SA) mma(acc[i][j], al[i], bh0, bh1);
          if (SB) mma(acc[i][j], ah[i], bl0, bl1);
          mma(acc[i][j], ah[i], bh0, bh1);
        }
      }
    }
  }
}

// Where a product's A comes from.  A source may stream its own part of
// each ring slot: stage(slot, kp, p) puts panel p's (kp rows of depth,
// uncommitted cp.async copies) at the slot's start, and the weight panel
// follows boff bytes on.  panel<NT, SA, SB, TB>(acc, slot, k0, ksteps,
// pb, wt) runs warp_panel over the depth [k0, k0 + 8 ksteps) of the
// product with the weight panel in that slot.  Resident: A held in shared
// memory, nothing streamed.
struct Resident {
  static constexpr int boff = 0;
  __device__ void stage(unsigned char *, int, int) const {}
};

// A tile in shared memory, row r at A + r pa bytes (K5's and K6's x tile,
// K6's y chunk).
template <typename TA> struct Tile : Resident {
  const unsigned char *A;
  int pa;
  __device__ Tile(const unsigned char *A_, int pa_) : A(A_), pa(pa_) {}

  template <int NT, bool SA, bool SB, typename TB>
  __device__ void panel(float (&acc)[MT][NT][4], const unsigned char *slot,
                        int k0, int ksteps, int pb,
                        const WarpTile &wt) const {
    const TA *a[MT];
    int d[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      a[i] = (const TA *)(A + (size_t)slot_row(wt, 2 * i) * pa) + k0;
      d[i] = 8 * pa;
    }
    warp_panel<NT, SA, SB, TA, TB>(acc, a, d, slot, pb, ksteps, wt);
  }
};

// Put the first STAGES - 1 panels of a product in flight (one cp.async
// group each), A's part of each slot first.  The ring must be free: the
// last product ended in a barrier.  Work that touches neither the ring nor
// cp.async groups may run between this and block_product.
template <typename T, class Src = Resident>
__device__ __forceinline__ void ring_begin(unsigned char *ring, int slot,
                                           const Weights<T> &W,
                                           const Src &A = Src()) {
  const int np = W.panels();
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < np) {
      A.stage(ring + p * slot, W.kp, p);
      stage_panel(ring + p * slot + A.boff, W, p);
    }
    cp_async_commit();
  }
}

// acc += A W over the product's depth, its panels through the ring (the
// first STAGES - 1 already in flight from ring_begin with the same A).  A
// must hold the depth rounded up to 8 columns, zero past the depth where
// the weights' zero rows meet it.  Ends in a barrier: A and the ring are
// free again.
template <int NT, bool SA, bool SB, class Src, typename TB>
__device__ __forceinline__ void block_product(float (&acc)[MT][NT][4],
                                              const Src &A,
                                              unsigned char *ring, int slot,
                                              const Weights<TB> &W,
                                              const WarpTile &wt) {
  const int np = W.panels();
  for (int p = 0; p < np; ++p) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = p + STAGES - 1;
    if (nx < np) {
      unsigned char *s = ring + (nx % STAGES) * slot;
      A.stage(s, W.kp, nx);
      stage_panel(s + A.boff, W, nx);
    }
    cp_async_commit();
    if (wt.nt > 0)
      A.template panel<NT, SA, SB, TB>(
          acc, ring + (p % STAGES) * slot, p * W.kp,
          min(W.kp, W.k_end - W.k0 - p * W.kp + 7) / 8, W.pitch, wt);
  }
  __syncthreads();
}

// Visit the accumulator entries of a warp's tile in pairs of columns:
// f(slot ri, row slot_row(wt, ri), column, value at column, value at
// column + 1).
template <int NT, typename F>
__device__ __forceinline__ void for_each(const float (&acc)[MT][NT][4],
                                         const WarpTile &wt, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < wt.nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          f(2 * i + h, wt.row0 + i * 16 + g + 8 * h, wt.col0 + j * 8 + 2 * t,
            acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// Two adjacent output columns in one store.
__device__ __forceinline__ void store_pair(float *p, float a, float b) {
  *(float2 *)p = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16 *p, float a,
                                           float b) {
  *(__nv_bfloat162 *)p = __floats2bfloat162_rn(a, b);
}

}  // namespace pw
}  // namespace dsgcn
