"""The eval multi-branch temporal conv region in one kernel (K7).

The port of ``dsgcn_tpu/ops/pallas/ms_tcn.py:fused_dgmstcn_eval`` for the
``DEFAULT_MS_CFG`` branches of ``MSTCN`` (STGCN++) and ``DGMSTCN``
(DG-STGCN, DS-GCN):

    xg   = x, with ``coeff`` plus the joint-mean pseudo-joint as row V
    pre  = relu(xg w_pre + b_pre)                   (P = rem + 4 mid columns)
    feat = [k=3 convs of pre's branches 0-3 at dilations d_i (pad d_i) + b_i
            | maxpool3 of pre's branch 4 | xg[::stride] w11 + b11]
    feat = feat[:V] + coeff * feat[V]               (with ``coeff`` only)
    out  = (relu(feat a_tr + b_tr) w_tc + b_tc) a_out + b_out

with every BatchNorm folded (``ops/tcn.py:fused_ms_eval``).  Each branch
reads and writes its own columns: branch 0 has rem, the others mid, and
branch i sits at the same offset in pre and in feat (C' = rem + 5 mid).
The TPU kernel multiplies shift-grouped, zero-embedded (P, C') matrices
(``pack_branches``); this kernel takes [w_pre | w11] as one matrix and
each branch's taps padded to whole k8 steps (:func:`pack_weights`), and
:func:`tile_plan` picks its blocks.

:func:`fused_dgmstcn_eval` calls the custom op ``dsgcn::ms_tcn``: on a
CUDA tensor the hand-written kernel ``csrc/ms_tcn.cu``, on a CPU tensor
the plain version :func:`reference_fused_dgmstcn_eval`.  Eval only.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build
from .dyn_graph import _round_up, pitch_a, pitch_b

# K7's products run on the pointwise block of K5 and K6 (csrc/
# pointwise_mma.cuh): PW_THREADS threads as a grid of 32-row warp tiles,
# at most this many rows a product; one block an SM
WARPS = _build.PW_THREADS // 32
MAX_ROWS = _build.PW_WARP_ROWS * WARPS
# the epilogues' constants a block stages: [b_pre | b11], the conv
# branches' biases, a_tr, b_tr, b_tc, a_out, b_out
NCONST = 7


def conv_out_len(T: int, stride: int) -> int:
    """Frames out of the region: k=3 pad=d, maxpool3 pad 1 and the strided
    1x1 all give ceil(T / stride) (``ms_tcn.py:_conv_out_len``)."""
    return -(-T // stride)


def _pitch_x(nbytes: int) -> int:
    """A streamed x panel's row pitch: 16 bytes times an odd number
    (``pitch_x``)."""
    return 16 * (-(-nbytes // 16) | 1)


def tile_layout(T: int, Cp: int, rem: int, mid: int, stride: int, pad: int,
                TO: int, JR: int, xsize: int):
    """(bytes, RI, RO) of a K7 block of TO output frames and JR joints
    (``csrc/ms_tcn.cu`` ``layout``): the pre tile over the TI input frames
    (P + 7 columns rounded to 8), the feat tile (TO*JR rows padded to the
    warps' 32-row tiles), the epilogues' constants, and the ring of x
    panels (RI rows: the input frames inside [0, T) times JR, padded)
    beside weight panels of C' columns."""
    KP, WR = _build.PW_KP, _build.PW_WARP_ROWS
    P, CW = rem + 4 * mid, _round_up(Cp, 8)
    TI = (TO - 1) * stride + 2 * pad + 1
    RO = _round_up(TO * JR, WR)
    RI = _round_up(min(TI, T) * JR, WR)
    slot = RI * _pitch_x(KP * xsize) + KP * pitch_b(CW * 4)
    nbytes = (TI * JR * pitch_a(_round_up(P + 7, 8) * 4) + RO * pitch_a(CW * 4)
              + NCONST * _round_up(Cp, 4) * 4 + _build.PW_STAGES * slot)
    return nbytes, RI, RO


def tile_smem(T: int, Cp: int, rem: int, mid: int, stride: int, pad: int,
              TO: int, JR: int, xsize: int) -> int:
    """Shared-memory bytes of a K7 block, 0 where the kernel refuses the
    plan (a product over MAX_ROWS rows).  The kernel's own count
    (``dsgcn_ms_tcn_geometry``) is held to it on the card."""
    nbytes, RI, RO = tile_layout(T, Cp, rem, mid, stride, pad, TO, JR, xsize)
    return 0 if max(RI, RO) > MAX_ROWS else nbytes


def _product_clk(R: int, depth: int, ncols: int, split_a: bool,
                 split_b: bool) -> float:
    """Clocks of an R-row product of a K7 block on tensor cores: the warps
    a grid of R / 32 row groups (those past it idle), each holding up to
    K7_TILES n8 tiles a pass; the larger of the MMAs, padding included, at
    _build.MMA_FLOP_CLK and the busy warps' instructions issued four a clock (a
    k8 step's fragment loads and hi/lo splits, once a pass for A, and the
    MMAs)."""
    warps, MT = WARPS, _build.PW_WARP_ROWS // 16
    WR = R // _build.PW_WARP_ROWS
    WC = warps // WR
    tiles = -(-ncols // 8)
    per = -(-tiles // WC)
    passes = -(-per // _build.K7_TILES)
    terms = 1 + int(split_a) + int(split_b)
    ksteps = -(-depth // 8)
    mma = 2.0 * R * ksteps * 8 * per * WC * 8 * terms / _build.MMA_FLOP_CLK
    per_step = (passes * 4 * MT * (1 + 3 * split_a)
                + per * (2 * (1 + 3 * split_b) + MT * terms))
    return max(mma, ksteps * WR * min(WC, tiles) * per_step / 4)


def _block_clk(T, V, C, Cp, rem, mid, stride, pad, TO, JR, xsize, mean):
    """Clocks of a K7 block with the full TO frames and JR joints: the
    x product over its input frames inside [0, T) (the halo's pre
    recomputed), the four branches' taps, the transform (none for the
    pseudo-joint's blocks), a weight panel's barrier each, the elementwise
    passes, and the bytes of x (the pseudo-joint's blocks read every
    joint) and of out."""
    KP, WR = _build.PW_KP, _build.PW_WARP_ROWS
    TI = (TO - 1) * stride + 2 * pad + 1
    RI, RO = _round_up(min(TI, T) * JR, WR), _round_up(TO * JR, WR)
    clk = _product_clk(RI, C, Cp, xsize == 4, True) + _build.CHUNK_CLK
    panels = -(-C // KP)
    for cb in (rem, mid, mid, mid):
        clk += _product_clk(RO, 3 * _round_up(cb, 8), cb, True, True)
        clk += _build.CHUNK_CLK
        panels += 1
    if not mean:
        clk += _product_clk(RO, Cp, Cp, True, True) + _build.CHUNK_CLK
        panels += -(-Cp // KP)
    clk += panels * _build.PANEL_CLK
    clk += 3 * TO * JR * _round_up(Cp, 8) / WARPS
    x_rows = min(TI, T) * (V if mean else JR)
    return clk + (x_rows * C + TO * JR * Cp) * xsize / _build.BYTES_CLK


@functools.lru_cache(maxsize=None)
def tile_plans(N: int, T: int, V: int, C: int, rem: int, mid: int,
               stride: int, pad: int, xsize: int, mean: bool = False):
    """Every (TO, JR) that fits, cheapest first: the output frames and
    joints of a K7 block (``mean``: the pseudo-joint's blocks, one row a
    frame, JR = 1).

    Each tile recomputes pre on its halo (pad input frames on each side
    inside [0, T)), so short tiles repeat work, while long tiles of many
    joints outgrow shared memory (the float32 pre and feat tiles) and leave
    fewer blocks for the 132 SMs; the rows of a product are padded to the
    warps' 32-row tiles.  The cost is the blocks the busiest SM runs (one
    at a time) times a block's clocks (``_block_clk``); each frame and
    joint count is tried at the tile size that splits it most evenly.  Ties
    go to fewer blocks.  Raises, naming the limit, where no plan fits."""
    Cp, Tp = rem + 5 * mid, conv_out_len(T, stride)
    Vr = 1 if mean else V
    ranked, least = [], None
    for JR in sorted({-(-Vr // k) for k in range(1, Vr + 1)}):
        for TO in sorted({-(-Tp // k) for k in range(1, Tp + 1)}):
            smem = tile_smem(T, Cp, rem, mid, stride, pad, TO, JR,
                             4 if mean else xsize)
            if smem == 0 or smem > _build.BLOCK_SMEM:
                if smem:
                    least = smem if least is None else min(least, smem)
                continue
            blocks = N * -(-Tp // TO) * -(-Vr // JR)
            clk = _block_clk(T, V, C, Cp, rem, mid, stride, pad, TO, JR,
                             4 if mean else xsize, mean)
            ranked.append(((-(-blocks // _build.SMS) * clk, blocks),
                           (TO, JR)))
    if not ranked:
        raise ValueError(
            f"fused_dgmstcn_eval: no tile plan for C' = {Cp}, P = "
            f"{rem + 4 * mid}: the smallest block needs {least} bytes of "
            f"shared memory, over the {_build.BLOCK_SMEM} a block has")
    ranked.sort(key=lambda r: r[0])        # stable: equal costs in order
    return tuple(plan for _, plan in ranked)


def tile_plan(N: int, T: int, V: int, C: int, rem: int, mid: int,
              stride: int, pad: int, xsize: int, mean: bool = False):
    """(TO, JR): the cheapest of :func:`tile_plans`."""
    return tile_plans(N, T, V, C, rem, mid, stride, pad, xsize, mean)[0]


def pack_weights(w_pre, b_pre, taps_w, taps_b, w11, b11, a_tr, b_tr, w_tc,
                 b_tc, a_out, b_out):
    """The kernel's weight layout (``csrc/ms_tcn.cu`` Params): wq = [w_pre |
    w11] (C, round4(C')), one product for pre and the strided 1x1; each
    conv branch's taps (3, round8(cb), round4(cb)), a tap's depth padded
    to whole k8 steps, one after another; w_tc (C', round4(C')); and the
    NCONST vectors of the epilogues as one (NCONST, round4(C')) tensor: bq
    = [b_pre | b11], the conv branches' biases at their columns, a_tr,
    b_tr, b_tc, a_out, b_out.  Zero columns keep every row 16-byte
    aligned; the TPU kernel's zero-embedded (P, C') tap and maxpool blocks
    are not built."""
    Cp = w_tc.shape[-1]
    Cp4 = _round_up(Cp, 4)

    def pad(w, rows, cols):
        return F.pad(w, (0, cols - w.shape[-1], 0, rows - w.shape[-2]))
    bias = torch.cat(list(taps_b) + [b11.new_zeros(Cp - sum(
        b.shape[0] for b in taps_b))])
    return dict(
        wq=pad(torch.cat([w_pre, w11], 1), w_pre.shape[0], Cp4).contiguous(),
        taps=torch.cat([pad(w, _round_up(w.shape[-1], 8),
                            _round_up(w.shape[-1], 4)).reshape(-1)
                        for w in taps_w]),
        w_tc=pad(w_tc, Cp, Cp4).contiguous(),
        consts=F.pad(torch.stack([torch.cat([b_pre, b11]), bias, a_tr, b_tr,
                                  b_tc, a_out, b_out]),
                     (0, Cp4 - Cp)).contiguous())


def reference_fused_dgmstcn_eval(x, w_pre, b_pre, taps_w, taps_b, w11, b11,
                                 a_tr, b_tr, w_tc, b_tc, a_out, b_out,
                                 coeff=None, *, dilations=(1, 2, 3, 4),
                                 stride=1):
    """Plain PyTorch version of K7, the TPU kernel's arithmetic: x lifted to
    float32, everything in float32, the output rounded to x's type once."""
    N, T, V, _ = x.shape
    Tp, pad = conv_out_len(T, stride), max(dilations)
    rem, mid = taps_w[0].shape[-1], w11.shape[-1]
    xg = x.float()
    if coeff is not None:
        xg = torch.cat([xg, xg.mean(2, keepdim=True)], 2)
    pre = torch.relu(xg @ w_pre.float() + b_pre.float())
    pp = F.pad(pre, (0, 0, 0, 0, pad, pad))         # zero frames around T

    def rows(a, start):                              # Tp frames, stride apart
        return a[:, start:start + stride * (Tp - 1) + 1:stride]

    outs, slot = [], 0
    for w, b, d in zip(taps_w, taps_b, dilations):
        cb = w.shape[-1]
        y = b.float()
        for j in range(3):
            y = y + rows(pp, pad - d + j * d)[..., slot:slot + cb] \
                @ w[j].float()
        outs.append(y)
        slot += cb
    m = rows(pp, pad - 1)[..., slot:slot + mid]      # maxpool3, pad 1
    for j in (1, 2):
        m = torch.maximum(m, rows(pp, pad - 1 + j)[..., slot:slot + mid])
    outs.append(m)
    outs.append(rows(xg, 0) @ w11.float() + b11.float())
    feat = torch.cat(outs, -1)
    if coeff is not None:
        feat = feat[:, :, :V] + feat[:, :, V:] * coeff.float()[:, None]
    feat = torch.relu(feat * a_tr.float() + b_tr.float())
    feat = feat @ w_tc.float() + b_tc.float()
    return (feat * a_out.float() + b_out.float()).to(x.dtype)


def fused_dgmstcn_eval(x: torch.Tensor, w_pre: torch.Tensor,
                       b_pre: torch.Tensor, taps_w: Sequence[torch.Tensor],
                       taps_b: Sequence[torch.Tensor], w11: torch.Tensor,
                       b11: torch.Tensor, a_tr: torch.Tensor,
                       b_tr: torch.Tensor, w_tc: torch.Tensor,
                       b_tc: torch.Tensor, a_out: torch.Tensor,
                       b_out: torch.Tensor,
                       coeff: Optional[torch.Tensor] = None, *,
                       dilations: Sequence[int] = (1, 2, 3, 4),
                       stride: int = 1) -> torch.Tensor:
    """The eval MSTCN (``coeff=None``) or DGMSTCN region of one block.

    x: (N, T, V, C) float32 or bfloat16.  w_pre (C, P), b_pre (P,): the
    five branch pre 1x1s with their BatchNorms folded, branch 0's rem
    columns first; taps_w: the four conv branches' (3, cb, cb) (tap, in,
    out) weights, taps_b their (cb,) biases, at ``dilations``; w11 (C, mid)
    and b11 (mid,): the strided 1x1 branch; a_tr, b_tr (C',): the transform
    BN; w_tc (C', C'), b_tc (C',): the transform 1x1; a_out, b_out (C',):
    the output BN; coeff (V,) or None.  Returns (N, ceil(T / stride), V,
    C') in x's dtype.  The custom op ``dsgcn::ms_tcn``."""
    if x.device.type != "cpu":
        _build.refuse_grad("fused_dgmstcn_eval", x, w_pre, b_pre, *taps_w,
                           *taps_b, w11, b11, a_tr, b_tr, w_tc, b_tc, a_out,
                           b_out, coeff)
    return ms_tcn_op(x, w_pre, b_pre, list(taps_w), list(taps_b), w11, b11,
                     a_tr, b_tr, w_tc, b_tc, a_out, b_out, coeff,
                     [int(d) for d in dilations], stride)


def _k7_plain(x, w_pre, b_pre, taps_w, taps_b, w11, b11, a_tr, b_tr, w_tc,
              b_tc, a_out, b_out, coeff, dilations, stride):
    return reference_fused_dgmstcn_eval(
        x, w_pre, b_pre, taps_w, taps_b, w11, b11, a_tr, b_tr, w_tc, b_tc,
        a_out, b_out, coeff, dilations=dilations,
        stride=stride).contiguous()


def _k7_kernel(x, w_pre, b_pre, taps_w, taps_b, w11, b11, a_tr, b_tr, w_tc,
               b_tc, a_out, b_out, coeff, dilations, stride):
    dilations = tuple(dilations)
    name = "fused_dgmstcn_eval"
    _build.check_activation(x, name)
    N, T, V, C = x.shape
    if len(taps_w) != 4 or len(taps_b) != 4 or len(dilations) != 4:
        raise ValueError(f"{name}: four conv branches (DEFAULT_MS_CFG), "
                         f"got {len(taps_w)} weights, {len(taps_b)} biases "
                         f"and dilations {dilations}")
    if min(dilations) < 1 or stride < 1:
        raise ValueError(f"{name}: dilations {dilations}, stride {stride}")
    if N > _build.MAX_SAMPLES:
        raise ValueError(f"{name}: batch {N} over {_build.MAX_SAMPLES}; "
                         "split it")
    rem, mid = taps_w[0].shape[-1], w11.shape[-1]
    P, Cp, dev = rem + 4 * mid, rem + 5 * mid, x.device
    if rem < mid:
        raise ValueError(f"{name}: branch 0 has {rem} channels, fewer than "
                         f"the others' {mid}")
    Tp, pad = conv_out_len(T, stride), max(dilations)
    op = lambda t, shape, n: _build.graph_operand(t, shape, n, dev)  # noqa
    widths = [rem, mid, mid, mid]
    packed = pack_weights(
        op(w_pre, (C, P), "w_pre"), op(b_pre, (P,), "b_pre"),
        [op(w, (3, cb, cb), f"taps_w[{i}]")
         for i, (w, cb) in enumerate(zip(taps_w, widths))],
        [op(b, (cb,), f"taps_b[{i}]")
         for i, (b, cb) in enumerate(zip(taps_b, widths))],
        op(w11, (C, mid), "w11"), op(b11, (mid,), "b11"),
        op(a_tr, (Cp,), "a_tr"), op(b_tr, (Cp,), "b_tr"),
        op(w_tc, (Cp, Cp), "w_tc"), op(b_tc, (Cp,), "b_tc"),
        op(a_out, (Cp,), "a_out"), op(b_out, (Cp,), "b_out"))
    ops = [packed[k] for k in ("wq", "taps", "w_tc", "consts")] + [
        None if coeff is None else op(coeff, (V,), "coeff")]
    out = torch.empty((N, Tp, V, Cp), device=dev, dtype=x.dtype)
    if out.numel() == 0:
        return out
    # the plans before any launch: a size that no block fits is refused
    TO, JR = tile_plan(N, T, V, C, rem, mid, stride, pad, x.element_size())
    TOg = (None if coeff is None else
           tile_plan(N, T, V, C, rem, mid, stride, pad, 4, mean=True)[0])
    # the pseudo-joint's branch outputs, once per (sample, output frame)
    g = (None if coeff is None else
         torch.empty((N, Tp, Cp), device=dev, dtype=torch.float32))
    ptr = _build.ptr
    with torch.cuda.device(dev):
        _build.launch(
            "ms_tcn", ptr(x), ptr(out), int(x.dtype == torch.bfloat16),
            ptr(g), *(ptr(t) for t in ops), N, T, V, C, Cp, rem, mid,
            *dilations, stride, TO, JR, TOg or 0, _build.stream_of(x))
    fused_dgmstcn_eval.launches += 1
    return out




def _k7_fake(x, w_pre, b_pre, taps_w, taps_b, w11, b11, a_tr, b_tr, w_tc,
             b_tc, a_out, b_out, coeff, dilations, stride):
    N, T, V, _ = x.shape
    return x.new_empty((N, conv_out_len(T, stride), V, w_tc.shape[-1]))


ms_tcn_op = _build.custom_op(
    "ms_tcn", "(Tensor x, Tensor w_pre, Tensor b_pre, Tensor[] taps_w, "
    "Tensor[] taps_b, Tensor w11, Tensor b11, Tensor a_tr, Tensor b_tr, "
    "Tensor w_tc, Tensor b_tc, Tensor a_out, Tensor b_out, Tensor? coeff, "
    "int[] dilations, int stride) -> Tensor", _k7_plain, _k7_kernel,
    _k7_fake)
fused_dgmstcn_eval.launches = 0
