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
(``pack_branches``); this kernel takes the per-branch weights, padded only
to multiples of 4 (:func:`pack_weights`).

On a CUDA tensor :func:`fused_dgmstcn_eval` launches the hand-written
kernel ``csrc/ms_tcn.cu``; on a CPU tensor it runs the plain version
:func:`reference_fused_dgmstcn_eval`.  Eval only.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

# csrc/ms_tcn.cu: a block's shared memory and its warps
_SMEM_LIMIT = 232448
_WARPS, _TILE_ROWS, _TILE_COLS = 8, 128, 4
_MIN_BLOCKS = 2 * 132     # two blocks per SM of the H100


def conv_out_len(T: int, stride: int) -> int:
    """Frames out of the region: k=3 pad=d, maxpool3 pad 1 and the strided
    1x1 all give ceil(T / stride) (``ms_tcn.py:_conv_out_len``)."""
    return -(-T // stride)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _row_words(n: int) -> int:
    """A shared-memory row of n floats: an odd number of 16-byte words
    (csrc/ms_tcn.cu row_words)."""
    return 4 * ((_round4(n) // 4) | 1)


def smem_bytes(TO: int, R: int, stride: int, pad: int, Cp: int,
               rem: int) -> int:
    """A block's shared memory (csrc/ms_tcn.cu smem_bytes): the (TO*R, C')
    feat tile and one branch's pre on the TI input frames."""
    TI = (TO - 1) * stride + 2 * pad + 1
    return 4 * (TO * R * _row_words(Cp) + TI * R * _row_words(rem))


def _warp_steps(M: int, NC: int, K: int) -> int:
    """Time of one product in a block: rounds of 128 x 4 warp tiles over
    the block's warps, K steps each."""
    tiles = -(-M // _TILE_ROWS) * -(-NC // _TILE_COLS)
    return -(-tiles // _WARPS) * K


@functools.lru_cache(maxsize=None)
def tile_plan(N: int, T: int, V: int, C: int, rem: int, mid: int,
              stride: int, pad: int, global_joint: bool):
    """(TO, JR): the output frames and joints of a block.  The cheapest of
    every pair whose tiles fit shared memory, by a count of the kernel's
    warp steps over all blocks: it charges the halo's recomputed pre, the
    pseudo-joint row that each joint group recomputes and the idle lanes
    of ragged tiles, grids of fewer than two blocks an SM, and double a
    block that takes more than half an SM's shared memory (alone on its
    SM, its 8 warps hide the loads' latency poorly; on the H100 such plans
    ran slower than two-block plans with more recompute)."""
    Cp, Tp = rem + 5 * mid, conv_out_len(T, stride)
    C, rem4, mid4 = _round4(C), _round4(rem), _round4(mid)
    g = int(global_joint)
    best = None
    for JR in range(1, V + 1):
        R = JR + g
        for TO in range(1, Tp + 1):
            smem = smem_bytes(TO, R, stride, pad, Cp, rem)
            if smem > _SMEM_LIMIT:
                break
            TI = (TO - 1) * stride + 2 * pad + 1
            steps = (_warp_steps(TO * R, mid, C)                    # 1x1
                     + _warp_steps(TI * R, rem4, C)                 # pre
                     + 4 * _warp_steps(TI * R, mid4, C)
                     + _warp_steps(TO * R, rem, 3 * rem4)           # taps
                     + 3 * _warp_steps(TO * R, mid, 3 * mid4)
                     + _warp_steps(TO * JR, Cp, _round4(Cp)))       # transform
            blocks = N * -(-Tp // TO) * -(-V // JR)
            cost = blocks * steps * max(1.0, _MIN_BLOCKS / blocks)
            if 2 * smem > _SMEM_LIMIT:
                cost *= 2
            if best is None or cost < best[0]:
                best = (cost, TO, JR)
    if best is None:
        raise ValueError(f"fused_dgmstcn_eval: one frame of C' = {Cp} "
                         "channels does not fit a block's shared memory")
    return best[1], best[2]


def pack_weights(w_pre, b_pre, taps_w, w11, w_tc, C4):
    """The kernel's weight layout (csrc/ms_tcn.cu Params): every matrix
    zero-padded to widths and depths that are multiples of 4, so that the
    kernel reads four columns (and four depths) at a time; per branch b,
    w_pre (C4, round4(cb)) and its b_pre one after another, the conv taps
    (3, round4(cb), round4(cb)), w11 (C4, round4(mid)), w_tc (round4(C'),
    round4(C')).  The padding is at most 3 rows and columns a matrix; the
    TPU kernel's zero-embedded (P, C') tap and maxpool blocks are not
    built."""
    def pad(w, rows, cols):
        return F.pad(w, (0, cols - w.shape[-1], 0, rows - w.shape[-2]))
    widths = [taps_w[0].shape[-1]] + [w11.shape[-1]] * 4
    cols = torch.split(w_pre, widths, dim=1)
    bias = torch.split(b_pre, widths)
    Cp = w_tc.shape[-1]
    return dict(
        w_pre=torch.cat([pad(w, C4, _round4(cb)).reshape(-1)
                         for w, cb in zip(cols, widths)]),
        b_pre=torch.cat([F.pad(b, (0, _round4(cb) - cb))
                         for b, cb in zip(bias, widths)]),
        taps=torch.cat([pad(w, _round4(cb), _round4(cb)).reshape(-1)
                        for w, cb in zip(taps_w, widths)]),
        w11=pad(w11, C4, _round4(w11.shape[-1])).contiguous(),
        w_tc=pad(w_tc, _round4(Cp), _round4(Cp)).contiguous())


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
    C') in x's dtype."""
    dilations = tuple(int(d) for d in dilations)
    if x.device.type == "cpu":
        return reference_fused_dgmstcn_eval(
            x, w_pre, b_pre, taps_w, taps_b, w11, b11, a_tr, b_tr, w_tc,
            b_tc, a_out, b_out, coeff, dilations=dilations, stride=stride)
    name = "fused_dgmstcn_eval"
    _build.check_activation(x, name)
    _build.refuse_grad(name, x, w_pre, b_pre, *taps_w, *taps_b, w11, b11,
                       a_tr, b_tr, w_tc, b_tc, a_out, b_out, coeff)
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
    op = lambda t, shape, n: _build.graph_operand(t, shape, n, dev)  # noqa
    widths = [rem, mid, mid, mid]
    w_pre, w11, w_tc = (op(w_pre, (C, P), "w_pre"), op(w11, (C, mid), "w11"),
                        op(w_tc, (Cp, Cp), "w_tc"))
    taps_w = [op(w, (3, cb, cb), f"taps_w[{i}]")
              for i, (w, cb) in enumerate(zip(taps_w, widths))]
    bias = torch.cat([op(b, (cb,), f"taps_b[{i}]")
                      for i, (b, cb) in enumerate(zip(taps_b, widths))]
                     + [torch.zeros(mid, device=dev), op(b11, (mid,), "b11")])
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    if C % 4:              # the kernel reads x four channels at a time
        x = F.pad(x, (0, 4 - C % 4))
    packed = pack_weights(w_pre, op(b_pre, (P,), "b_pre"), taps_w, w11, w_tc,
                          x.shape[-1])
    ops = [packed["w_pre"], packed["b_pre"], packed["taps"], bias,
           packed["w11"], op(a_tr, (Cp,), "a_tr"), op(b_tr, (Cp,), "b_tr"),
           packed["w_tc"], op(b_tc, (Cp,), "b_tc"), op(a_out, (Cp,), "a_out"),
           op(b_out, (Cp,), "b_out"),
           None if coeff is None else op(coeff, (V,), "coeff")]
    Tp = conv_out_len(T, stride)
    out = torch.empty((N, Tp, V, Cp), device=dev, dtype=x.dtype)
    if out.numel() == 0:
        return out
    TO, JR = tile_plan(N, T, V, C, rem, mid, stride, max(dilations),
                       coeff is not None)
    xmean = (None if coeff is None else torch.empty(
        (N, T, x.shape[-1]), device=dev, dtype=torch.float32))
    ptr = _build.ptr
    with torch.cuda.device(dev):
        _build.launch(
            "ms_tcn", ptr(x), ptr(out), int(x.dtype == torch.bfloat16),
            ptr(xmean), *(ptr(t) for t in ops), N, T, V, x.shape[-1], Cp,
            rem, mid, *dilations, stride, TO, JR, _build.stream_of(x))
    fused_dgmstcn_eval.launches += 1
    return out


fused_dgmstcn_eval.launches = 0
