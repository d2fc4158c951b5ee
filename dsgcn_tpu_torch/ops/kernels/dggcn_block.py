"""The whole eval GCN block of DG-STGCN and DS-GCN in one kernel (K6).

The port of ``dsgcn_tpu/ops/pallas/dggcn_block.py:fused_dggcn_block_eval``:

    res = x                       (or x w_down + b_down when channels change)
    pre = relu(x w_pre + b_pre)                              (T, V, K*Cm)
    G   = alpha*tanh(x1 - x2) + beta*softmax_v(x1^T x2) + A  (one subset
          optionally the DS-GCN edge-class attention)
    y   = aggregate(pre, G)
    out = relu(y w_post + b_post + res)

with every BatchNorm already folded into its 1x1 (``ops/gcn.py:
fold_block_params``).  The T-pooled queries x1/x2 are built outside, as in
JAX.  On a CUDA tensor :func:`fused_dggcn_block_eval` launches the
hand-written kernel ``csrc/dggcn_block.cu`` (a block a tile of whole
frames, its 1x1 products on tensor cores; :func:`block_plan` picks the tile
and the channel chunks); on a CPU tensor it runs the plain version
:func:`reference_dggcn_block_eval`.  Eval only.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from .dyn_graph import (_aggregate_clk, _ctr, _edge_operands, _graph,
                        _product_clk, _round_up, _row_tiles, graph_tables,
                        pitch_a, pw_chunks, pw_panels, pw_pre, pw_slot,
                        pw_tables, pw_tiles)


def block_smem(V: int, C: int, K: int, Cm: int, Cout: int, xsize: int,
               R: int, CH: int) -> int:
    """Shared-memory bytes of a K6 block (``block_layout``): the x tile,
    the pre chunk (``pw_pre``), the y chunk (float32), the ring of weight
    panels and the tables; 0 where the kernel refuses the plan (its
    accumulator tiles).  The kernel's own count (``csrc/dggcn_block.cu``
    ``dsgcn_dggcn_block_geometry``) is held to it on the card."""
    if (pw_tiles(R, Cout) > _build.K6_OUT_TILES
            or pw_tiles(R, CH) > _build.K6_PRE_TILES):
        return 0
    KP = _build.PW_KP
    slot = pw_slot(max(CH, Cout), 4)
    return (R * pitch_a(_round_up(C, KP) * xsize) + pw_pre(R, CH)
            + R * pitch_a(_round_up(CH, KP) * 4)
            + _build.PW_STAGES * slot + pw_tables(V, Cm, CH))


@functools.lru_cache(maxsize=None)
def block_plan(N: int, T: int, V: int, C: int, K: int, Cm: int, Cout: int,
               xsize: int, down: bool):
    """(TT, R, CH, build_share): the frames and rows of a K6 block, the
    channels of its chunks, and the share of the block's clocks the graph
    build takes under the cost model.

    A block builds every graph entry of its sample once for each tile of
    TT frames (a division an entry), so short tiles repeat the build, while
    long tiles need more rows of the out accumulator in registers and leave
    fewer blocks for the 132 SMs; narrow chunks cost a barrier a weight
    panel more often and load and split the x tile's fragments for fewer
    MMAs in the pre product.  The cost is the
    blocks the busiest SM runs (one at a time) times a block's clocks: the
    three products on tensor cores (3xTF32 terms; two where x is bfloat16),
    the graph build and aggregation, the barriers, and x and out's bytes.
    The cheapest plan wins, ties to fewer blocks.  Raises, naming the
    limit, where no plan fits."""
    KC = K * Cm
    xf = xsize == 4
    best, least = None, None
    for R, TT in _row_tiles(T, V):
        if pw_tiles(R, Cout) > _build.K6_OUT_TILES:
            continue
        for CH in pw_chunks(K, Cm):
            smem = block_smem(V, C, K, Cm, Cout, xsize, R, CH)
            if smem == 0 or smem > _build.BLOCK_SMEM:
                if smem:
                    least = smem if least is None else min(least, smem)
                continue
            agg, build = _aggregate_clk(V, TT, CH,
                                        _build.K6_JOINTS_PER_THREAD)
            slot = pw_slot(max(CH, Cout), 4)
            panels = ((KC // CH) * (pw_panels(C, CH, slot, 4)
                                    + pw_panels(CH, Cout, slot, 4))
                      + (pw_panels(C, Cout, slot, 4) if down else 0))
            clk = ((KC // CH) * (_product_clk(R, C, CH, xf, True) + agg
                                 + _product_clk(R, CH, Cout, True, True)
                                 + _build.CHUNK_CLK)
                   + (_product_clk(R, C, Cout, xf, True) if down else 0.0)
                   + panels * _build.PANEL_CLK
                   + TT * V * (C + Cout) * xsize / _build.BYTES_CLK)
            blocks = N * -(-T // TT)
            key = (-(-blocks // _build.SMS) * clk, blocks)
            if best is None or key < best[0]:
                best = (key, TT, R, CH, (KC // CH) * build / clk)
    if best is None:
        if least is None:
            raise ValueError(
                f"fused_dggcn_block_eval: {Cout} output channels exceed "
                "the out accumulator a block holds in registers")
        raise ValueError(
            f"fused_dggcn_block_eval: no block plan for C = {C}, K*Cm = "
            f"{KC}, Cout = {Cout}, V = {V}: the smallest block needs "
            f"{least} bytes of shared memory, over the {_build.BLOCK_SMEM} a "
            "block has")
    return best[1:]


def reference_dggcn_block_eval(x, x1, x2, w_pre, b_pre, A, alpha, beta,
                               w_post, b_post, w_down=None, b_down=None, *,
                               K, Cm, edge_w=None, edge_b=None, edge_sel=None,
                               edge_k=-1, edge_num=15):
    """Plain PyTorch version of K6, the TPU kernel's arithmetic: x lifted to
    float32, pre, G, y and the 1x1 products in float32, the output in x's
    dtype."""
    N, T, V, _ = x.shape
    xf = x.float()
    pre = torch.relu(xf @ w_pre.float() + b_pre.float())
    x1, x2 = x1.float(), x2.float()
    ctr = _ctr(x1, x2, edge_w, edge_b, edge_sel, Cm, edge_k, edge_num)
    G, _ = _graph(x1, x2, A, alpha, beta, ctr)
    y = torch.einsum("ntvkc,nkcvw->ntwkc", pre.reshape(N, T, V, K, Cm), G)
    out = y.reshape(N, T, V, K * Cm) @ w_post.float() + b_post.float()
    res = xf if w_down is None else xf @ w_down.float() + b_down.float()
    return torch.relu(out + res).to(x.dtype)


def fused_dggcn_block_eval(x: torch.Tensor, x1: torch.Tensor,
                           x2: torch.Tensor, w_pre: torch.Tensor,
                           b_pre: torch.Tensor, A: torch.Tensor,
                           alpha: torch.Tensor, beta: torch.Tensor,
                           w_post: torch.Tensor, b_post: torch.Tensor,
                           w_down: Optional[torch.Tensor] = None,
                           b_down: Optional[torch.Tensor] = None, *,
                           K: int, Cm: int,
                           edge_w: Optional[torch.Tensor] = None,
                           edge_b: Optional[torch.Tensor] = None,
                           edge_sel: Optional[torch.Tensor] = None,
                           edge_k: int = -1,
                           edge_num: int = 15) -> torch.Tensor:
    """out = relu(post(aggregate(relu(pre(x)), G)) + res) for one block.

    x: (N, T, V, C) float32 or bfloat16; x1/x2: (N, K, Cm, V) T-pooled
    queries; w_pre (C, K*Cm), b_pre (K*Cm,), w_post (K*Cm, Cout), b_post
    (Cout,), w_down (C, Cout) and b_down (Cout,) or None (then C == Cout and
    the residual is x): BatchNorm-folded 1x1s in the JAX (in, out)
    orientation; A (K, V, V); alpha/beta (K,) effective gates; edge_w
    (Cm, edge_num*Cm), edge_b (edge_num*Cm,) or None, edge_sel
    (edge_num, V, V): the edge-class attention on subset ``edge_k``.
    Returns (N, T, V, Cout) in x's dtype."""
    if edge_w is None:
        edge_k = -1
    if x.device.type == "cpu":
        return reference_dggcn_block_eval(
            x, x1, x2, w_pre, b_pre, A, alpha, beta, w_post, b_post, w_down,
            b_down, K=K, Cm=Cm, edge_w=edge_w, edge_b=edge_b,
            edge_sel=edge_sel, edge_k=edge_k, edge_num=edge_num)
    name = "fused_dggcn_block_eval"
    _build.check_activation(x, name)
    _build.refuse_grad(name, x, x1, x2, w_pre, b_pre, A, alpha, beta, w_post,
                       b_post, w_down, b_down, edge_w, edge_b)
    N, T, V, C = x.shape
    KC, Cout, dev = K * Cm, w_post.shape[-1], x.device
    E = edge_num if edge_k >= 0 else 0
    _build.check_limits(name, N, V, E)
    if (w_down is None) != (b_down is None):
        raise ValueError(f"{name}: give both w_down and b_down, or neither")
    if w_down is None and C != Cout:
        raise ValueError(f"{name}: without a down path C ({C}) must equal "
                         f"Cout ({Cout})")
    op = lambda t, shape, n: _build.graph_operand(t, shape, n, dev)  # noqa
    ops = dict(x1=op(x1, (N, K, Cm, V), "x1"), x2=op(x2, (N, K, Cm, V), "x2"),
               w_pre=op(w_pre, (C, KC), "w_pre"), b_pre=op(b_pre, (KC,),
                                                           "b_pre"),
               A=op(A, (K, V, V), "A"), alpha=op(alpha, (K,), "alpha"),
               beta=op(beta, (K,), "beta"),
               w_post=op(w_post, (KC, Cout), "w_post"),
               b_post=op(b_post, (Cout,), "b_post"), w_down=None,
               b_down=None, edge_w=None, bias_field=None, sel=None)
    if w_down is not None:
        ops["w_down"] = op(w_down, (C, Cout), "w_down")
        ops["b_down"] = op(b_down, (Cout,), "b_down")
    if edge_k >= 0:
        if not 0 <= edge_k < K:
            raise ValueError(f"{name}: edge_k={edge_k} outside [0, {K})")
        ops["edge_w"], ops["bias_field"], ops["sel"] = _edge_operands(
            edge_w, edge_b, edge_sel, Cm, edge_num, V, dev)
    out = torch.empty((N, T, V, Cout), device=dev, dtype=x.dtype)
    if out.numel() == 0:
        return out
    TT, R, CH, _ = block_plan(N, T, V, C, K, Cm, Cout, x.element_size(),
                              w_down is not None)
    tables = graph_tables(N, K, Cm, V, dev)
    # the edge subset's projections and ctr, built for the whole call ahead
    # of the blocks (K1's edge kernels)
    p1s = p2s = ectr = None
    if edge_k >= 0:
        p1s, p2s = torch.empty(2, N * E * V * Cm, device=dev)
        ectr = torch.empty(N * V * V * Cm, device=dev)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        _build.launch(
            "dggcn_block", ptr(x), ptr(out), int(x.dtype == torch.bfloat16),
            *(ptr(ops[k]) for k in (
                "x1", "x2", "w_pre", "b_pre", "A", "alpha", "beta", "w_post",
                "b_post", "w_down", "b_down", "edge_w", "bias_field", "sel")),
            ptr(p1s), ptr(p2s), ptr(ectr), *(ptr(t) for t in tables), N, T,
            V, C, K, Cm, Cout, edge_num, edge_k, TT, R, CH,
            _build.stream_of(x))
    fused_dggcn_block_eval.launches += 1
    return out


fused_dggcn_block_eval.launches = 0
