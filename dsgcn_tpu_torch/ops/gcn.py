"""Spatial graph convolutions of STGCN++, AAGCN, CTR-GCN, DG-STGCN and
DS-GCN (channels-last ``(N, T, V, C)``).

The ports of ``dsgcn_tpu/ops/gcn.py:UnitGCN`` (ST-GCN, STGCN++: a static
graph, contracted with ``torch.einsum`` as JAX leaves it to XLA),
``UnitAAGCN``/``UnitAAHGCN`` with ``AttentionChain`` (AAGCN),
``UnitCTRGCN``/``UnitCTRHGCN`` with ``CTRGC``/``CTRHGC`` (CTR-GCN; these
units, like UnitGCN, run no kernel: JAX computes them in XLA einsums too),
``DGGCN`` (DG-STGCN), ``DGHGCN`` (the semantic DG-GCN without subset
decomposition; einsums only, as in JAX), ``DGPHGCN1`` (DS-GCN), ``GTGC``
with ``UnitGTGCN`` (GTGCN) and ``UnitGCNEdge`` (STGIN; these run no
kernel, in JAX or the port), train and eval, with the helpers they use.
DGGCN and DGPHGCN1 have two aggregation paths, chosen as in the JAX
modules:

* ``use_pallas=True`` (``build_backbone``'s default): the dynamic-graph
  kernels.  Training always runs K1 and its backward K2 as one autograd
  Function (``ops/kernels/dyn_graph.py``), as the JAX modules do
  (gcn.py:701-705, :1192).  Eval takes ``eval_kernel``: 'bd' (K3,
  ``ops/kernels/bd_agg.py``), 'fused' (K1), 'mega' (K6, the whole block in
  one kernel, ``ops/kernels/dggcn_block.py``), and for DGGCN also 'bdps'
  and 'bdg' (K4, per subset / per channel group of g = min(32, mid)) and
  'fusedpre' (K5, the pre 1x1 inside K1, at C >= 64).  'auto' follows the
  JAX package: 'bd' when V*K*mid <= 2400, else DGGCN takes 'bdg' at
  mid >= 64 and 'fused' otherwise, DGPHGCN1 'fused'.  On CUDA tensors these
  launch the hand-written kernels, on CPU tensors their plain versions.
* ``use_pallas=False``: the dense path of the JAX modules
  (gcn.py:710-736, :1206-1259), which materializes the (N, K, mid, V, V)
  graph and contracts it with an einsum; it trains through autograd.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.joint_partition import all_gather, ring_permute
from ..parallel.mesh import axis
from .common import (BatchNorm, PointConv, accum_dtype, cast, fold_bn,
                     joint_pad_check)
from .kernels.bd_agg import bd_dyn_graph_agg, bd_dyn_graph_agg_subset
from .kernels.dggcn_block import fused_dggcn_block_eval
from .kernels.dyn_graph import (edge_onehot, fused_dyn_graph_agg,
                                fused_dyn_graph_agg_eval)

ACTS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    # softmax over the source-joint (row) axis of the (..., v, w) graph
    "softmax": lambda x: torch.softmax(x, dim=-2),
}


class UnitGCN(nn.Module):
    """ST-GCN / STGCN++ spatial conv (reference unit_gcn, gcn.py:22-97; JAX
    ``dsgcn_tpu/ops/gcn.py:UnitGCN``), x (N, T, V, C_in) -> (N, T, V,
    C_out).

    ``adaptive``: None (the fixed graph), 'init' (a per-block ``A``
    parameter, a copy of ``A_init``), 'offset' (``A + PA - 1e-6``, ``PA``
    drawn from U(0, 2e-6)) or 'importance' (``A * PA``, ``PA`` ones).
    ``conv_pos`` 'pre' runs the 1x1 before the graph contraction, 'post'
    after it; ``with_res`` adds the input (or its 1x1 + BN where the width
    changes) before the final ReLU.  The contraction runs in
    :func:`accum_dtype` and rounds to x's type, as JAX's einsum does.
    ``A_ext`` in the forward (STGCN_GC, JAX gcn.py:70-127): a (K, V, V)
    graph fed from outside takes the place of ``A_init`` ('offset' adds
    ``PA``, 'importance' scales by it); with ``adaptive='init'`` it is
    refused, as JAX asserts (the reference assigns the fed tensor onto a
    Parameter and crashes).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, adaptive="init", conv_pos="pre",
                 with_res=False):
        super().__init__()
        if adaptive not in (None, "init", "offset", "importance"):
            raise ValueError(f"unknown adaptive {adaptive!r}")
        if conv_pos not in ("pre", "post"):
            raise ValueError(f"unknown conv_pos {conv_pos!r}")
        K, V, _ = A_init.shape
        self.K, self.out_channels = K, out_channels
        self.adaptive, self.conv_pos, self.with_res = (adaptive, conv_pos,
                                                       with_res)
        if with_res and in_channels != out_channels:
            self.down_conv = PointConv(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)
        # a copy: blocks are built from one numpy graph and must not share it
        A = torch.tensor(np.asarray(A_init), dtype=torch.float32)
        if adaptive == "init":
            self.A = nn.Parameter(A)
        else:                      # a constant, as in JAX: not in the state
            self.register_buffer("A", A, persistent=False)
        if adaptive == "offset":
            self.PA = nn.Parameter(torch.empty(K, V, V).uniform_(0, 2e-6))
        elif adaptive == "importance":
            self.PA = nn.Parameter(torch.ones(K, V, V))
        self.conv = (PointConv(in_channels, out_channels * K)
                     if conv_pos == "pre" else
                     PointConv(K * in_channels, out_channels))
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor,
                A_ext: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, t, v, c = x.shape
        acc = accum_dtype(x.dtype)
        if A_ext is not None and self.adaptive == "init":
            raise ValueError("external A requires adaptive in (None, "
                             "'offset', 'importance')")
        res = 0.0
        if self.with_res:
            res = (self.down_bn(self.down_conv(x))
                   if c != self.out_channels else x)
        # JAX casts A_ext to float32 before the contraction
        A = cast(self.A if A_ext is None else cast(A_ext, torch.float32),
                 acc)
        if self.adaptive == "offset":
            A = A + (cast(self.PA, acc) - 1e-6)
        elif self.adaptive == "importance":
            A = A * cast(self.PA, acc)
        if self.conv_pos == "pre":
            y = self.conv(x).reshape(n, t, v, self.K, self.out_channels)
            y = cast(torch.einsum("ntvkc,kvw->ntwc", cast(y, acc), A),
                     x.dtype)
        else:
            y = cast(torch.einsum("ntvc,kvw->ntwkc", cast(x, acc), A),
                     x.dtype)
            y = self.conv(y.reshape(n, t, v, self.K * c))
        return F.relu(self.bn(y) + res)


def _type_gather(x: torch.Tensor, node_type: torch.Tensor,
                 type_axis: int) -> torch.Tensor:
    """out[..., v] = x[..., node_type[v], ..., v]: per-joint gather on the
    type axis (the reference's ``torch.diagonal`` trick, gcn.py:729-730).
    ``x`` has a trailing joint axis V; the result drops the type axis."""
    x = torch.movedim(x, type_axis, -2)                     # (..., P, V)
    idx = node_type.expand(x.shape[:-2] + (1, x.shape[-1]))
    return torch.gather(x, -2, idx).squeeze(-2)


def _edge_class_select(x: torch.Tensor,
                       edge_type: torch.Tensor) -> torch.Tensor:
    """out[..., u, w] = x[..., class(u, w), u, w] for per-class maps ``x``
    (..., E, V, V) and the (V, V) class matrix (gcn.py:2281-2287)."""
    idx = edge_type.expand(x.shape[:-3] + edge_type.shape)[..., None, :, :]
    return torch.gather(x, -3, idx).squeeze(-3)


def _gate_vec(gates: torch.Tensor, K: int, sem: int, norm: int,
              subset_wise: bool) -> torch.Tensor:
    """Effective per-subset (K,) gate vector, incl. the repeat_interleave
    grouping for the 3-gate (sub_att=False) case (reference gcn.py:2302-2309)."""
    if not subset_wise:
        return gates[0].expand(K)
    if K == gates.shape[0]:
        return gates
    rep = math.ceil(K / 3)
    return torch.repeat_interleave(gates, rep)[2 * sem - norm:]


def _gate(gates: torch.Tensor, K: int, sem: int, norm: int,
          subset_wise: bool, trailing: int) -> torch.Tensor:
    """The gates broadcast over a (N, K, *trailing dims) graph tensor."""
    if not subset_wise:
        return gates[0]
    return _gate_vec(gates, K, sem, norm, subset_wise).reshape(
        (1, K) + (1,) * trailing)


def _dispatch_contract(pre_x: torch.Tensor, G: torch.Tensor, ctr,
                       ada) -> torch.Tensor:
    """The reference four-way einsum dispatch on graph dims (gcn.py:1560-
    1580; JAX ``ops/gcn.py:_dispatch_contract``).  pre_x: (N, T, V, K, C);
    G: (K, V, V) when neither dynamic graph is on, else (N, K, Cq, V, V)
    for T-pooled graphs or (N, K, Cq, T, V, V) for per-frame ('NA') ones,
    with Cq in {1, C}.  Returns (N, T, W, K, C)."""
    G = cast(G, pre_x.dtype)
    if ctr is None and ada is None:
        return torch.einsum("ntvkc,kvw->ntwkc", pre_x, G)
    per_frame = G.dim() == 6
    if G.shape[2] == 1:
        return torch.einsum("ntvkc,nktvw->ntwkc" if per_frame
                            else "ntvkc,nkvw->ntwkc", pre_x, G[:, :, 0])
    return torch.einsum("ntvkc,nkctvw->ntwkc" if per_frame
                        else "ntvkc,nkcvw->ntwkc", pre_x, G)


def _graph_mode(ctr, ada) -> bool:
    """Checks ``ctr``/``ada`` (None, 'T' or 'NA') and says whether the
    graphs are per frame: 'NA' on either makes both unpooled, Tq = T (JAX
    gcn.py:605, :1089)."""
    for name, value in (("ctr", ctr), ("ada", ada)):
        if value not in (None, "T", "NA"):
            raise ValueError(f"unknown {name} {value!r} (None, 'T' or "
                             "'NA')")
    return "NA" in (ctr, ada)


def _graph_init(A: torch.Tensor, dt: torch.dtype,
                per_frame: bool) -> torch.Tensor:
    """The trained graph as the dynamic graphs' accumulator: (1, K, 1, V,
    V), or (1, K, 1, 1, V, V) for per-frame graphs."""
    G = cast(A, dt)[None, :, None]
    return G[:, :, :, None] if per_frame else G


def _ada_graph(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The outer-product graph sum_c x1 x2 of (N, K, C, [T,] V) queries:
    (N, K, [T,] V, W)."""
    eq = ("nkctv,nkctw->nktvw" if x1.dim() == 5 else "nkcv,nkcw->nkvw")
    return torch.einsum(eq, x1, x2)


def _fold(conv: PointConv, bn: BatchNorm):
    """A 1x1 with its eval BatchNorm folded in: (w (in, out), b), float32."""
    f32 = torch.float32
    a, b = fold_bn(cast(bn.weight, f32), cast(bn.bias, f32),
                   cast(bn.running_mean, f32), cast(bn.running_var, f32))
    return cast(conv.weight, f32).t() * a[None], cast(conv.bias, f32) * a + b


def fold_block_params(mod: nn.Module, changes_channels: bool):
    """(w_pre, b_pre, w_post, b_post, w_down, b_down) of a DG/DS-GCN block:
    pre_conv/pre_bn, post_conv/bn and down_conv/down_bn (None without a
    channel change) folded for the whole-block kernel K6, in the JAX (in,
    out) orientation (``dsgcn_tpu/ops/gcn.py:_fold_block_params``)."""
    w_pre, b_pre = _fold(mod.pre_conv, mod.pre_bn)
    w_post, b_post = _fold(mod.post_conv, mod.bn)
    w_down = b_down = None
    if changes_channels:
        w_down, b_down = _fold(mod.down_conv, mod.down_bn)
    return w_pre, b_pre, w_post, b_post, w_down, b_down


def _graph_acts_ok(mod) -> bool:
    """The kernels' graph form: T-pooled ctr and ada, tanh and softmax."""
    return (mod.ctr == "T" and mod.ada == "T" and mod.ctr_act == "tanh"
            and mod.ada_act == "softmax")


_MEGA_PADDED = ("eval_kernel='mega' does not support joint-padded mode "
                "(v_pad); use 'auto'/'bd'/'fused'")


def _jp_form_check(unit: str, options) -> None:
    """JAX's assert on the joint-partitioned form (gcn.py:592-595,
    :1069-1076): {option: (value, the value the mode takes)}; raises
    naming the first option off its value."""
    for name, (value, want) in options.items():
        if value != want:
            raise NotImplementedError(
                f"{unit} graph_axis: the joint-partitioned mode takes "
                f"{name}={want!r}, not {value!r}")


def _jp_block(mod: nn.Module, x: torch.Tensor, aggregate) -> torch.Tensor:
    """A joint-partitioned DGGCN/DGPHGCN1 block on this process's joints:
    the residual, the values (their BNs synced over the axis), the ring
    aggregation and the post 1x1 + BN (JAX gcn.py:591-600, :1068-1083)."""
    res = (mod.down_bn(mod.down_conv(x)) if x.shape[-1] != mod.out_channels
           else x)
    y = aggregate(x, F.relu(mod.pre_bn(mod.pre_conv(x))))
    return F.relu(mod.bn(mod.post_conv(y)) + res)


def _ring_aggregate(A, ada, x1f, x2, pre, ax, gated_ctr, be, acc):
    """The ring of a joint-partitioned unit: ``pre`` (N, T, Vl, K, C), this
    process's values; ``x1f`` (N, K, C, V) the gathered queries, ``x2``
    (N, K, C, Vl) the local ones, ``ada`` (N, K, V, Vl) the softmaxed
    outer-product graph of the local target columns and ``be`` its gate.
    At hop i the values of process src = (g + i) mod G are here: the
    chunk's graph tanh(x1[src] - x2) (gated and, for DS-GCN, edge-attended
    by ``gated_ctr(ctr, src)``) + be ada[src] + A[src, local] is built, the
    values start on to the previous process, and the chunk is contracted
    in ``acc``; the sum is cast once at the end."""
    n, t, vl, K, mid = pre.shape
    g, G = ax.index, ax.size
    A_cols = cast(A[:, :, g * vl:(g + 1) * vl], pre.dtype)      # (K, V, vl)
    y = pre.new_zeros((n, t, vl, K, mid), dtype=acc)
    cur = pre
    for i in range(G):
        src = (g + i) % G
        blk = slice(src * vl, (src + 1) * vl)
        ctr = torch.tanh(x1f[..., blk][..., :, None] - x2[..., None, :])
        Gc = gated_ctr(ctr, src) + (ada[:, :, blk] * be
                                    + A_cols[:, blk][None])[:, :, None]
        # start the transfer, then contract the chunk already here
        nxt = ring_permute(cur, ax.group)
        y = y + torch.einsum("ntvkc,nkcvw->ntwkc", cast(cur, acc),
                             cast(Gc, acc))
        cur = nxt.wait()
    return cast(y, pre.dtype)


DGGCN_EVAL_KERNELS = ("auto", "bd", "bdps", "bdg", "fused", "fusedpre",
                      "mega")


class DGGCN(nn.Module):
    """The DG-STGCN dynamic-group graph conv (reference dggcn,
    gcn.py:1445-1584; JAX ``dsgcn_tpu/ops/gcn.py:DGGCN``).

    ctr: the channel-wise diff graph act(x1 - x2); ada: the outer-product
    graph act(x1^T x2); both T-pooled ('T') or, with 'NA' on either, per
    frame (queries not pooled over T: the dense path only, as in JAX), and
    added to the trained A with the gates alpha/beta (per subset with
    ``subset_wise``, else alpha[0] and beta[0] for every subset; the
    parameters keep shape (K,)).  Submodule names follow the JAX module's
    flax scopes.  ``v_pad`` (joint-padded mode) keeps JAX's refusals,
    training and 'mega', and runs at the real joints
    (``ops/common.py:joint_pad_check``).

    ``graph_axis`` (the joint-partitioned mode, JAX gcn.py:591-600,
    :738-797): x holds this process's block of the joints (the backbone
    slices them); the graph is built and contracted block by block on the
    ring of :meth:`_jp_aggregate`, whatever ``use_pallas`` says (JAX takes
    no kernel there either), and ``down_bn``, ``pre_bn`` and ``bn`` sync
    their statistics over the axis.  It takes the standard form only (ctr
    and ada 'T', tanh and softmax) and refuses any other, naming the
    option, as JAX asserts.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, ratio=0.25, ctr="T", ada="T",
                 subset_wise=False, ada_act="softmax", ctr_act="tanh",
                 use_pallas=False, eval_kernel="auto", graph_axis=None,
                 v_pad=0):
        super().__init__()
        if graph_axis is not None:
            _jp_form_check("DGGCN", dict(ctr=(ctr, "T"), ada=(ada, "T"),
                                         ctr_act=(ctr_act, "tanh"),
                                         ada_act=(ada_act, "softmax"),
                                         v_pad=(v_pad, 0)))
        self.graph_axis = graph_axis
        self.v_pad = v_pad
        self.per_frame = _graph_mode(ctr, ada)
        if eval_kernel not in DGGCN_EVAL_KERNELS:
            raise ValueError(f"unknown eval_kernel {eval_kernel!r}")
        K = A_init.shape[0]
        self.in_channels, self.out_channels, self.K = (in_channels,
                                                       out_channels, K)
        self.mid = int((ratio if ratio is not None else 1.0 / K)
                       * out_channels)
        self.ctr, self.ada = ctr, ada
        self.ctr_act, self.ada_act = ctr_act, ada_act
        self.subset_wise = subset_wise
        self.use_pallas, self.eval_kernel = use_pallas, eval_kernel
        mid = self.mid
        if in_channels != out_channels:
            self.down_conv = PointConv(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels, axis_name=graph_axis)
        # a copy: blocks are built from one numpy graph and must not share it
        self.A = nn.Parameter(torch.tensor(np.asarray(A_init),
                                           dtype=torch.float32))
        self.pre_conv = PointConv(in_channels, mid * K)
        self.pre_bn = BatchNorm(mid * K, axis_name=graph_axis)
        self.alpha = nn.Parameter(torch.zeros(K))
        self.beta = nn.Parameter(torch.zeros(K))
        if ctr is not None or ada is not None:
            self.conv1 = PointConv(in_channels, mid * K)
            self.conv2 = PointConv(in_channels, mid * K)
        self.post_conv = PointConv(K * mid, out_channels)
        self.bn = BatchNorm(out_channels, axis_name=graph_axis)

    def eval_path(self, c: int) -> str:
        """The eval kernel the JAX dispatch picks (gcn.py:621-700): 'auto'
        resolved by the real joint count and mid; 'fusedpre' only at
        c >= 64, else 'fused'."""
        K, mid = self.K, self.mid
        ek = self.eval_kernel
        if ek == "auto":
            V = self.A.shape[-1]
            ek = ("bd" if V * K * mid <= 2400
                  else "bdg" if mid >= 64 else "fused")
        if ek == "fusedpre" and c < 64:
            ek = "fused"
        return ek

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        K, mid = self.K, self.mid
        n, t, v, c = x.shape
        joint_pad_check(self)
        if self.graph_axis is not None:
            return _jp_block(self, x, self._jp_aggregate)
        x1 = x2 = None
        if self.ctr is not None or self.ada is not None:
            if self.per_frame:                          # (n, K, mid, t, v)
                x1 = self.conv1(x).reshape(n, t, v, K, mid).permute(
                    0, 3, 4, 1, 2)
                x2 = self.conv2(x).reshape(n, t, v, K, mid).permute(
                    0, 3, 4, 1, 2)
            else:
                tmp = x.mean(dim=1)                             # (n, v, c)
                x1 = self.conv1(tmp).reshape(n, v, K, mid).permute(
                    0, 2, 3, 1)
                x2 = self.conv2(tmp).reshape(n, v, K, mid).permute(
                    0, 2, 3, 1)
        kernel = self.use_pallas and _graph_acts_ok(self)
        ek = "fused" if self.training else self.eval_path(c)
        a_vec = _gate_vec(self.alpha, K, 0, K, self.subset_wise)
        b_vec = _gate_vec(self.beta, K, 0, K, self.subset_wise)
        if kernel and ek == "mega":
            if self.v_pad:
                raise ValueError(_MEGA_PADDED)
            # the whole block in one kernel (JAX gcn.py:635-648)
            w = fold_block_params(self, c != self.out_channels)
            return fused_dggcn_block_eval(x, x1, x2, w[0], w[1], self.A,
                                          a_vec, b_vec, *w[2:], K=K, Cm=mid)
        res = (self.down_bn(self.down_conv(x))
               if c != self.out_channels else x)
        if kernel and ek == "fusedpre":
            # K5: the BN-folded pre 1x1 inside the kernel, w_pre in x's
            # dtype and b_pre in float32 (JAX gcn.py:686-700)
            w_pre, b_pre = _fold(self.pre_conv, self.pre_bn)
            y = fused_dyn_graph_agg_eval(x, cast(w_pre, x.dtype), b_pre, x1,
                                         x2, self.A, a_vec, b_vec, K=K,
                                         Cm=mid)
        else:
            pre_x = F.relu(self.pre_bn(self.pre_conv(x)))     # (n,t,v,K*mid)
            if kernel:
                y = self._kernel_aggregate(pre_x, x1, x2, a_vec, b_vec, ek)
            else:
                y = self._dense_aggregate(pre_x.reshape(n, t, v, K, mid),
                                          x1, x2)
        y = self.bn(self.post_conv(y.reshape(n, t, v, K * mid)))
        return F.relu(y + res)

    def _kernel_aggregate(self, pre_x, x1, x2, a_vec, b_vec, ek):
        """K1+K2 in training and 'fused' eval, K3 for 'bd', K4 for
        'bdps'/'bdg' (JAX gcn.py:649-705)."""
        K, mid = self.K, self.mid
        n, t, v, _ = pre_x.shape
        if ek in ("bd", "bdps", "bdg"):
            args = (pre_x.reshape(n, t, v * K * mid), x1.transpose(-1, -2),
                    x2, self.A, a_vec, b_vec)
            if ek == "bd":
                return bd_dyn_graph_agg(*args, K=K, Cm=mid)
            g = min(32, mid) if ek == "bdg" else None
            return bd_dyn_graph_agg_subset(*args, K=K, Cm=mid, g=g)
        return fused_dyn_graph_agg(pre_x, x1, x2, self.A, a_vec, b_vec,
                                   K=K, Cm=mid)

    def _jp_aggregate(self, x, pre_x):
        """The joint-partitioned graph build and ring aggregation (JAX
        gcn.py:738-797): the queries x1 are all-gathered ((N, K, mid, V),
        small); the ada softmax runs over the whole source axis for this
        process's target columns; the values ``pre_x`` go round the ring,
        and at each hop the (V_src, W_local) chunk of the graph is built
        and contracted, in the accumulation type, cast once at the end."""
        K, mid = self.K, self.mid
        n, t, vl, _ = pre_x.shape
        ax = axis(self.graph_axis)
        acc = accum_dtype(x.dtype)
        tmp = x.mean(dim=1)                                     # (n, vl, c)
        x1 = self.conv1(tmp).reshape(n, vl, K, mid).permute(0, 2, 3, 1)
        x2 = self.conv2(tmp).reshape(n, vl, K, mid).permute(0, 2, 3, 1)
        x1f = all_gather(x1, ax.group, dim=-1)                 # (n,K,mid,V)
        ada = torch.softmax(torch.einsum("nkcv,nkcw->nkvw", cast(x1f, acc),
                                         cast(x2, acc)), dim=-2)
        if self.subset_wise:
            al = cast(self.alpha, x.dtype)[None, :, None, None, None]
            be = cast(self.beta, x.dtype)[None, :, None, None]
        else:
            al, be = cast(self.alpha[0], x.dtype), cast(self.beta[0],
                                                         x.dtype)
        return _ring_aggregate(
            self.A, cast(ada, x.dtype), x1f, x2, pre_x.reshape(n, t, vl, K,
                                                              mid),
            ax, lambda ctr, src: ctr * al, be, acc).reshape(n, t, vl,
                                                             K * mid)

    def _dense_aggregate(self, pre_x, x1, x2):
        """Materialized graph + einsum (JAX gcn.py:710-732); graphs are
        (N, K, Cq, [T,] V, V)."""
        K = self.K
        dt = pre_x.dtype
        G = cast(self.A, dt)                                    # (K, V, V)
        if self.ctr is not None or self.ada is not None:
            G = _graph_init(self.A, dt, self.per_frame)
        if self.ctr is not None:
            g = ACTS[self.ctr_act](x1[..., :, None] - x2[..., None, :])
            G = g * cast(_gate(self.alpha, K, 0, K, self.subset_wise,
                               g.dim() - 2), dt) + G
        if self.ada is not None:
            g = ACTS[self.ada_act](_ada_graph(x1, x2)[:, :, None])
            G = g * cast(_gate(self.beta, K, 0, K, self.subset_wise,
                               g.dim() - 2), dt) + G
        return _dispatch_contract(pre_x, G, self.ctr, self.ada)


class DGHGCN(nn.Module):
    """Semantic DG-GCN without subset decomposition (reference dghgcn,
    gcn.py:1586-1806; JAX ``dsgcn_tpu/ops/gcn.py:DGHGCN``): DGGCN's ctr and
    ada graphs with the semantic attentions on all K subsets.

    ``node_attention``: the queries ``conv1``/``conv2`` give P = num_types
    heads, gathered per joint by its node type (:func:`_type_gather`).
    ``edge_attention`` (ctr): the diff graph through ``edge_linears`` (K mid
    -> E K mid) and the per-edge class select (:func:`_edge_class_select`),
    plus the diff itself with ``add_type``.  ``ada_attention``: the
    outer-product graph through ``ada_linears`` (K -> E K) and the class
    select.  Both need T-pooled graphs, as JAX asserts.
    ``target_specific``: a per-node-type output 1x1 (``nodeconv``, gathered
    by joint type) added to ``post_conv`` after the aggregation
    (gcn.py:1791-1795).  The contraction is JAX's four-way einsum dispatch
    (:func:`_dispatch_contract`); JAX computes this unit outside any Pallas
    kernel, and so does the port: ``use_pallas`` is accepted, because the
    builder sets it on every DGSTGCN unit, and changes nothing.  (JAX's
    DGHGCN has no such field, so JAX's ``build_backbone`` refuses
    ``gcn_type='dghgcn'`` with a TypeError; its DGSTGCN built directly
    takes it.)"""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, edge_type: Optional[np.ndarray] = None,
                 node_type: Optional[np.ndarray] = None, ratio=0.25,
                 ctr="T", ada="T", node_attention=False,
                 edge_attention=False, ada_attention=False,
                 target_specific=False, add_type=False, num_types=5,
                 edge_num=15, subset_wise=False, ada_act="softmax",
                 ctr_act="tanh", use_pallas=False):
        super().__init__()
        self.per_frame = _graph_mode(ctr, ada)
        if self.per_frame and ((ctr is not None and edge_attention)
                               or (ada is not None and ada_attention)):
            raise ValueError("edge and ada attention require T-pooled "
                             "graphs")
        if node_attention or target_specific:
            if node_type is None:
                raise ValueError("node attention and target_specific need "
                                 "the graph's node types")
        if (edge_attention or ada_attention) and edge_type is None:
            raise ValueError("edge and ada attention need the graph's "
                             "edge types")
        K = A_init.shape[0]
        self.in_channels, self.out_channels, self.K = (in_channels,
                                                       out_channels, K)
        self.mid = mid = int((ratio if ratio is not None else 1.0 / K)
                             * out_channels)
        self.P, self.E = num_types, edge_num
        self.ctr, self.ada = ctr, ada
        self.ctr_act, self.ada_act = ctr_act, ada_act
        self.node_attention = node_attention
        self.edge_attention = edge_attention and ctr is not None
        self.ada_attention = ada_attention and ada is not None
        self.target_specific, self.add_type = target_specific, add_type
        self.subset_wise = subset_wise
        if in_channels != out_channels:
            self.down_conv = PointConv(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)
        # a copy: blocks are built from one numpy graph and must not share it
        self.A = nn.Parameter(torch.tensor(np.asarray(A_init),
                                           dtype=torch.float32))
        self.alpha = nn.Parameter(torch.zeros(K))
        self.beta = nn.Parameter(torch.zeros(K))
        self.pre_conv = PointConv(in_channels, mid * K)
        self.pre_bn = BatchNorm(mid * K)
        if ctr is not None or ada is not None:
            feats = K * mid * (num_types if node_attention else 1)
            self.conv1 = PointConv(in_channels, feats)
            self.conv2 = PointConv(in_channels, feats)
        if self.edge_attention:
            self.edge_linears = PointConv(K * mid, edge_num * K * mid)
        if self.ada_attention:
            self.ada_linears = PointConv(K, edge_num * K)
        if target_specific:
            self.nodeconv = PointConv(K * mid, num_types * out_channels)
        self.post_conv = PointConv(K * mid, out_channels)
        self.bn = BatchNorm(out_channels)
        for name, types in (("node_type", node_type),
                            ("edge_type", edge_type)):
            if types is not None:
                self.register_buffer(name, torch.as_tensor(
                    np.asarray(types), dtype=torch.long), persistent=False)

    def _queries(self, x: torch.Tensor):
        """x1, x2: (N, K, mid, Tq, V), Tq = 1 (T-pooled) or T ('NA')."""
        K, mid = self.K, self.mid
        tmp = x if self.per_frame else x.mean(dim=1, keepdim=True)
        n, tq, v, _ = tmp.shape

        def heads(y):
            if self.node_attention:            # (n, tq, K, mid, P, V)
                y = y.reshape(n, tq, v, K, mid, self.P).movedim(2, -1)
                y = _type_gather(y, self.node_type, type_axis=4)
                return y.permute(0, 2, 3, 1, 4)
            return y.reshape(n, tq, v, K, mid).permute(0, 3, 4, 1, 2)
        return heads(self.conv1(tmp)), heads(self.conv2(tmp))

    def _graph(self, x1, x2, dt):
        """The (1 | N, K, Cq, Tq, V, V) graph (JAX gcn.py:884-926)."""
        K, E, mid = self.K, self.E, self.mid
        n, V = x1.shape[0], self.A.shape[-1]
        G = cast(self.A, dt)[None, :, None, None]

        def gated(g, gates):
            gates = cast(gates, dt)
            return g * (gates.reshape(1, K, 1, 1, 1, 1) if self.subset_wise
                        else gates[0])
        if self.ctr is not None:
            diff = x1[..., :, None] - x2[..., None, :]     # (n,K,mid,tq,V,V)
            g = diff
            if self.edge_attention:
                d2 = diff[:, :, :, 0].reshape(n, K * mid, V, V).movedim(1, -1)
                es = self.edge_linears(d2).reshape(n, V, V, K, E, mid)
                es = es.permute(0, 3, 5, 4, 1, 2)          # (n,K,mid,E,V,V)
                g = _edge_class_select(es, self.edge_type)[:, :, :, None]
                if self.add_type:
                    g = diff + g
            G = gated(ACTS[self.ctr_act](g), self.alpha) + G
        if self.ada is not None:
            g = _ada_graph(x1, x2)[:, :, None]             # (n,K,1,tq,V,V)
            if self.ada_attention:
                gs = self.ada_linears(g[:, :, 0, 0].movedim(1, -1))
                gs = gs.reshape(n, V, V, K, E).permute(0, 3, 4, 1, 2)
                g = _edge_class_select(gs, self.edge_type)[:, :, None, None]
            G = gated(ACTS[self.ada_act](g), self.beta) + G
        return G

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        K, mid = self.K, self.mid
        n, t, v, c = x.shape
        res = (self.down_bn(self.down_conv(x)) if c != self.out_channels
               else x)
        pre_x = F.relu(self.pre_bn(self.pre_conv(x))).reshape(n, t, v, K,
                                                              mid)
        if self.ctr is None and self.ada is None:
            G = self.A
        else:
            G = self._graph(*self._queries(x), pre_x.dtype)
            if not self.per_frame:
                G = G[:, :, :, 0]                          # (N, K, Cq, V, V)
        y = _dispatch_contract(pre_x, G, self.ctr, self.ada).reshape(
            n, t, v, K * mid)
        out = self.post_conv(y)
        if self.target_specific:
            # a per-type output head gathered by joint type (gcn.py:1791)
            xn = self.nodeconv(y).reshape(n, t, v, self.P, self.out_channels)
            xn = _type_gather(xn.movedim(2, -1), self.node_type, type_axis=2)
            out = out + xn.movedim(2, -1)
        return F.relu(self.bn(out) + res)


class DGPHGCN1(nn.Module):
    """The DS-GCN dynamic semantic spatial graph conv (reference dgphgcn1,
    gcn.py:2074-2365).

    Subset decomposition into semantic/normal groups, per-node-type queries
    and per-edge-class attention on the diff graph.  Reproduces the
    reference quirks the JAX module keeps: x2 of the semantic subset is the
    ``conv1_se`` query x1 (gcn.py:2253-2254, 2272), and the edge-attention
    diff uses the subset slice [norm-sem : norm] (gcn.py:2279).  Submodule
    names follow the JAX module's flax scopes.

    ``target_specific`` (with ``decompose``): the semantic subsets' values
    come from a per-node-type 1x1 (``nodeconv_conv``/``nodeconv_bn``,
    gathered by node type), the normal ones' from ``pre_conv``, semantic
    first (gcn.py:2228-2234); these values take the same kernels, 'mega'
    excepted (JAX gcn.py:1154-1155): there K1 serves.  ``ada_attention``:
    the outer-product graph through ``ada_linears`` (K -> E K) and the edge
    class select (gcn.py:1241-1250), on the dense path only, as in JAX.
    ``ctr``/``ada`` 'NA' on either makes the graphs per frame (the queries
    not T-pooled; dense path only); edge and ada attention need T-pooled
    graphs and refuse 'NA' (JAX asserts it).  ``add_type`` is accepted
    with JAX's (lack of) effect: JAX's DGPHGCN1 declares it and never
    reads it.
    ``eval_kernel='mega'`` runs the whole eval block in K6, the
    edge-class attention included.  ``v_pad`` (joint-padded mode) keeps
    JAX's refusals, training, 'mega' and the dense path, and runs at the
    real joints (``ops/common.py:joint_pad_check``).

    ``graph_axis`` (the joint-partitioned mode, JAX gcn.py:1068-1083,
    :1261-1393): the DS-GCN form on the ring of :meth:`_jp_aggregate`
    (``down_bn``, ``pre_bn`` and ``bn`` synced over the axis), for ctr and
    ada 'T', tanh and softmax, without ``ada_attention`` or
    ``target_specific`` and, decomposed without edge attention, with
    sem == norm - sem; any other form raises, naming the option, as JAX
    asserts.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, edge_type: np.ndarray,
                 node_type: np.ndarray, ratio=0.125, decompose=False,
                 ctr="T", ada="T", node_attention=False, edge_attention=False,
                 ada_attention=False, target_specific=False, add_type=False,
                 sub_att=True, stage=True, num_types=5, edge_num=15,
                 subset_wise=True, ada_act="softmax", ctr_act="tanh",
                 use_pallas=False, eval_kernel="auto", graph_axis=None,
                 v_pad=0):
        super().__init__()
        self.graph_axis = graph_axis
        self.v_pad = v_pad
        self.per_frame = _graph_mode(ctr, ada)
        if eval_kernel not in ("auto", "bd", "fused", "mega"):
            raise ValueError(f"unknown eval_kernel {eval_kernel!r}")
        if not stage:   # gcn.py:2122-2127
            node_attention = edge_attention = decompose = False
            target_specific = subset_wise = False
        K = A_init.shape[0]
        self.in_channels, self.out_channels = in_channels, out_channels
        self.K = K
        self.mid = int((ratio if ratio is not None else 1.0 / K)
                       * out_channels)
        self.P, self.E = num_types, edge_num
        self.sem = math.ceil(K / 3) if decompose else 0
        self.norm = K - self.sem
        self.decompose, self.subset_wise = decompose, subset_wise
        self.node_attention, self.edge_attention = node_attention, \
            edge_attention
        self.target_specific = target_specific and decompose
        self.ada_attention = ada_attention and ada is not None
        if self.per_frame:      # JAX asserts these at its first call
            if ctr is not None and decompose and edge_attention:
                raise ValueError("edge attention requires T-pooled graphs")
            if self.ada_attention:
                raise ValueError("ada attention requires T-pooled graphs")
        self.ctr, self.ada = ctr, ada
        self.ctr_act, self.ada_act = ctr_act, ada_act
        self.use_pallas, self.eval_kernel = use_pallas, eval_kernel
        mid, sem, norm = self.mid, self.sem, self.norm
        if graph_axis is not None:
            _jp_form_check("DGPHGCN1", dict(
                ctr=(ctr, "T"), ada=(ada, "T"), ctr_act=(ctr_act, "tanh"),
                ada_act=(ada_act, "softmax"),
                ada_attention=(ada_attention, False),
                target_specific=(self.target_specific, False),
                v_pad=(v_pad, 0)))
            if sem and not (edge_attention and decompose) and \
                    sem != norm - sem:
                # the ring builds subset j's ctr from subset j's queries,
                # the reference's concat order only where [sem:norm] is
                # the identity placement (JAX gcn.py:1330-1335)
                raise NotImplementedError(
                    "DGPHGCN1 graph_axis: decompose without edge_attention "
                    f"needs sem == norm - sem (sem={sem}, norm={norm})")

        if in_channels != out_channels:
            self.down_conv = PointConv(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels, axis_name=graph_axis)
        # a copy: blocks are built from one numpy graph and must not share it
        self.A = nn.Parameter(torch.tensor(np.asarray(A_init),
                                           dtype=torch.float32))
        n_gates = K if sub_att else 3
        self.alpha = nn.Parameter(torch.zeros(n_gates))
        self.beta = nn.Parameter(torch.zeros(n_gates))
        if self.target_specific:
            self.nodeconv_conv = PointConv(in_channels, sem * num_types * mid)
            self.nodeconv_bn = BatchNorm(sem * num_types * mid)
        values = norm if self.target_specific else K
        self.pre_conv = PointConv(in_channels, mid * values)
        self.pre_bn = BatchNorm(mid * values, axis_name=graph_axis)
        if ctr is not None or ada is not None:
            self.conv1 = PointConv(in_channels, norm * mid)
            self.conv2 = PointConv(in_channels, norm * mid)
            if decompose:
                self.conv1_se = PointConv(
                    in_channels, sem * mid * (num_types if node_attention
                                              else 1))
                if ctr is not None and edge_attention:
                    self.edge_linears = PointConv(sem * mid,
                                                  edge_num * sem * mid)
        if self.ada_attention:
            self.ada_linears = PointConv(K, edge_num * K)
        self.post_conv = PointConv(K * mid, out_channels)
        self.bn = BatchNorm(out_channels, axis_name=graph_axis)
        # static graph structure: buffers that move with the module but are
        # not weights (not in the state_dict)
        self.register_buffer("node_type", torch.as_tensor(
            np.asarray(node_type), dtype=torch.long), persistent=False)
        self.register_buffer("edge_type", torch.as_tensor(
            np.asarray(edge_type), dtype=torch.long), persistent=False)
        self.register_buffer("edge_sel", torch.as_tensor(
            edge_onehot(np.asarray(edge_type), edge_num)), persistent=False)

    def _queries(self, x: torch.Tensor):
        """The queries x1, x2: (N, K, mid, V) T-pooled, (N, K, mid, T, V)
        per frame."""
        mid, sem, norm = self.mid, self.sem, self.norm
        tmp = x if self.per_frame else x.mean(dim=1, keepdim=True)
        n, tq, v, _ = tmp.shape

        def heads(y, k, *extra):          # (n, tq, v, k*mid*...) -> k first
            y = y.reshape(n, tq, v, k, mid, *extra)
            y = y.permute(0, 3, 4, *range(5, 5 + len(extra)), 1, 2)
            return y if self.per_frame else y[..., 0, :]
        x1, x2 = heads(self.conv1(tmp), norm), heads(self.conv2(tmp), norm)
        if not self.decompose:
            return x1, x2
        s = self.conv1_se(tmp)
        if self.node_attention:
            s = heads(s, sem, self.P)         # (n, sem, mid, P, [tq,] v)
            s = _type_gather(s, self.node_type, type_axis=3)
        else:
            s = heads(s, sem)
        # the reference concatenates x1_sem into x2 too (gcn.py:2272)
        return torch.cat([x1, s], dim=1), torch.cat([x2, s], dim=1)

    def _values(self, x: torch.Tensor) -> torch.Tensor:
        """pre_x (N, T, V, K*mid); with ``target_specific`` the semantic
        subsets' per-node-type values first (gcn.py:2228-2234)."""
        pre = F.relu(self.pre_bn(self.pre_conv(x)))
        if not self.target_specific:
            return pre
        n, t, v, _ = x.shape
        xn = F.relu(self.nodeconv_bn(self.nodeconv_conv(x)))
        xn = xn.reshape(n, t, v, self.sem, self.P, self.mid).movedim(2, -1)
        xn = _type_gather(xn, self.node_type, type_axis=3)  # (n,t,sem,mid,v)
        xn = xn.movedim(-1, 2).reshape(n, t, v, self.sem * self.mid)
        return torch.cat([xn, pre], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        K, mid, sem = self.K, self.mid, self.sem
        n, t, v, _ = x.shape
        joint_pad_check(self)
        if self.graph_axis is not None:
            return _jp_block(self, x, self._jp_aggregate)
        x1 = x2 = None
        if self.ctr is not None or self.ada is not None:
            x1, x2 = self._queries(x)
        active_edge = self.edge_attention and self.decompose
        kernel = (self.use_pallas and _graph_acts_ok(self)
                  and not self.ada_attention
                  and (not active_edge or sem == 1))
        if self.v_pad and not kernel:
            raise NotImplementedError(
                "joint-padded mode (v_pad) requires the kernel eval path "
                "(use_pallas with ctr/ada='T', tanh/softmax)")
        if self.v_pad and self.eval_kernel == "mega":
            raise ValueError(_MEGA_PADDED)
        if (kernel and not self.training and self.eval_kernel == "mega"
                and not self.target_specific):
            return self._mega(x, x1, x2, active_edge)
        res = (self.down_bn(self.down_conv(x))
               if self.in_channels != self.out_channels else x)
        pre_x = self._values(x)                                # (n,t,v,K*mid)
        if kernel:
            y = self._kernel_aggregate(pre_x, x1, x2, active_edge)
        else:
            y = self._dense_aggregate(pre_x.reshape(n, t, v, K, mid), x1, x2)
        y = self.bn(self.post_conv(y.reshape(n, t, v, K * mid)))
        return F.relu(y + res)

    def _kernel_aggregate(self, pre_x, x1, x2, active_edge):
        """The dynamic-graph kernels (JAX gcn.py:1119-1196): K1+K2 in
        training, ``eval_kernel`` in eval."""
        K, mid, sem, norm, E = self.K, self.mid, self.sem, self.norm, self.E
        n, t, v, _ = pre_x.shape
        a_vec = _gate_vec(self.alpha, K, sem, norm, self.subset_wise)
        b_vec = _gate_vec(self.beta, K, sem, norm, self.subset_wise)
        ek = "fused" if self.training else self.eval_kernel
        if ek == "auto":
            ek = "bd" if v * K * mid <= 2400 else "fused"
        edge_k = norm - sem if active_edge else -1
        if active_edge:
            ew, eb = self.edge_linears.weight, self.edge_linears.bias
        if ek == "bd":
            kw = {}
            if active_edge:
                # class projections P = W_e^T q of the edge subset's queries
                # and the transposed bias field, outside the kernel
                w = cast(ew, x1.dtype)
                p1 = torch.einsum("ncv,fc->nfv", x1[:, edge_k], w).reshape(
                    n, E, mid, v)
                p2 = torch.einsum("ncv,fc->nfv", x2[:, edge_k], w).reshape(
                    n, E, mid, v)
                ebias = torch.einsum("evw,ec->vcw", self.edge_sel,
                                     cast(eb, torch.float32).reshape(E, mid))
                kw = dict(p1t=p1.transpose(-1, -2), p2=p2,
                          edge_sel=self.edge_sel, ebias=ebias)
            return bd_dyn_graph_agg(
                pre_x.reshape(n, t, v * K * mid), x1.transpose(-1, -2), x2,
                self.A, a_vec, b_vec, K=K, Cm=mid, edge_k=edge_k,
                edge_num=E, **kw)
        if active_edge:
            return fused_dyn_graph_agg(pre_x, x1, x2, self.A, a_vec, b_vec,
                                       ew.t(), eb, self.edge_sel, K, mid,
                                       edge_k, E)
        return fused_dyn_graph_agg(pre_x, x1, x2, self.A, a_vec, b_vec,
                                   K=K, Cm=mid, edge_num=E)

    def _jp_aggregate(self, x, pre_x):
        """The joint-partitioned DS-GCN graph build and ring aggregation
        (JAX gcn.py:1261-1393): the node-type query gathers take the
        one-hot rows of this process's joints; the edge-class attention,
        linear in the diff, runs as the class projections P1/P2 of the
        edge subset's queries (the kernels' trick) with the class mask's
        blocks; the queries x1 are all-gathered and the values go round
        the ring (:func:`_ring_aggregate`).  As the reference: x2's
        semantic part is ``conv1_se``'s query, and the edge-attended subset
        is norm - sem."""
        K, mid, sem, norm, E = self.K, self.mid, self.sem, self.norm, self.E
        n, t, vl, _ = pre_x.shape
        ax = axis(self.graph_axis)
        g, V = ax.index, self.A.shape[-1]
        acc = accum_dtype(x.dtype)
        tmp = x.mean(dim=1)                                     # (n, vl, c)
        x1 = self.conv1(tmp).reshape(n, vl, norm, mid).permute(0, 2, 3, 1)
        x2 = self.conv2(tmp).reshape(n, vl, norm, mid).permute(0, 2, 3, 1)
        if sem:
            s = self.conv1_se(tmp)
            if self.node_attention:
                oh = F.one_hot(self.node_type[g * vl:(g + 1) * vl],
                               self.P).to(x.dtype)               # (vl, P)
                s = torch.einsum("nvsmp,vp->nsmv",
                                 s.reshape(n, vl, sem, mid, self.P), oh)
            else:
                s = s.reshape(n, vl, sem, mid).permute(0, 2, 3, 1)
            x1, x2 = torch.cat([x1, s], dim=1), torch.cat([x2, s], dim=1)
        x1f = all_gather(x1, ax.group, dim=-1)                 # (n,K,mid,V)
        ada = torch.softmax(torch.einsum("nkcv,nkcw->nkvw", cast(x1f, acc),
                                         cast(x2, acc)), dim=-2)
        a_vec = cast(_gate_vec(self.alpha, K, sem, norm, self.subset_wise),
                     x.dtype)[None, :, None, None, None]
        b_vec = cast(_gate_vec(self.beta, K, sem, norm, self.subset_wise),
                     x.dtype)[None, :, None, None]
        if not (self.edge_attention and sem):
            def gated(ctr, src):
                return ctr * a_vec
        else:
            lo = norm - sem               # the edge subsets [norm-sem, norm)
            w = cast(self.edge_linears.weight, x.dtype)     # (E sem mid, .)
            p1 = torch.einsum("ncv,ec->nev",
                              x1f[:, lo:norm].reshape(n, sem * mid, V), w)
            p1 = p1.reshape(n, sem, E, mid, V)
            p2 = torch.einsum("ncw,ec->new",
                              x2[:, lo:norm].reshape(n, sem * mid, vl), w)
            p2 = p2.reshape(n, sem, E, mid, vl)
            sel = cast(self.edge_sel[:, :, g * vl:(g + 1) * vl], x.dtype)
            bias = torch.einsum("evw,sec->scvw", sel, cast(
                self.edge_linears.bias, x.dtype).reshape(sem, E, mid))

            def gated(ctr, src):
                blk = slice(src * vl, (src + 1) * vl)
                ea = (torch.einsum("evw,nsecv->nscvw", sel[:, blk],
                                   p1[..., blk])
                      - torch.einsum("evw,nsecw->nscvw", sel[:, blk], p2)
                      + bias[None, :, :, blk])
                ctr = torch.cat([ctr[:, :lo], torch.tanh(ea), ctr[:, norm:]],
                                dim=1)
                return ctr * a_vec
        return _ring_aggregate(
            self.A, cast(ada, x.dtype), x1f, x2,
            pre_x.reshape(n, t, vl, K, mid), ax, gated, b_vec,
            acc).reshape(n, t, vl, K * mid)

    def _mega(self, x, x1, x2, active_edge):
        """The whole eval block in K6, the semantic queries and the edge
        attention of subset norm - sem included (JAX gcn.py:1154-1167)."""
        K, mid, sem, norm, E = self.K, self.mid, self.sem, self.norm, self.E
        w = fold_block_params(self, self.in_channels != self.out_channels)
        kw = {}
        if active_edge:
            kw = dict(edge_w=self.edge_linears.weight.t(),
                      edge_b=self.edge_linears.bias, edge_sel=self.edge_sel,
                      edge_k=norm - sem, edge_num=E)
        return fused_dggcn_block_eval(
            x, x1, x2, w[0], w[1], self.A,
            _gate_vec(self.alpha, K, sem, norm, self.subset_wise),
            _gate_vec(self.beta, K, sem, norm, self.subset_wise), *w[2:],
            K=K, Cm=mid, **kw)

    def _dense_aggregate(self, pre_x, x1, x2):
        """Materialized graph + einsum (JAX gcn.py:1206-1259); graphs are
        (N, K, Cq, [T,] V, V)."""
        K, mid, sem, norm, E = self.K, self.mid, self.sem, self.norm, self.E
        n, _, V = pre_x.shape[:3]
        dt = pre_x.dtype
        G = cast(self.A, dt)                                    # (K, V, V)
        if self.ctr is not None or self.ada is not None:
            G = _graph_init(self.A, dt, self.per_frame)
        if self.ctr is not None:
            def diff(lo, hi):
                return x1[:, lo:hi, ..., :, None] - x2[:, lo:hi, ..., None, :]
            if self.decompose:
                if self.edge_attention:
                    # slice [norm-sem : norm] per reference gcn.py:2279
                    d2 = diff(norm - sem, norm).reshape(n, sem * mid, V, V)
                    es = self.edge_linears(torch.movedim(d2, 1, -1))
                    es = es.reshape(n, V, V, sem, E, mid).permute(
                        0, 3, 5, 4, 1, 2)                     # (n,sem,mid,E,V,V)
                    g_sem = _edge_class_select(es, self.edge_type)
                else:
                    g_sem = diff(sem, norm)
                g = torch.cat([diff(0, norm - sem), g_sem, diff(norm, K)],
                              dim=1)
            else:
                g = diff(0, K)
            g = ACTS[self.ctr_act](g)                     # (n,K,mid,[T,]V,V)
            G = g * cast(_gate(self.alpha, K, sem, norm, self.subset_wise,
                               g.dim() - 2), dt) + G
        if self.ada is not None:
            g = _ada_graph(x1, x2)                              # (n,K,[T,]V,V)
            if self.ada_attention:
                gs = self.ada_linears(g.permute(0, 2, 3, 1))    # (n,V,V,K*E)
                gs = gs.reshape(n, V, V, K, E).permute(0, 3, 4, 1, 2)
                g = _edge_class_select(gs, self.edge_type)      # (n,K,V,V)
            g = ACTS[self.ada_act](g[:, :, None])
            G = g * cast(_gate(self.beta, K, sem, norm, self.subset_wise,
                               g.dim() - 2), dt) + G
        return _dispatch_contract(pre_x, G, self.ctr, self.ada)


# ---------------------------------------------------------------------------
# AAGCN and CTR-GCN units (no kernel: JAX computes them in XLA einsums)
# ---------------------------------------------------------------------------

def _conv1d(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` over the middle axis of channels-last (N, L, C) -> (N, L,
    out), in x's dtype."""
    b = None if conv.bias is None else cast(conv.bias, x.dtype)
    y = F.conv1d(x.transpose(1, 2), cast(conv.weight, x.dtype), b,
                 padding=conv.padding)
    return y.transpose(1, 2)


class AttentionChain(nn.Module):
    """Spatial -> temporal -> channel SE attention of AAGCN (reference
    unit_aagcn, gcn.py:445-458; JAX ``dsgcn_tpu/ops/gcn.py:AttentionChain``),
    each applied as ``y * sigmoid(s) + y``: a conv over the joints of the
    T-mean (an odd kernel of V or V - 1 joints), a k = 9 conv over the
    frames of the V-mean, and a C -> C/2 -> C bottleneck of the global
    mean.  ``conv_sa``/``conv_ta`` hold (1, C, k) ``Conv1d`` weights."""

    def __init__(self, channels: int, num_joints: int):
        super().__init__()
        ker = num_joints if num_joints % 2 else num_joints - 1
        self.conv_sa = nn.Conv1d(channels, 1, ker, padding=(ker - 1) // 2)
        self.conv_ta = nn.Conv1d(channels, 1, 9, padding=4)
        self.fc1c = PointConv(channels, channels // 2)
        self.fc2c = PointConv(channels // 2, channels)
        self.zero_init_()

    @torch.no_grad()
    def zero_init_(self):
        """JAX's zero initializers: both biases of the convs, fc1c's bias,
        and all of ``conv_ta`` and ``fc2c`` (the temporal and channel
        attention start at sigmoid(0) everywhere)."""
        for t in (self.conv_sa.bias, self.conv_ta.weight, self.conv_ta.bias,
                  self.fc1c.bias, self.fc2c.weight, self.fc2c.bias):
            t.zero_()

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(_conv1d(self.conv_sa, y.mean(dim=1)))  # (n, v, 1)
        y = y * s[:, None] + y
        s = torch.sigmoid(_conv1d(self.conv_ta, y.mean(dim=2)))  # (n, t, 1)
        y = y * s[:, :, None] + y
        s = torch.sigmoid(self.fc2c(F.relu(self.fc1c(y.mean(dim=(1, 2))))))
        return y * s[:, None, None, :] + y


class UnitAAHGCN(nn.Module):
    """AAGCN's unit in its semantic form (reference unit_aahgcn,
    gcn.py:462-632; JAX ``dsgcn_tpu/ops/gcn.py:UnitAAHGCN``), and with
    ``node_att`` and ``edge_att`` off the plain one (:class:`UnitAAGCN`),
    x (N, T, V, C_in) -> (N, T, V, C_out).

    Per subset i: with ``adaptive`` the data graph tanh(a^T b / (R T)) of
    two 1x1 embeddings ``conv_a{i}``/``conv_b{i}`` (R = C_out //
    coff_embedding) gated by ``alpha`` is added to the trained ``A[i]``;
    the aggregation runs in :func:`accum_dtype` and rounds to x's type, as
    JAX's einsum does; ``conv_d{i}`` maps each aggregate to C_out and the
    subsets are summed.  Then ``bn`` (initial scale 1e-6), the residual
    (``down_conv``/``down_bn`` where the width changes), ReLU and, with
    ``attention``, :class:`AttentionChain`.

    The semantic options: ``node_att`` gives the embeddings ``num_types``
    channel groups and each joint keeps its body part's; ``edge_att`` maps
    the data graph through a 1 -> E 1x1 (``conv_edge{i}``) and each joint
    pair keeps its edge class's map.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, edge_type: Optional[np.ndarray] = None,
                 node_type: Optional[np.ndarray] = None,
                 node_att: bool = False, edge_att: bool = False,
                 num_types: int = 5, edge_num: int = 15,
                 coff_embedding: int = 4, adaptive: bool = True,
                 attention: bool = True):
        super().__init__()
        K, V, _ = A_init.shape
        self.K, self.out_channels = K, out_channels
        self.inter = out_channels // coff_embedding
        self.adaptive, self.attention = adaptive, attention
        self.P = num_types
        self.node_att = node_att and adaptive
        self.edge_att = edge_att and adaptive
        # a copy: blocks are built from one numpy graph and must not share it
        A = torch.tensor(np.asarray(A_init), dtype=torch.float32)
        if adaptive:
            self.A = nn.Parameter(A)
            self.alpha = nn.Parameter(torch.zeros(1))
        else:                      # a constant, as in JAX: not in the state
            self.register_buffer("A", A, persistent=False)
        qk = self.inter * (num_types if self.node_att else 1)
        for i in range(K):
            if adaptive:
                self.add_module(f"conv_a{i}", PointConv(in_channels, qk))
                self.add_module(f"conv_b{i}", PointConv(in_channels, qk))
                if self.edge_att:
                    self.add_module(f"conv_edge{i}", PointConv(1, edge_num))
            self.add_module(f"conv_d{i}", PointConv(in_channels,
                                                    out_channels))
        if in_channels != out_channels:
            self.down_conv = PointConv(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)
        self.bn = BatchNorm(out_channels)
        with torch.no_grad():
            self.bn.weight.fill_(1e-6)
        if attention:
            self.att = AttentionChain(out_channels, V)
        if self.node_att:
            self.register_buffer("node_type", torch.as_tensor(
                np.asarray(node_type), dtype=torch.long), persistent=False)
        if self.edge_att:
            self.register_buffer("edge_type", torch.as_tensor(
                np.asarray(edge_type), dtype=torch.long), persistent=False)

    def _embed(self, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """(N, T, V, R): a 1x1 embedding, per joint of its type's group
        with ``node_att``."""
        e = conv(x)
        if not self.node_att:
            return e
        n, t, v, _ = x.shape
        e = e.reshape(n, t, v, self.inter, self.P).movedim(2, -1)
        return _type_gather(e, self.node_type, type_axis=3).movedim(-1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, v, c = x.shape
        acc = accum_dtype(x.dtype)
        A = cast(self.A, acc)
        y = None
        for i in range(self.K):
            Ai = A[i]
            if self.adaptive:
                a = self._embed(getattr(self, f"conv_a{i}"), x)
                b = self._embed(getattr(self, f"conv_b{i}"), x)
                g = cast(torch.tanh(torch.einsum(
                    "ntvc,ntwc->nvw", cast(a, acc), cast(b, acc))
                    / (self.inter * t)), x.dtype)
                if self.edge_att:
                    es = getattr(self, f"conv_edge{i}")(g[..., None])
                    g = _edge_class_select(es.movedim(-1, 1), self.edge_type)
                Ai = Ai + cast(g, acc) * cast(self.alpha[0], acc)
                z = torch.einsum("ntvc,nvw->ntwc", cast(x, acc), Ai)
            else:
                z = torch.einsum("ntvc,vw->ntwc", cast(x, acc), Ai)
            z = getattr(self, f"conv_d{i}")(cast(z, x.dtype))
            y = z if y is None else y + z
        res = (self.down_bn(self.down_conv(x))
               if c != self.out_channels else x)
        y = F.relu(self.bn(y) + res)
        return self.att(y) if self.attention else y


class UnitAAGCN(UnitAAHGCN):
    """2s-AGCN's adaptive unit (reference unit_aagcn, gcn.py:349-461; JAX
    ``dsgcn_tpu/ops/gcn.py:UnitAAGCN``): :class:`UnitAAHGCN` without the
    semantic options."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, coff_embedding: int = 4,
                 adaptive: bool = True, attention: bool = True):
        super().__init__(in_channels, out_channels, A_init,
                         coff_embedding=coff_embedding, adaptive=adaptive,
                         attention=attention)


class CTRGC(nn.Module):
    """Channel-wise topology refinement (reference CTRGC, gcn.py:634-659;
    JAX ``dsgcn_tpu/ops/gcn.py:CTRGC``): the T-mean embeddings x1, x2 (R =
    8 channels at C_in <= 16, else C_in // rel_reduction), the per-channel
    graph ``conv4(tanh(x1_u - x2_w)) * alpha + A`` (N, U, W, C_out), and
    the aggregation of ``conv3(x)`` over it, in :func:`accum_dtype`."""

    def __init__(self, in_channels: int, out_channels: int,
                 rel_reduction: int = 8):
        super().__init__()
        rel = 8 if in_channels <= 16 else in_channels // rel_reduction
        self.conv1 = PointConv(in_channels, rel)
        self.conv2 = PointConv(in_channels, rel)
        self.conv3 = PointConv(in_channels, out_channels)
        self.conv4 = PointConv(rel, out_channels)

    def forward(self, x: torch.Tensor, A: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
        acc = accum_dtype(x.dtype)
        x1 = self.conv1(x).mean(dim=1)                          # (n, v, r)
        x2 = self.conv2(x).mean(dim=1)
        x3 = self.conv3(x)
        g = self.conv4(torch.tanh(x1[:, :, None] - x2[:, None]))  # (n,u,w,c)
        g = cast(g, acc) * cast(alpha, acc) + cast(A, acc)[None, :, :, None]
        return cast(torch.einsum("nuwc,ntuc->ntwc", g, cast(x3, acc)),
                    x.dtype)


class CTRHGC(nn.Module):
    """The semantic CTR-GC (reference CTRHGC, gcn.py:668-776; JAX
    ``dsgcn_tpu/ops/gcn.py:CTRHGC``).  Where ``semantic_index`` is set:
    ``node_attention`` gives x1/x2 a channel group per body part, each
    joint keeping its own; ``edge_attention`` maps the diff topology to E
    edge classes (``edge_att_conv``, R or, with ``full_channels``, C_out
    channels a class) and keeps each pair's class, then ``conv4`` unless
    ``full_channels``, plus ``conv4`` of the plain diff with ``add_type``
    (one ``conv4`` for both); ``target_specific`` adds a per-part value
    1x1 (``nodeconv``).  ``ada`` adds the graph x1^T x2 gated by ``beta``.
    Graph and aggregation in :func:`accum_dtype`."""

    def __init__(self, in_channels: int, out_channels: int,
                 edge_type: Optional[np.ndarray] = None,
                 node_type: Optional[np.ndarray] = None,
                 rel_reduction: int = 8, node_attention: bool = True,
                 edge_attention: bool = False, target_specific: bool = False,
                 full_channels: bool = False, add_type: bool = False,
                 ada: bool = False, num_types: int = 5, edge_num: int = 15,
                 semantic_index: bool = False):
        super().__init__()
        self.rel = rel = (8 if in_channels <= 16
                          else in_channels // rel_reduction)
        self.out_channels, self.P, self.E = out_channels, num_types, edge_num
        self.node_att = node_attention and semantic_index
        self.edge_att = edge_attention and semantic_index
        self.tgt = target_specific and semantic_index
        self.full_channels, self.add_type, self.ada = (full_channels,
                                                       add_type, ada)
        qk = rel * (num_types if self.node_att else 1)
        self.conv1 = PointConv(in_channels, qk)
        self.conv2 = PointConv(in_channels, qk)
        self.conv3 = PointConv(in_channels, out_channels)
        # flax makes conv4 only where it is called
        if not self.edge_att or not full_channels or add_type:
            self.conv4 = PointConv(rel, out_channels)
        if self.edge_att:
            self.out_f = out_channels if full_channels else rel
            self.edge_att_conv = PointConv(rel, edge_num * self.out_f)
            self.register_buffer("edge_type", torch.as_tensor(
                np.asarray(edge_type), dtype=torch.long), persistent=False)
        if ada:
            self.beta = nn.Parameter(torch.zeros(1))
        if self.tgt:
            self.nodeconv = PointConv(in_channels, num_types * out_channels)
        if self.node_att or self.tgt:
            self.register_buffer("node_type", torch.as_tensor(
                np.asarray(node_type), dtype=torch.long), persistent=False)

    def _query(self, q: torch.Tensor) -> torch.Tensor:
        """(N, T, V, qk) -> the T-mean (N, R, V)."""
        n, t, v, _ = q.shape
        if self.node_att:
            q = q.reshape(n, t, v, self.rel, self.P).movedim(2, -1)
            return _type_gather(q, self.node_type, type_axis=3).mean(dim=1)
        return q.mean(dim=1).transpose(1, 2)

    def _conv4(self, g: torch.Tensor) -> torch.Tensor:
        """conv4 over the channel axis 1 of (N, R, V, V)."""
        return self.conv4(g.movedim(1, -1)).movedim(-1, 1)

    def forward(self, x: torch.Tensor, A: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
        n, t, v, _ = x.shape
        acc = accum_dtype(x.dtype)
        x1, x2 = self._query(self.conv1(x)), self._query(self.conv2(x))
        x3 = self.conv3(x)
        diff = torch.tanh(x1[..., :, None] - x2[..., None, :])  # (n,r,v,v)
        if self.edge_att:
            es = self.edge_att_conv(diff.movedim(1, -1))
            es = es.reshape(n, v, v, self.E, self.out_f).permute(0, 4, 3, 1,
                                                                 2)
            graph = _edge_class_select(es, self.edge_type)    # (n,f,v,v)
            if not self.full_channels:
                graph = self._conv4(graph)
            if self.add_type:
                graph = graph + self._conv4(diff)
        else:
            graph = self._conv4(diff)                          # (n,c,v,v)
        G = cast(graph, acc) * cast(alpha, acc) + cast(A, acc)[None, None]
        if self.ada:
            ada = torch.einsum("ncv,ncw->nvw", x1, x2)[:, None]
            G = cast(ada, acc) * cast(self.beta[0], acc) + G
        if self.tgt:
            xn = self.nodeconv(x).reshape(n, t, v, self.P,
                                          self.out_channels).movedim(2, -1)
            xn = _type_gather(xn, self.node_type, type_axis=2)  # (n,t,c,v)
            x3 = x3 + xn.movedim(2, -1)
        return cast(torch.einsum("ncuw,ntuc->ntwc", G, cast(x3, acc)),
                    x.dtype)


class _UnitCTR(nn.Module):
    """The K-subset wrapper of CTR-GCN's units: ``convs{i}`` on ``A[i]``
    with its gate, summed, ``bn`` (initial scale 1e-6), the residual
    (``down_conv``/``down_bn`` where the width changes) and ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, n_gates: int, make_conv):
        super().__init__()
        K = A_init.shape[0]
        self.K, self.in_channels, self.out_channels = (K, in_channels,
                                                       out_channels)
        # a copy: blocks are built from one numpy graph and must not share it
        self.A = nn.Parameter(torch.tensor(np.asarray(A_init),
                                           dtype=torch.float32))
        self.alpha = nn.Parameter(torch.zeros(n_gates))
        for i in range(K):
            self.add_module(f"convs{i}", make_conv(i))
        self.bn = BatchNorm(out_channels)
        with torch.no_grad():
            self.bn.weight.fill_(1e-6)
        if in_channels != out_channels:
            self.down_conv = PointConv(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = None
        for i in range(self.K):
            gate = self.alpha[i if self.alpha.shape[0] > 1 else 0]
            z = getattr(self, f"convs{i}")(x, self.A[i], gate)
            y = z if y is None else y + z
        y = self.bn(y)
        res = (self.down_bn(self.down_conv(x))
               if self.in_channels != self.out_channels else x)
        return F.relu(y + res)


class UnitCTRGCN(_UnitCTR):
    """CTR-GCN's unit (reference unit_ctrgcn, gcn.py:882-929; JAX
    ``dsgcn_tpu/ops/gcn.py:UnitCTRGCN``): a :class:`CTRGC` per subset, one
    gate ``alpha`` of shape (1,) shared by all."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray):
        super().__init__(in_channels, out_channels, A_init, 1,
                         lambda i: CTRGC(in_channels, out_channels))


class UnitCTRHGCN(_UnitCTR):
    """The semantic CTR-GCN unit (reference unit_ctrhgcn, gcn.py:778-880;
    JAX ``dsgcn_tpu/ops/gcn.py:UnitCTRHGCN``): a :class:`CTRHGC` per subset
    with its own gate (``alpha`` of shape (K,)).  It keeps the reference's
    branch-toggle quirk: node attention is off in every subset whatever
    ``node_attention`` says, and edge attention is on in subset 0 only."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, edge_type: Optional[np.ndarray] = None,
                 node_type: Optional[np.ndarray] = None,
                 semantic_index: bool = False, rel_reduction: int = 8,
                 node_attention: bool = False, edge_attention: bool = False,
                 target_specific: bool = False, full_channels: bool = False,
                 add_type: bool = False, ada: bool = False,
                 num_types: int = 5, edge_num: int = 15):
        def make_conv(i):
            return CTRHGC(in_channels, out_channels, edge_type=edge_type,
                          node_type=node_type, rel_reduction=rel_reduction,
                          node_attention=False,
                          edge_attention=edge_attention and i == 0,
                          target_specific=target_specific,
                          full_channels=full_channels, add_type=add_type,
                          ada=ada, num_types=num_types, edge_num=edge_num,
                          semantic_index=semantic_index)
        super().__init__(in_channels, out_channels, A_init, A_init.shape[0],
                         make_conv)


def _adaptive_graph(mod: nn.Module, A_init: np.ndarray, adaptive,
                    pa_shape) -> None:
    """The unit's graph as JAX's GTGCN and STGIN units keep it: 'init' a
    parameter ``A`` (a copy of ``A_init``), 'offset' a ``PA`` of
    ``pa_shape`` drawn from U(0, 2e-6) (``A + PA - 1e-6`` in the forward),
    'importance' a ``PA`` of ones (``A * PA``), None the fixed graph; the
    fixed ``A`` is a non-persistent buffer, as it is no JAX variable."""
    if adaptive not in (None, "init", "offset", "importance"):
        raise ValueError(f"unknown adaptive {adaptive!r}")
    mod.adaptive = adaptive
    A = torch.tensor(np.asarray(A_init), dtype=torch.float32)
    if adaptive == "init":
        mod.A = nn.Parameter(A)
    else:
        mod.register_buffer("A", A, persistent=False)
    if adaptive == "offset":
        mod.PA = nn.Parameter(torch.empty(pa_shape).uniform_(0, 2e-6))
    elif adaptive == "importance":
        mod.PA = nn.Parameter(torch.ones(pa_shape))


def _graph_of(mod: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """The effective (K, V, V) graph of :func:`_adaptive_graph`'s unit."""
    A = cast(mod.A, dtype)
    if mod.adaptive == "offset":
        return A + (cast(mod.PA, dtype) - 1e-6)
    if mod.adaptive == "importance":
        return A * cast(mod.PA, dtype)
    return A


def _onehot(types: np.ndarray, num: int) -> torch.Tensor:
    return torch.from_numpy(np.eye(num, dtype=np.float32)[
        np.asarray(types, np.int64)])


class GTGC(nn.Module):
    """Graph-transformer graph conv (reference GTGC, gcn.py:1054-1222; JAX
    ``dsgcn_tpu/ops/gcn.py:GTGC``).

    Per-(subset, node-type) key/query projections (``k_linears``,
    ``q_linears``; channel order ``(k*Cm + c)*P + p``, gcn.py:1094-1095)
    are gathered per joint by its node type and averaged over time; their
    pairwise difference k[u] - q[w] is the edge-attention field, through a
    ReLU, or with ``edge_attention`` through the per-edge-class projection
    ``edge_linears`` and the class select.  ``A_eff = alpha * field + A``
    (+ ``beta`` times the global k.q graph with ``global_attention``); the
    relu'd ``pre_conv``/``pre_bn`` features are aggregated over the source
    joints per (subset, channel), then ``out_linears`` (one per node type,
    gathered per joint, with ``target_specific``).  The node- and
    edge-type one-hots are non-persistent buffers."""

    def __init__(self, in_channels: int, out_channels: int, K: int,
                 edge_attention: bool = False, target_specific: bool = False,
                 num_types: int = 5, reduce: int = 8, edge_num: int = 15,
                 global_attention: bool = False,
                 node_type: Optional[np.ndarray] = None,
                 edge_type: Optional[np.ndarray] = None):
        super().__init__()
        if node_type is None:
            raise ValueError("GTGC needs the graph's node types")
        if edge_attention and edge_type is None:
            raise ValueError("edge attention needs the graph's edge types")
        self.K, self.Cm, self.P, self.E = (K, out_channels // reduce,
                                           num_types, edge_num)
        self.out_channels = out_channels
        self.edge_attention = edge_attention
        self.target_specific = target_specific
        self.global_attention = global_attention
        KC = K * self.Cm
        self.pre_conv = PointConv(in_channels, KC)
        self.pre_bn = BatchNorm(KC)
        self.k_linears = PointConv(in_channels, KC * num_types)
        self.q_linears = PointConv(in_channels, KC * num_types)
        if edge_attention:
            self.edge_linears = PointConv(KC, K * edge_num * self.Cm)
            self.register_buffer("edge_onehot", _onehot(edge_type, edge_num),
                                 persistent=False)
        self.alpha = nn.Parameter(torch.zeros(1))
        if global_attention:
            self.beta = nn.Parameter(torch.zeros(1))
        self.out_linears = PointConv(
            KC, (num_types if target_specific else 1) * out_channels)
        self.register_buffer("node_onehot", _onehot(node_type, num_types),
                             persistent=False)

    def forward(self, x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        n, t, v, _ = x.shape
        K, Cm, P = self.K, self.Cm, self.P
        acc, dt = accum_dtype(x.dtype), x.dtype
        pre = F.relu(self.pre_bn(self.pre_conv(x))).reshape(n, t, v, K, Cm)
        nt = cast(self.node_onehot, acc)

        def semantic(lin):
            # per-joint type gather and time mean (gcn.py:1096-1099)
            y = lin(x).reshape(n, t, v, K, Cm, P)
            return cast(torch.einsum("ntvkcp,vp->nkcv", cast(y, acc), nt),
                        dt) / t
        k_sem, q_sem = semantic(self.k_linears), semantic(self.q_linears)
        diff = k_sem[..., :, None] - q_sem[..., None, :]   # (n, K, Cm, u, w)
        if self.edge_attention:
            # per-edge-class projection of the diff field (gcn.py:1168-1178)
            flat = diff.permute(0, 3, 4, 1, 2).reshape(n, v, v, K * Cm)
            es = self.edge_linears(flat).reshape(n, v, v, K, self.E, Cm)
            field = cast(torch.einsum("nuwkec,uwe->nkcuw", cast(es, acc),
                                      cast(self.edge_onehot, acc)), dt)
        else:
            field = F.relu(diff)                         # (gcn.py:1196)
        A_eff = field * cast(self.alpha[0], dt) + cast(A, dt)[None, :, None]
        if self.global_attention:
            glo = cast(torch.einsum("nkcv,nkcw->nkvw", cast(k_sem, acc),
                                    cast(q_sem, acc)), dt)
            A_eff = A_eff + glo[:, :, None] * cast(self.beta[0], dt)
        # aggregate the source joints u (gcn.py:1212/1219)
        y = cast(torch.einsum("ntukc,nkcuv->ntvkc", cast(pre, acc),
                              cast(A_eff, acc)), dt).reshape(n, t, v, K * Cm)
        y = self.out_linears(y)
        if self.target_specific:
            y = y.reshape(n, t, v, P, self.out_channels)
            y = cast(torch.einsum("ntvpo,vp->ntvo", cast(y, acc), nt), dt)
        return y


class UnitGTGCN(nn.Module):
    """unit_gtgcn (reference gcn.py:1224-1294; JAX ``UnitGTGCN``):
    :class:`GTGC` (``convs``) + BN + the residual (x, or ``down_conv`` +
    ``down_bn`` where the width changes) + ReLU.  ``adaptive``: 'init' a
    trained ``A``; 'offset' and 'importance' a (V, V) ``PA`` broadcast over
    the K subsets (gcn.py:1281-1284); None the fixed graph."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, adaptive="init",
                 edge_attention: bool = False, target_specific: bool = False,
                 global_attention: bool = False, num_types: int = 5,
                 reduce: int = 8, edge_num: int = 15, residual: bool = True,
                 node_type: Optional[np.ndarray] = None,
                 edge_type: Optional[np.ndarray] = None):
        super().__init__()
        _adaptive_graph(self, A_init, adaptive, A_init.shape[1:])
        self.convs = GTGC(in_channels, out_channels, A_init.shape[0],
                          edge_attention=edge_attention,
                          target_specific=target_specific,
                          num_types=num_types, reduce=reduce,
                          edge_num=edge_num,
                          global_attention=global_attention,
                          node_type=node_type, edge_type=edge_type)
        self.bn = BatchNorm(out_channels)
        self.residual = residual
        self.identity = in_channels == out_channels
        if residual and not self.identity:
            self.down_conv = PointConv(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.convs(x, _graph_of(self, accum_dtype(x.dtype))))
        if self.residual:
            y = y + (x if self.identity
                     else self.down_bn(self.down_conv(x)))
        return F.relu(y)


class UnitGCNEdge(nn.Module):
    """unit_gcnedge (reference gcn.py:212-323; JAX ``UnitGCNEdge``): a graph
    conv with explicit edge representations for STGIN.

    The spatial edge e[u, w] of x's joints is projected with (x_u, x_w,
    e_uw) per subset (``edge_conv``, one 1x1 over the concatenation of
    gcn.py:318-323, applied here as three products of its column blocks
    so that the (N, T, V, V, 3C) concatenation is never built); the nodes
    (``conv``) aggregate through A, the edges through an A-weighted sum
    over the targets; the spatial edges come out summed over the subsets,
    the temporal edges through ``edge_conv_T`` where their width differs.
    One ``bn`` normalizes the node output, the spatial edges and the
    temporal edges in turn (gcn.py:313): in training each call moves its
    running statistics from the last call's values, in JAX as in torch.
    ``adaptive`` as :class:`UnitGTGCN`'s but with a (K, V, V) ``PA``
    (default 'importance').  Only ``conv_pos='pre'``: JAX refuses 'post'
    (the reference's branch is shape-inconsistent, gcn.py:298-305).
    ``edge_t_channels``: the width of the temporal edges it is given."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, adaptive="importance",
                 conv_pos: str = "pre", with_res: bool = False,
                 edge_t_channels: Optional[int] = None):
        super().__init__()
        if conv_pos != "pre":
            raise ValueError("conv_pos must be 'pre': the reference's "
                             "'post' branch is dead code (gcn.py:298-305)")
        K = A_init.shape[0]
        self.K, self.out_channels = K, out_channels
        _adaptive_graph(self, A_init, adaptive, A_init.shape)
        self.with_res = with_res
        if with_res and in_channels != out_channels:
            self.down_conv = PointConv(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)
        self.conv = PointConv(in_channels, out_channels * K)
        self.edge_conv = PointConv(3 * in_channels, out_channels * K)
        if (edge_t_channels or out_channels) != out_channels:
            self.edge_conv_T = PointConv(edge_t_channels, out_channels)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, edge_s: torch.Tensor,
                edge_t: torch.Tensor):
        n, t, v, c = x.shape
        K, O = self.K, self.out_channels
        acc, dt = accum_dtype(x.dtype), x.dtype
        A = _graph_of(self, acc)
        res = 0.0
        if self.with_res:
            res = (self.down_bn(self.down_conv(x))
                   if c != O else x)
        node = self.conv(x).reshape(n, t, v, K, O)
        # edge_conv over (x_u, x_w, e_uw), its kernel split by input block
        w = cast(self.edge_conv.weight, dt)
        xu = F.linear(x, w[:, :c])
        xw = F.linear(x, w[:, c:2 * c])
        efull = (F.linear(edge_s.reshape(n, t, v, v, -1), w[:, 2 * c:],
                          cast(self.edge_conv.bias, dt))
                 + xu[:, :, :, None] + xw[:, :, None])
        efull = efull.reshape(n, t, v, v, K, O)
        node_only = torch.einsum("ntvko,kvw->ntwo", cast(node, acc), A)
        edge_only = torch.einsum("ntvwko,kvw->ntvo", cast(efull, acc), A)
        y = cast(node_only + edge_only, dt)
        edge_s_out = efull.sum(dim=4)                    # (n, t, v, v, O)
        if hasattr(self, "edge_conv_T"):
            edge_t = self.edge_conv_T(edge_t)
        y = F.relu(self.bn(y) + res)
        es = F.relu(self.bn(edge_s_out.reshape(n, t, v * v, O)))
        et = F.relu(self.bn(edge_t))
        return y, es.reshape(n, t, v, v, O), et
