"""The nested copy's sparse family (port of ``dsgcn_tpu/sparse/nested.py``):
``SparseAAGCN``, ``SparseDGSTGCN`` and ``AssembleSparse`` (reference
``pyskl/pyskl/models/gcns/{aagcn_sparse,dggcn_sparse,Assemble_sparse}.py``).

Every conv but AAGCN's attention chain carries a ``score`` masked at a
threshold (``SparseDenseAt``/``SparseTemporalConvAt``): each stage's is
the percentile of its pooled scores at the sparsity (``pooled_threshold``
over ``_all_score_pool``), one per (stage, branch) in ``AssembleSparse``.
JAX's quirks are kept: AAGCN's residual conv is masked at threshold 0, the
DG block's at the stage threshold; Assemble's branch blocks all have a
residual, the first stage's too.  The reference runs the DG block's
residual ``unit_tcn_sparse`` twice a step (a try and its else), which JAX
does not copy; nor does the port.  The parameters exist before the first
forward, so there is no init-time pass at threshold -inf.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..graph import Graph, GraphConfig
from ..models.backbones import stage_plan
from ..ops.common import BatchNorm, cast
from ..ops.common import dropout as _dropout
from ..ops.gcn import ACTS, AttentionChain, _dispatch_contract
from .models import (NTU, SparseCTRGCNBlock, SparseDenseAt, SparseMSTCN,
                     SparseSTGCNBlockExact, SparseTemporalConvAt,
                     _all_score_pool, _data_bn, _graph_param, _SparseBackbone)
from .supermask import pooled_threshold, sparsity_schedule

DG_RANDOM = GraphConfig(layout="nturgb+d", mode="random", num_filter=8,
                        init_off=0.04, init_std=0.02)


class SparseUnitTCN(nn.Module):
    """unit_tcn_sparse (tcn_sparse.py:12-41): a k x 1 ``conv`` masked at
    the threshold, ``bn``, dropout in training (``self.generator``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, dilation: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.conv = SparseTemporalConvAt(in_channels, out_channels,
                                         kernel_size, stride, dilation)
        self.bn = BatchNorm(out_channels)
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, threshold) -> torch.Tensor:
        y = self.bn(self.conv(x, threshold))
        return _dropout(y, self.dropout, self.training, self.generator)


def _block_residual(module: nn.Module, in_c: int, out_c: int, stride: int,
                    residual: bool) -> None:
    module.res_kind = ("zero" if not residual else
                       "identity" if in_c == out_c and stride == 1 else
                       "conv")
    if module.res_kind == "conv":
        module.residual = SparseUnitTCN(in_c, out_c, kernel_size=1,
                                        stride=stride)


def _block_res(module: nn.Module, x: torch.Tensor, threshold):
    if module.res_kind == "zero":
        return 0.0
    if module.res_kind == "identity":
        return x
    return module.residual(x, threshold)


# ---------------------------------------------------------------------------
# AAGCN_sparse (nested aagcn_sparse.py:12-232)
# ---------------------------------------------------------------------------

class SparseUnitAAGCN(nn.Module):
    """unit_aagcn_sparse of the nested copy (gcn_sparse.py:101-218).  With
    ``adaptive``, each subset i adds ``alpha`` (zero at init) times
    tanh(a . b / (inter_c T)) of two masked 1x1 embeddings ``conv_a{i}``,
    ``conv_b{i}`` to its trained ``A[i]``; without, the fixed graph.  Each
    subset's aggregation goes through a masked ``conv_d{i}``; the sum
    through ``bn``, plus the residual (``down_conv`` + ``down_bn`` when
    the width changes), ReLU, then the plain :class:`AttentionChain`
    ``att`` (never masked)."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, coff_embedding: int = 4,
                 adaptive: bool = True, attention: bool = True):
        super().__init__()
        self.K = A_init.shape[0]
        self.inter_c = out_channels // coff_embedding
        self.adaptive, self.attention = adaptive, attention
        if adaptive:
            self.A = _graph_param(A_init)
            self.alpha = nn.Parameter(torch.zeros(1))
        else:
            self.register_buffer("A", torch.tensor(np.array(A_init,
                                                            np.float32)),
                                 persistent=False)
        for i in range(self.K):
            if adaptive:
                self.add_module(f"conv_a{i}", SparseDenseAt(in_channels,
                                                            self.inter_c))
                self.add_module(f"conv_b{i}", SparseDenseAt(in_channels,
                                                            self.inter_c))
            self.add_module(f"conv_d{i}", SparseDenseAt(in_channels,
                                                        out_channels))
        self.down = in_channels != out_channels
        if self.down:
            self.down_conv = SparseDenseAt(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)
        self.bn = BatchNorm(out_channels)
        if attention:
            self.att = AttentionChain(out_channels, A_init.shape[1])

    def forward(self, x: torch.Tensor, threshold) -> torch.Tensor:
        t = x.shape[1]
        A = cast(self.A, x.dtype)
        y = 0.0
        for i in range(self.K):
            Ai = A[i]
            if self.adaptive:
                a = getattr(self, f"conv_a{i}")(x, threshold)
                b = getattr(self, f"conv_b{i}")(x, threshold)
                g = torch.tanh(torch.einsum("ntvc,ntwc->nvw", a, b)
                               / (self.inter_c * t))
                Ai = Ai + g * cast(self.alpha[0], x.dtype)
                z = torch.einsum("ntvc,nvw->ntwc", x, Ai)
            else:
                z = torch.einsum("ntvc,vw->ntwc", x, Ai)
            y = y + getattr(self, f"conv_d{i}")(z, threshold)
        res = self.down_bn(self.down_conv(x, threshold)) if self.down else x
        y = torch.relu(self.bn(y) + res)
        return self.att(y) if self.attention else y


class SparseAAGCNBlock(nn.Module):
    """AAGCNBlock of the nested copy (aagcn_sparse.py:12-63): ``gcn``
    (:class:`SparseUnitAAGCN`), the 9 x 1 ``tcn`` (:class:`SparseUnitTCN`)
    and the residual.  JAX's quirk, kept: the residual unit is masked at
    threshold 0 (``res = self.residual(x)``, :59), not the stage's."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True,
                 gcn_adaptive: bool = True, gcn_attention: bool = True):
        super().__init__()
        _block_residual(self, in_channels, out_channels, stride, residual)
        self.gcn = SparseUnitAAGCN(in_channels, out_channels, A,
                                   adaptive=gcn_adaptive,
                                   attention=gcn_attention)
        self.tcn = SparseUnitTCN(out_channels, out_channels, 9, stride)

    def forward(self, x: torch.Tensor, threshold) -> torch.Tensor:
        res = _block_res(self, x, 0.0)
        return torch.relu(self.tcn(self.gcn(x, threshold), threshold) + res)


class _PerStageBackbone(_SparseBackbone):
    """A nested backbone: one threshold a stage, the percentile of all of
    that block's scores at the sparsity (aagcn_sparse.py:171-179,
    dggcn_sparse.py:199-217)."""

    def epoch_sparsity(self, current_epoch, max_epoch):
        return sparsity_schedule(self.linear_sparsity, current_epoch,
                                 max_epoch, self.warm_up, self.sparse_decay)

    def thresholds(self, sparsity) -> list:
        return [pooled_threshold(_all_score_pool(b), sparsity)
                for b in self.blocks()]


class SparseAAGCN(_PerStageBackbone):
    """AAGCN_sparse backbone of the nested copy (aagcn_sparse.py:65-232):
    an 'MVC' data BN, ``stage_plan``'s ten stages of
    :class:`SparseAAGCNBlock`, one threshold a stage; ``forward(x,
    sparsity)``, with ``epoch_sparsity`` the ramp."""

    def __init__(self, graph_cfg: GraphConfig = NTU, in_channels: int = 3,
                 base_channels: int = 64, num_person: int = 2,
                 num_stages: int = 10,
                 inflate_stages: Sequence[int] = (5, 8),
                 down_stages: Sequence[int] = (5, 8),
                 data_bn_type: Optional[str] = "MVC",
                 linear_sparsity: float = 0.0, warm_up: int = 0,
                 sparse_decay: bool = False, gcn_adaptive: bool = True,
                 gcn_attention: bool = True):
        super().__init__()
        self.linear_sparsity, self.warm_up = linear_sparsity, warm_up
        self.sparse_decay = sparse_decay
        self._build(graph_cfg, in_channels, base_channels, 2, num_stages,
                    inflate_stages, down_stages, data_bn_type, num_person,
                    lambda i, o, A, s, r: SparseAAGCNBlock(
                        i, o, A, s, r, gcn_adaptive, gcn_attention))


# ---------------------------------------------------------------------------
# DGSTGCN_sparse (nested dggcn_sparse.py:12-312)
# ---------------------------------------------------------------------------

class SparseDGGCN(nn.Module):
    """dggcn_sparse of the nested copy (gcn_sparse.py:357-531): the
    DG-STGCN unit with masked 1x1s (``pre_conv``, ``conv1``, ``conv2``,
    ``post_conv``, ``down_conv``).  ``pre_conv`` + ``pre_bn`` + ReLU give
    K groups of mid = ratio C_out channels; x1 and x2 come from the T-mean
    of x (every frame when a graph is 'NA'); the graph is the trained A
    plus ``alpha`` times ``ctr_act`` of x1 - x2 (per channel) plus
    ``beta`` times ``ada_act`` of x1 . x2 (per subset), the gates one a
    subset with ``subset_wise``, else their first entry; the contraction
    is ``_dispatch_contract``; ``post_conv``, ``bn``, the residual, ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, ratio: Optional[float] = 0.25,
                 ctr: Optional[str] = "T", ada: Optional[str] = "T",
                 subset_wise: bool = False, ada_act: str = "softmax",
                 ctr_act: str = "tanh"):
        super().__init__()
        K = self.K = A_init.shape[0]
        self.mid = int((ratio if ratio is not None else 1.0 / K)
                       * out_channels)
        self.ctr, self.ada, self.subset_wise = ctr, ada, subset_wise
        self.ada_act, self.ctr_act = ACTS[ada_act], ACTS[ctr_act]
        self.down = in_channels != out_channels
        if self.down:
            self.down_conv = SparseDenseAt(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)
        self.A = _graph_param(A_init)
        self.pre_conv = SparseDenseAt(in_channels, self.mid * K)
        self.pre_bn = BatchNorm(self.mid * K)
        self.alpha = nn.Parameter(torch.zeros(K))
        self.beta = nn.Parameter(torch.zeros(K))
        if ctr is not None or ada is not None:
            self.conv1 = SparseDenseAt(in_channels, self.mid * K)
            self.conv2 = SparseDenseAt(in_channels, self.mid * K)
        self.post_conv = SparseDenseAt(self.mid * K, out_channels)
        self.bn = BatchNorm(out_channels)

    def _gate(self, g: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
        gates = cast(gates, g.dtype)
        if self.subset_wise:
            return g * gates.reshape(1, self.K, 1, 1, 1, 1)
        return g * gates[0]

    def forward(self, x: torch.Tensor, threshold) -> torch.Tensor:
        n, t, v, _ = x.shape
        K, mid = self.K, self.mid
        res = self.down_bn(self.down_conv(x, threshold)) if self.down else x
        pre = torch.relu(self.pre_bn(self.pre_conv(x, threshold)))
        pre = pre.reshape(n, t, v, K, mid)
        G = cast(self.A, x.dtype)[None, :, None, None]   # (1, K, 1, 1, V, V)
        if self.ctr is not None or self.ada is not None:
            tmp = x if "NA" in (self.ctr, self.ada) \
                else x.mean(dim=1, keepdim=True)
            tq = tmp.shape[1]
            # (N, K, C, Tq, V), the reference's layout
            x1 = self.conv1(tmp, threshold).reshape(n, tq, v, K, mid) \
                .permute(0, 3, 4, 1, 2)
            x2 = self.conv2(tmp, threshold).reshape(n, tq, v, K, mid) \
                .permute(0, 3, 4, 1, 2)
        if self.ctr is not None:
            diff = x1[..., :, None] - x2[..., None, :]
            G = self._gate(self.ctr_act(diff), self.alpha) + G
        if self.ada is not None:
            g = torch.einsum("nkctv,nkctw->nktvw", x1, x2)[:, :, None]
            G = self._gate(self.ada_act(g), self.beta) + G
        if self.ctr is None and self.ada is None:
            G = G[0, :, 0, 0]                            # (K, V, V)
        elif G.shape[3] == 1:                            # T-pooled graphs
            G = G[:, :, :, 0]                            # (N, K, Cq, V, V)
        y = _dispatch_contract(pre, G, self.ctr, self.ada)
        y = self.bn(self.post_conv(y.reshape(n, t, v, K * mid), threshold))
        return torch.relu(y + res)


class SparseDGBlock(nn.Module):
    """DGBlock of the nested copy (dggcn_sparse.py:12-86): ``gcn``
    (:class:`SparseDGGCN`), ``tcn`` (``SparseMSTCN``) and the residual,
    which here is masked at the stage threshold (the duck-typed call
    succeeds, :70-75)."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True,
                 gcn_ratio: Optional[float] = 0.25,
                 gcn_ctr: Optional[str] = "T", gcn_ada: Optional[str] = "T",
                 gcn_subset_wise: bool = False, tcn_dropout: float = 0.0):
        super().__init__()
        _block_residual(self, in_channels, out_channels, stride, residual)
        self.gcn = SparseDGGCN(in_channels, out_channels, A, ratio=gcn_ratio,
                               ctr=gcn_ctr, ada=gcn_ada,
                               subset_wise=gcn_subset_wise)
        self.tcn = SparseMSTCN(out_channels, out_channels, stride=stride,
                               dropout=tcn_dropout)

    def forward(self, x: torch.Tensor, threshold) -> torch.Tensor:
        res = _block_res(self, x, threshold)
        return torch.relu(self.tcn(self.gcn(x, threshold), threshold) + res)


class SparseDGSTGCN(_PerStageBackbone):
    """DGSTGCN_sparse backbone of the nested copy (dggcn_sparse.py:89-312):
    a 'VC' data BN, ``stage_plan`` at ``ch_ratio``, :class:`SparseDGBlock`
    stages on the random K = 8 graph by default, one threshold a stage."""

    def __init__(self, graph_cfg: GraphConfig = DG_RANDOM,
                 in_channels: int = 3, base_channels: int = 64,
                 ch_ratio: float = 2, num_stages: int = 10,
                 inflate_stages: Sequence[int] = (5, 8),
                 down_stages: Sequence[int] = (5, 8),
                 data_bn_type: Optional[str] = "VC", num_person: int = 2,
                 linear_sparsity: float = 0.0, warm_up: int = 0,
                 sparse_decay: bool = False,
                 gcn_ratio: Optional[float] = 0.25,
                 gcn_ctr: Optional[str] = "T", gcn_ada: Optional[str] = "T",
                 gcn_subset_wise: bool = False):
        super().__init__()
        self.linear_sparsity, self.warm_up = linear_sparsity, warm_up
        self.sparse_decay = sparse_decay
        self._build(graph_cfg, in_channels, base_channels, ch_ratio,
                    num_stages, inflate_stages, down_stages, data_bn_type,
                    num_person,
                    lambda i, o, A, s, r: SparseDGBlock(
                        i, o, A, s, r, gcn_ratio, gcn_ctr, gcn_ada,
                        gcn_subset_wise))


# ---------------------------------------------------------------------------
# Assemble_sparse (nested Assemble_sparse.py:14-256)
# ---------------------------------------------------------------------------

BRANCH_BLOCKS = {"ST-GCN": SparseSTGCNBlockExact, "AA-GCN": SparseAAGCNBlock,
                 "CTR-GCN": SparseCTRGCNBlock, "DG-GCN": SparseDGBlock}


class AssembleSparse(nn.Module):
    """Assemble_sparse (nested Assemble_sparse.py:102-256): B streams, one
    sparse block family a ``model_list`` entry, go through the stage plan
    side by side, stream j on its slice of the graph reshaped to (B, K/B,
    V, V) (K % B == 0, :40-41), behind one shared 'MVC' ``data_bn``.
    Block ``stage{i}_branch{j}`` is masked at the percentile of its own
    scores at branch j's ``sparsity_schedule`` of ``sparse_ratio[j]``.
    JAX's quirk, kept: every branch block has a residual, the first
    stage's too (AssembleBlock never passes its flag on, :44-61).
    ``forward(x, current_epoch, max_epoch)`` returns the streams stacked,
    (B, N, M, T', V, C')."""

    def __init__(self, model_list: Sequence[str],
                 sparse_ratio: Sequence[float], graph_cfg: GraphConfig = NTU,
                 in_channels: int = 3, base_channels: int = 64,
                 num_person: int = 2, num_stages: int = 10,
                 inflate_stages: Sequence[int] = (5, 8),
                 down_stages: Sequence[int] = (5, 8), warm_up: int = 0,
                 sparse_decay: bool = False):
        super().__init__()
        unknown = [f for f in model_list if f not in BRANCH_BLOCKS]
        if unknown:
            raise ValueError(f"unknown branch families {unknown} (not in "
                             f"{tuple(BRANCH_BLOCKS)})")
        self.model_list, self.sparse_ratio = tuple(model_list), \
            tuple(sparse_ratio)
        self.warm_up, self.sparse_decay = warm_up, sparse_decay
        graph = Graph.from_config(graph_cfg)
        A = graph.A.astype(np.float32)
        B, K, V = len(self.model_list), A.shape[0], A.shape[1]
        if K % B:
            raise ValueError(f"{K} graph subsets do not split over {B} "
                             f"branches")
        A = A.reshape(B, K // B, V, V)
        self.data_bn = _data_bn("MVC", graph, in_channels, num_person)
        plan = stage_plan(in_channels, base_channels, 2, num_stages,
                          tuple(inflate_stages), tuple(down_stages))
        self.num_stages, self.out_channels = len(plan), plan[-1][1]
        for i, (in_c, out_c, stride, _) in enumerate(plan):
            for j, family in enumerate(self.model_list):
                self.add_module(f"stage{i}_branch{j}", BRANCH_BLOCKS[family](
                    in_c, out_c, A[j], stride, True))

    def block(self, i: int, j: int) -> nn.Module:
        return getattr(self, f"stage{i}_branch{j}")

    def branch_sparsity(self, j: int, current_epoch, max_epoch):
        return sparsity_schedule(self.sparse_ratio[j], current_epoch,
                                 max_epoch, self.warm_up, self.sparse_decay)

    def thresholds(self, current_epoch, max_epoch) -> List[list]:
        """thresholds[i][j]: block (i, j)'s."""
        sp = [self.branch_sparsity(j, current_epoch, max_epoch)
              for j in range(len(self.model_list))]
        return [[pooled_threshold(_all_score_pool(self.block(i, j)), sp[j])
                 for j in range(len(sp))] for i in range(self.num_stages)]

    def forward(self, x: torch.Tensor, current_epoch,
                max_epoch) -> torch.Tensor:
        n, m, t, v, c = x.shape
        x = self.data_bn(x).reshape(n * m, t, v, c)
        streams = [x] * len(self.model_list)
        for i, row in enumerate(self.thresholds(current_epoch, max_epoch)):
            streams = [self.block(i, j)(s, thr)
                       for j, (s, thr) in enumerate(zip(streams, row))]
        return torch.stack([s.reshape((n, m) + s.shape[1:])
                            for s in streams])


def assemble_regularize(model: AssembleSparse, lam: float,
                        penalty: str = "GSGL") -> torch.Tensor:
    """Assemble_sparse.regularize (Assemble_sparse.py:217-256): the group
    lasso over each (stage, branch) block's pruned weights at its
    branch's ``sparse_ratio`` (:func:`smoe._stage_mask_penalty`), each
    block once, in the order of JAX's sorted names."""
    from .smoe import _stage_mask_penalty
    names = sorted(n for n, _ in model.named_children() if "_branch" in n)
    return _stage_mask_penalty(
        [(getattr(model, n), model.sparse_ratio[int(n.split("_branch")[1])])
         for n in names], lam, penalty)
