"""Sparse (supermask) backbones (port of ``dsgcn_tpu/sparse/models.py``).

* ``SparseSTGCN``: the reference STGCN_sparse equivalent
  (stgcn_sparse.py:78-263) with a per-layer score quantile as each mask's
  threshold;
* ``SparseCTRGCN``: CTRGCN_sparse (ctrgcn_sparse.py:9-163, gcn_sparse.py
  CTRGC_sparse :220-257 and unit_ctrgcn_sparse :259-319, tcn_sparse.py
  :12-160), one threshold a stage, the global percentile of the stage's
  pooled scores (get_threshold, ctrgcn_sparse.py:145-153);
* ``SparseSTGCNExact``: STGCN_sparse with its per-stage (or, nested, one
  global) percentile threshold.

Every forward takes ``(x, sparsity)``, x (N, M, T, V, C), and returns
(N, M, T', V, C').  The modules and their scopes carry JAX's names, so
``utils/convert.py`` loads a JAX tree strictly.  The port's parameters
exist before the first forward, so it needs no init-time threshold.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..graph import Graph, GraphConfig
from ..models.backbones import DataBN, stage_plan
from ..ops.common import BatchNorm, cast, max_pool_t
from ..ops.common import dropout as _dropout
from .supermask import (SparseDense, SparseTemporalConv, get_sparsity,
                        pooled_threshold, sparsity_schedule, supermask_at)

NTU = GraphConfig(layout="nturgb+d", mode="spatial")


def _data_bn(kind: Optional[str], graph: Graph, in_channels: int,
             num_person: int) -> Optional[DataBN]:
    if kind is None:
        return None
    bodies = num_person if kind == "MVC" else 1
    return DataBN(bodies * graph.num_node * in_channels, kind)


def _graph_param(A: np.ndarray) -> nn.Parameter:
    return nn.Parameter(torch.tensor(np.array(A, np.float32)))


class _SparseBackbone(nn.Module):
    """The shared stem and stage loop: DataBN, then the blocks of
    ``stage_plan``; ``thresholds(sparsity)`` gives each block its mask
    argument."""

    def _build(self, graph_cfg: GraphConfig, in_channels: int,
               base_channels: int, ch_ratio: float, num_stages: int,
               inflate_stages, down_stages, data_bn: Optional[str],
               num_person: int, block) -> None:
        graph = Graph.from_config(graph_cfg)
        A = graph.A.astype(np.float32)
        self.data_bn = _data_bn(data_bn, graph, in_channels, num_person)
        plan = stage_plan(in_channels, base_channels, ch_ratio, num_stages,
                          tuple(inflate_stages), tuple(down_stages))
        self.num_blocks, self.out_channels = len(plan), plan[-1][1]
        for i, (in_c, out_c, stride, residual) in enumerate(plan):
            self.add_module(f"block{i}", block(in_c, out_c, A, stride,
                                               residual))

    def blocks(self) -> List[nn.Module]:
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]

    def thresholds(self, sparsity) -> list:
        return [sparsity] * self.num_blocks

    def forward(self, x: torch.Tensor, sparsity) -> torch.Tensor:
        n, m, t, v, c = x.shape
        if self.data_bn is not None:
            x = self.data_bn(x)
        x = x.reshape(n * m, t, v, c)
        for blk, arg in zip(self.blocks(), self.thresholds(sparsity)):
            x = blk(x, arg)
        return x.reshape((n, m) + x.shape[1:])


def _residual(module: nn.Module, in_c: int, out_c: int, stride: int,
              residual: bool, conv) -> None:
    module.res_kind = ("zero" if not residual else
                       "identity" if in_c == out_c and stride == 1 else
                       "conv")
    if module.res_kind == "conv":
        module.residual = conv(in_c, out_c, kernel_size=1, stride=stride)
        module.residual_bn = BatchNorm(out_c)


def _res(module: nn.Module, x: torch.Tensor, arg):
    if module.res_kind == "zero":
        return 0.0
    if module.res_kind == "identity":
        return x
    return module.residual_bn(module.residual(x, arg))


def _graph_agg(y: torch.Tensor, A: torch.Tensor, K: int) -> torch.Tensor:
    n, t, v, _ = y.shape
    y = y.reshape(n, t, v, K, -1)
    return torch.einsum("ntvkc,kvw->ntwc", y, cast(A, y.dtype))


class SparseUnitGCN(nn.Module):
    """unit_gcn with a supermasked pre conv (reference unit_gcn_sparse,
    gcn_sparse.py:23): ``conv`` (C_in -> K C_out), the K subsets
    aggregated over the trainable graph ``A``, ``bn``, ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, conv=SparseDense):
        super().__init__()
        self.K = A_init.shape[0]
        self.A = _graph_param(A_init)
        self.conv = conv(in_channels, out_channels * self.K)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, arg) -> torch.Tensor:
        return torch.relu(self.bn(_graph_agg(self.conv(x, arg), self.A,
                                             self.K)))


class SparseSTGCNBlock(nn.Module):
    """Sparse gcn + sparse 9x1 tcn + residual (stgcn_sparse.py:78)."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True):
        super().__init__()
        _residual(self, in_channels, out_channels, stride, residual,
                  SparseTemporalConv)
        self.gcn = SparseUnitGCN(in_channels, out_channels, A)
        self.tcn = SparseTemporalConv(out_channels, out_channels, 9, stride)
        self.tcn_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, sparsity) -> torch.Tensor:
        res = _res(self, x, sparsity)
        y = self.tcn_bn(self.tcn(self.gcn(x, sparsity), sparsity))
        return torch.relu(y + res)


class SparseSTGCN(_SparseBackbone):
    """10-stage sparse ST-GCN; each mask's threshold is its own score's
    quantile at the ``sparsity`` the forward takes (the reference threads
    current_epoch/max_epoch through train_step,
    epoch_based_sparse_runner.py:49).  ``num_person`` sizes an 'MVC'
    data BN (JAX infers it)."""

    def __init__(self, graph_cfg: GraphConfig = NTU, in_channels: int = 3,
                 base_channels: int = 64, ch_ratio: float = 2,
                 num_stages: int = 10,
                 inflate_stages: Sequence[int] = (5, 8),
                 down_stages: Sequence[int] = (5, 8),
                 data_bn_type: Optional[str] = "VC",
                 target_sparsity: float = 0.5, warmup_epochs: float = 0.0,
                 num_person: int = 2):
        super().__init__()
        self.target_sparsity, self.warmup_epochs = (target_sparsity,
                                                    warmup_epochs)
        self._build(graph_cfg, in_channels, base_channels, ch_ratio,
                    num_stages, inflate_stages, down_stages, data_bn_type,
                    num_person, SparseSTGCNBlock)

    def epoch_sparsity(self, current_epoch, total_epochs):
        """Linear ramp to target_sparsity (init_func.py:24-26)."""
        return get_sparsity(self.target_sparsity, current_epoch,
                            self.warmup_epochs, total_epochs)


# ---------------------------------------------------------------------------
# CTRGCN_sparse: masks at a per-stage threshold
# ---------------------------------------------------------------------------

class SparseDenseAt(SparseDense):
    """1x1 conv masked at an external score threshold
    (SparseConv2d.forward, sparse_mosules.py:203-210); zero bias init."""
    zero_bias = True

    def mask(self, threshold) -> torch.Tensor:
        return supermask_at(self.score, threshold)


class SparseTemporalConvAt(SparseTemporalConv):
    """k x 1 temporal conv masked at a threshold (unit_tcn_sparse's
    conv); zero bias init."""
    zero_bias = True

    def mask(self, threshold) -> torch.Tensor:
        return supermask_at(self.score, threshold)


class SparseCTRGC(nn.Module):
    """CTRGC with thresholded convs (CTRGC_sparse, gcn_sparse.py:220-257):
    ``conv1``/``conv2`` (C_in -> rel) T-meaned, their tanh difference
    through ``conv4`` (rel -> C_out) scaled by alpha plus the subset's A,
    applied to ``conv3`` (C_in -> C_out) over the joints."""

    def __init__(self, in_channels: int, out_channels: int,
                 rel_reduction: int = 8):
        super().__init__()
        rel = 8 if in_channels <= 16 else in_channels // rel_reduction
        self.conv1 = SparseDenseAt(in_channels, rel)
        self.conv2 = SparseDenseAt(in_channels, rel)
        self.conv3 = SparseDenseAt(in_channels, out_channels)
        self.conv4 = SparseDenseAt(rel, out_channels)

    def forward(self, x: torch.Tensor, threshold, A: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x, threshold).mean(dim=1)
        x2 = self.conv2(x, threshold).mean(dim=1)
        x3 = self.conv3(x, threshold)
        diff = torch.tanh(x1[:, :, None, :] - x2[:, None, :, :])
        g = self.conv4(diff, threshold) * cast(alpha, x.dtype) \
            + cast(A, x.dtype)[None, :, :, None]
        return torch.einsum("nuwc,ntuc->ntwc", g, x3)


class SparseUnitCTRGCN(nn.Module):
    """unit_ctrgcn_sparse (gcn_sparse.py:259-319): one ``convs{i}`` a
    subset, summed, plus the residual (``down_conv`` + ``down_bn`` when
    the width changes), ReLU.  JAX's quirks, kept: no trailing BN (the
    reference's ``bn`` is built and never applied, :290-316), and the
    inner CTRGC scores stay out of the stage's threshold pool (built with
    sparse_ratio=0, :272) while masked at that threshold."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray):
        super().__init__()
        self.K = A_init.shape[0]
        self.A = _graph_param(A_init)
        self.alpha = nn.Parameter(torch.zeros(1))
        for i in range(self.K):
            self.add_module(f"convs{i}", SparseCTRGC(in_channels,
                                                     out_channels))
        self.down = in_channels != out_channels
        if self.down:
            self.down_conv = SparseDenseAt(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, threshold) -> torch.Tensor:
        y = sum(getattr(self, f"convs{i}")(x, threshold, self.A[i],
                                           self.alpha[0])
                for i in range(self.K))
        res = self.down_bn(self.down_conv(x, threshold)) if self.down else x
        return torch.relu(y + res)


class SparseMSTCN(nn.Module):
    """mstcn_sparse (tcn_sparse.py:43-160): the branches of ``ms_cfg``
    ((k, dilation): 1x1 ``branch{i}_pre`` + ``branch{i}_bn`` + ReLU + k x 1
    ``branch{i}_tcn``; ('max', w): the same with a temporal max-pool; '1x1':
    one strided ``branch{i}_conv``), concatenated, ``transform_bn``, ReLU,
    ``transform_conv``, ``bn``, dropout (training, ``self.generator``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[float] = None,
                 ms_cfg=((3, 1), (3, 2), (3, 3), (3, 4), ("max", 3), "1x1"),
                 stride: int = 1, dropout: float = 0.0):
        super().__init__()
        nb = len(ms_cfg)
        if mid_channels is None:
            mid = out_channels // nb
            rem = out_channels - mid * (nb - 1)
        else:
            mid = rem = int(out_channels * mid_channels)
        self.ms_cfg, self.stride, self.dropout = tuple(ms_cfg), stride, dropout
        self.generator: Optional[torch.Generator] = None
        total = 0
        for i, cfg in enumerate(self.ms_cfg):
            bc = rem if i == 0 else mid
            total += bc
            if cfg == "1x1":
                self.add_module(f"branch{i}_conv", SparseTemporalConvAt(
                    in_channels, bc, kernel_size=1, stride=stride))
                continue
            kind, val = cfg
            self.add_module(f"branch{i}_pre", SparseDenseAt(in_channels, bc))
            self.add_module(f"branch{i}_bn", BatchNorm(bc))
            if kind != "max":
                self.add_module(f"branch{i}_tcn", SparseTemporalConvAt(
                    bc, bc, kernel_size=kind, stride=stride, dilation=val))
        self.transform_bn = BatchNorm(total)
        self.transform_conv = SparseDenseAt(total, out_channels)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, threshold) -> torch.Tensor:
        outs = []
        for i, cfg in enumerate(self.ms_cfg):
            if cfg == "1x1":
                outs.append(getattr(self, f"branch{i}_conv")(x, threshold))
                continue
            kind, val = cfg
            b = getattr(self, f"branch{i}_pre")(x, threshold)
            b = torch.relu(getattr(self, f"branch{i}_bn")(b))
            if kind == "max":
                b = max_pool_t(b, window=val, stride=self.stride, padding=1)
            else:
                b = getattr(self, f"branch{i}_tcn")(b, threshold)
            outs.append(b)
        feat = torch.relu(self.transform_bn(torch.cat(outs, dim=-1)))
        feat = self.bn(self.transform_conv(feat, threshold))
        return _dropout(feat, self.dropout, self.training, self.generator)


class SparseCTRGCNBlock(nn.Module):
    """ctrgcn_sparse.CTRGCNBlock (:9-70): ``gcn1``, ``tcn1``, residual."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True):
        super().__init__()
        self.gcn1 = SparseUnitCTRGCN(in_channels, out_channels, A)
        self.tcn1 = SparseMSTCN(out_channels, out_channels, stride=stride)
        _residual(self, in_channels, out_channels, stride, residual,
                  SparseTemporalConvAt)

    def forward(self, x: torch.Tensor, threshold) -> torch.Tensor:
        y = self.tcn1(self.gcn1(x, threshold), threshold)
        return torch.relu(y + _res(self, x, threshold))


def _scores(module: nn.Module, skip_convs: bool) -> List[torch.Tensor]:
    return [p for name, p in module.named_parameters()
            if name.split(".")[-1] == "score"
            and not (skip_convs and any(k.startswith("convs")
                                        for k in name.split(".")))]


def _block_score_pool(block: nn.Module) -> List[torch.Tensor]:
    """The scores of a stage's threshold pool: every score but the inner
    CTRGC ``convs``' (their ``p.sparsity != linear_sparsity``,
    ctrgcn_sparse.py:147-149)."""
    return _scores(block, skip_convs=True)


def _all_score_pool(module: nn.Module) -> List[torch.Tensor]:
    """Every score under ``module``."""
    return _scores(module, skip_convs=False)


class SparseCTRGCN(_SparseBackbone):
    """CTRGCN_sparse backbone (ctrgcn_sparse.py:72-163): CTR-GCN stages
    with thresholded convs, each stage's threshold the global percentile
    (:func:`pooled_threshold`) of its pooled scores at the sparsity.
    ``pool_all_scores`` pools the inner CTRGC scores too (the nested
    copy's semantics, gcn_sparse.py:291 there)."""

    def __init__(self, graph_cfg: GraphConfig = NTU, in_channels: int = 3,
                 base_channels: int = 64, num_person: int = 2,
                 num_stages: int = 10,
                 inflate_stages: Sequence[int] = (5, 8),
                 down_stages: Sequence[int] = (5, 8),
                 linear_sparsity: float = 0.0, warm_up: int = 0,
                 sparse_decay: bool = False, pool_all_scores: bool = False):
        super().__init__()
        self.linear_sparsity, self.warm_up = linear_sparsity, warm_up
        self.sparse_decay, self.pool_all_scores = sparse_decay, \
            pool_all_scores
        self._build(graph_cfg, in_channels, base_channels, 2, num_stages,
                    inflate_stages, down_stages, "MVC", num_person,
                    SparseCTRGCNBlock)

    def epoch_sparsity(self, current_epoch, max_epoch):
        return sparsity_schedule(self.linear_sparsity, current_epoch,
                                 max_epoch, self.warm_up, self.sparse_decay)

    def thresholds(self, sparsity) -> list:
        pool = _all_score_pool if self.pool_all_scores else _block_score_pool
        return [pooled_threshold(pool(b), sparsity) for b in self.blocks()]


# ---------------------------------------------------------------------------
# STGCN_sparse with the reference's percentile thresholds
# ---------------------------------------------------------------------------

class SparseUnitGCNAt(SparseUnitGCN):
    """unit_gcn_sparse (gcn_sparse.py:23-99): the pre conv masked at the
    stage threshold, the subset product over a trained A, BN + ReLU
    (adaptive='init', the reference STGCN_sparse's)."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, adaptive: Optional[str] = "init"):
        if adaptive != "init":
            raise ValueError("the reference STGCN_sparse uses the default "
                             "adaptive='init'")
        super().__init__(in_channels, out_channels, A_init,
                         conv=SparseDenseAt)


class SparseSTGCNBlockExact(nn.Module):
    """STGCN_sparse block (stgcn_sparse.py:20-76).  JAX's quirk, kept: the
    residual conv is masked at threshold 0 (the reference calls
    ``self.residual(x)`` without the stage threshold, :72)."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True):
        super().__init__()
        self.gcn = SparseUnitGCNAt(in_channels, out_channels, A)
        self.tcn_conv = SparseTemporalConvAt(out_channels, out_channels, 9,
                                             stride)
        self.tcn_bn = BatchNorm(out_channels)
        _residual(self, in_channels, out_channels, stride, residual,
                  SparseTemporalConvAt)

    def forward(self, x: torch.Tensor, threshold) -> torch.Tensor:
        y = self.tcn_bn(self.tcn_conv(self.gcn(x, threshold), threshold))
        return torch.relu(y + _res(self, x, 0.0))


class SparseSTGCNExact(_SparseBackbone):
    """STGCN_sparse backbone with the reference's per-stage percentile
    thresholds over all of a stage's scores (stgcn_sparse.py:78-212);
    ``global_threshold`` pools every score of the backbone into one
    threshold (the nested copy, stgcn_sparse.py:182 there)."""

    def __init__(self, graph_cfg: GraphConfig = NTU, in_channels: int = 3,
                 base_channels: int = 64, num_person: int = 2,
                 num_stages: int = 10,
                 inflate_stages: Sequence[int] = (5, 8),
                 down_stages: Sequence[int] = (5, 8),
                 linear_sparsity: float = 0.0, warm_up: int = 0,
                 sparse_decay: bool = False, global_threshold: bool = False):
        super().__init__()
        self.linear_sparsity, self.warm_up = linear_sparsity, warm_up
        self.sparse_decay, self.global_threshold = sparse_decay, \
            global_threshold
        self._build(graph_cfg, in_channels, base_channels, 2, num_stages,
                    inflate_stages, down_stages, "VC", num_person,
                    SparseSTGCNBlockExact)

    def epoch_sparsity(self, current_epoch, max_epoch):
        return sparsity_schedule(self.linear_sparsity, current_epoch,
                                 max_epoch, self.warm_up, self.sparse_decay)

    def thresholds(self, sparsity) -> list:
        if self.global_threshold:
            return [pooled_threshold(_all_score_pool(self), sparsity)] \
                * self.num_blocks
        return [pooled_threshold(_all_score_pool(b), sparsity)
                for b in self.blocks()]
