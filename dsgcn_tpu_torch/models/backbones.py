"""STGCN (ST-GCN, STGCN++) and DGSTGCN (DG-STGCN, DS-GCN) backbones, train
and eval.

The port of ``split_stage_kwargs``, ``route_prefix``, ``DataBN``,
``_make_tcn``, ``ResidualTCN``, ``STGCNBlock``, ``DGBlock``,
``stage_plan``, ``_BackboneBase``, ``STGCN`` and ``DGSTGCN`` from
``dsgcn_tpu/models/backbones.py``: the 10-stage template of the reference
(stgcn.py:100-128), channel inflation x2 and temporal stride 2 at stages 5
and 8, block = spatial GCN (``unit_gcn`` for STGCN, ``dggcn`` for
DG-STGCN, ``dgphgcn1`` for DS-GCN) -> temporal conv (``unit_tcn``,
``mstcn`` or ``dgmstcn``) (+ residual, ReLU).  Input ``(N, M, T, V, C)``
channels-last, output ``(N, M, T/4, V, C_out)``.  Blocks are named
``block{i}`` as the flax scopes are.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph import Graph, GraphConfig
from ..ops.common import BatchNorm
from ..ops.gcn import DGGCN, DGPHGCN1, UnitGCN
from ..ops.tcn import DGMSTCN, MSTCN, UnitTCN

EPS = 1e-4


def split_stage_kwargs(kwargs: Mapping[str, Any], num_stages: int):
    """Tuple-valued kwargs of length num_stages become per-stage values."""
    lw = [dict(kwargs) for _ in range(num_stages)]
    for k, v in kwargs.items():
        if isinstance(v, tuple) and len(v) == num_stages:
            for i in range(num_stages):
                lw[i][k] = v[i]
    return lw


def route_prefix(kwargs: Mapping[str, Any]):
    """Split block kwargs into (gcn_kwargs, tcn_kwargs); bare 'act'/'norm'/'g1x1'
    go to both (dgstgcn.py:17-26)."""
    kwargs = dict(kwargs)
    for arg in ("act", "norm", "g1x1"):
        if arg in kwargs:
            v = kwargs.pop(arg)
            kwargs.setdefault("gcn_" + arg, v)
            kwargs.setdefault("tcn_" + arg, v)
    gcn_kwargs = {k[4:]: v for k, v in kwargs.items() if k.startswith("gcn_")}
    tcn_kwargs = {k[4:]: v for k, v in kwargs.items() if k.startswith("tcn_")}
    rest = {k: v for k, v in kwargs.items()
            if not (k.startswith("gcn_") or k.startswith("tcn_"))}
    if rest:
        raise ValueError(f"invalid block args: {rest}")
    return gcn_kwargs, tcn_kwargs


def tuple_ify(v):
    return tuple(v) if isinstance(v, list) else v


def _make_tcn(tcn_type: str, in_channels: int, out_channels: int,
              stride: int, tcn_kwargs: Dict[str, Any]) -> nn.Module:
    """The temporal unit of a block (JAX backbones.py:85-115): 'unit_tcn'
    (k = 9), 'mstcn' or 'dgmstcn'.  The temporal-MLP kinds ('unitmlp',
    'msmlp', 'gcmlp', 'dgmsmlp') are not ported."""
    kw = {k: (tuple(map(tuple_ify, v)) if k == "ms_cfg" else v)
          for k, v in tcn_kwargs.items()}
    if tcn_type == "unit_tcn":
        return UnitTCN(in_channels, out_channels, kernel_size=9,
                       stride=stride, **kw)
    if tcn_type == "mstcn":
        return MSTCN(in_channels, out_channels, stride=stride, **kw)
    if tcn_type == "dgmstcn":
        return DGMSTCN(in_channels, out_channels, stride=stride, **kw)
    if tcn_type in ("unitmlp", "msmlp", "gcmlp", "dgmsmlp"):
        raise NotImplementedError(
            f"tcn_type={tcn_type!r} is not ported yet (the port has "
            "'unit_tcn', 'mstcn' and 'dgmstcn')")
    raise ValueError(f"unknown tcn type {tcn_type!r}")


class DataBN(BatchNorm):
    """Input batchnorm over the flattened joint-channel features of each
    frame (reference stgcn.py:93-98, BatchNorm1d over V*C), kind 'VC'."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m, t, v, c = x.shape
        return super().forward(x.reshape(n * m, t, v * c)).reshape(
            n, m, t, v, c)


class ResidualTCN(nn.Module):
    """Block residual path: identity, zero, or strided 1x1 unit_tcn."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 enabled: bool = True):
        super().__init__()
        self.enabled = enabled
        self.identity = in_channels == out_channels and stride == 1
        if enabled and not self.identity:
            self.down = UnitTCN(in_channels, out_channels, kernel_size=1,
                                stride=stride)

    def forward(self, x: torch.Tensor):
        if not self.enabled:
            return 0.0
        return x if self.identity else self.down(x)


class STGCNBlock(nn.Module):
    """unit_gcn + temporal unit + residual (reference STGCNBlock,
    stgcn.py:16-68)."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True,
                 gcn_kwargs: Optional[Dict[str, Any]] = None,
                 tcn_type: str = "unit_tcn",
                 tcn_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.residual = ResidualTCN(in_channels, out_channels, stride,
                                    residual)
        self.gcn = UnitGCN(in_channels, out_channels, A_init=A,
                           **(gcn_kwargs or {}))
        self.tcn = _make_tcn(tcn_type, out_channels, out_channels, stride,
                             tcn_kwargs or {})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.residual(x)
        return F.relu(self.tcn(self.gcn(x)) + res)


class DGBlock(nn.Module):
    """{dggcn | dgphgcn1} + {unit_tcn | mstcn | dgmstcn} (reference
    dgstgcn.py:12-65); the edge and node types go to dgphgcn1 only."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 edge_type: Optional[np.ndarray],
                 node_type: Optional[np.ndarray], stride: int = 1,
                 residual: bool = True, gcn_type: str = "dggcn",
                 gcn_kwargs: Optional[Dict[str, Any]] = None,
                 tcn_type: str = "dgmstcn",
                 tcn_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        if gcn_type not in ("dggcn", "dgphgcn1"):
            raise NotImplementedError(
                f"gcn_type={gcn_type!r} is not ported yet (the port has "
                "'dggcn' and 'dgphgcn1')")
        self.residual = ResidualTCN(in_channels, out_channels, stride,
                                    residual)
        if gcn_type == "dggcn":
            self.gcn = DGGCN(in_channels, out_channels, A_init=A,
                             **(gcn_kwargs or {}))
        else:
            self.gcn = DGPHGCN1(in_channels, out_channels, A_init=A,
                                edge_type=edge_type, node_type=node_type,
                                **(gcn_kwargs or {}))
        self.tcn = _make_tcn(tcn_type, out_channels, out_channels, stride,
                             tcn_kwargs or {})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.residual(x)
        return F.relu(self.tcn(self.gcn(x)) + res)


def stage_plan(in_channels: int, base_channels: int, ch_ratio: float,
               num_stages: int, inflate_stages, down_stages):
    """Yields (in_c, out_c, stride, residual) per stage (reference stgcn.py:113-128).

    When in_channels == base_channels the first (non-residual) stem stage is
    dropped, leaving num_stages - 1 blocks.
    """
    plan = []
    if in_channels != base_channels:
        plan.append((in_channels, base_channels, 1, False))
    cur = base_channels
    inflate = 0
    for i in range(2, num_stages + 1):
        stride = 1 + (i in down_stages)
        if i in inflate_stages:
            inflate += 1
        out = int(base_channels * ch_ratio ** inflate + EPS)
        plan.append((cur, out, stride, True))
        cur = out
    return plan


class _BackboneBase(nn.Module):
    """Shared stage loop; subclasses provide ``make_block``."""

    def __init__(self, graph_cfg: GraphConfig = GraphConfig(
                     layout="nturgb+d", mode="spatial"),
                 in_channels: int = 3, base_channels: int = 64,
                 ch_ratio: float = 2, num_person: int = 2,
                 num_stages: int = 10,
                 inflate_stages: Sequence[int] = (5, 8),
                 down_stages: Sequence[int] = (5, 8),
                 data_bn_type: Optional[str] = "VC",
                 block_args: Optional[Mapping[str, Any]] = None):
        super().__init__()
        graph = Graph.from_config(graph_cfg)
        A = graph.A.astype(np.float32)
        if data_bn_type not in ("VC", None):
            raise NotImplementedError(
                f"data_bn_type={data_bn_type!r} is not ported yet")
        self.data_bn = (DataBN(graph.num_node * in_channels)
                        if data_bn_type == "VC" else None)
        lw = split_stage_kwargs(dict(block_args or {}), num_stages)
        lw[0].pop("tcn_dropout", None)
        lw[0].pop("g1x1", None)
        lw[0].pop("gcn_g1x1", None)
        plan = stage_plan(in_channels, base_channels, ch_ratio, num_stages,
                          inflate_stages, down_stages)
        offset = num_stages - len(plan)   # 0 or 1 (stem dropped)
        self.num_blocks = len(plan)
        for i, (in_c, out_c, stride, residual) in enumerate(plan):
            kwargs = dict(lw[i + offset])
            kwargs["_lw_index"] = i + offset
            self.add_module(f"block{i}", self.make_block(
                i, graph, A, in_c, out_c, stride, residual, kwargs))

    def make_block(self, i, graph, A, in_c, out_c, stride, residual, kwargs):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m, t, v, c = x.shape
        if self.data_bn is not None:
            x = self.data_bn(x)
        x = x.reshape(n * m, t, v, c)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x.reshape((n, m) + x.shape[1:])


class DGSTGCN(_BackboneBase):
    """DG-STGCN / DS-GCN backbone (reference dgstgcn.py:74-170): blocks of
    gcn_type 'dggcn' (DG-STGCN, the default) or 'dgphgcn1' (DS-GCN) with
    tcn_type 'dgmstcn'.  The per-stage 'gcn_stage' list toggles semantics
    on listed stages (dgstgcn.py:115-120).
    """

    def __init__(self, graph_cfg: GraphConfig = GraphConfig(
                     layout="nturgb+d", mode="random", seed=0), **kwargs):
        super().__init__(graph_cfg=graph_cfg, **kwargs)

    def make_block(self, i, graph, A, in_c, out_c, stride, residual, kwargs):
        kwargs = dict(kwargs)
        lw_index = kwargs.pop("_lw_index", i)
        gcn_stage = kwargs.pop("gcn_stage", None)
        gcn_kwargs, tcn_kwargs = route_prefix(kwargs)
        if gcn_stage is not None:
            # reference checks the lw list index (dgstgcn.py:115-120)
            gcn_kwargs["stage"] = lw_index in gcn_stage
        gcn_type = gcn_kwargs.pop("type", "dggcn")
        tcn_type = tcn_kwargs.pop("type", "dgmstcn")
        nt = np.array(graph.node_type) if graph.node_type is not None else None
        return DGBlock(in_c, out_c, A=A, edge_type=graph.edge_type,
                       node_type=nt, stride=stride, residual=residual,
                       gcn_type=gcn_type, gcn_kwargs=gcn_kwargs,
                       tcn_type=tcn_type, tcn_kwargs=tcn_kwargs)


class STGCN(_BackboneBase):
    """ST-GCN and STGCN++ (reference stgcn.py:71-153): blocks of unit_gcn
    and tcn_type 'unit_tcn' (the default) or 'mstcn'.  STGCN++ is
    block_args dict(gcn_adaptive='init', gcn_with_res=True,
    tcn_type='mstcn') (configs/stgcnpp/STGCNPP_60_model.py)."""

    def make_block(self, i, graph, A, in_c, out_c, stride, residual, kwargs):
        kwargs = dict(kwargs)
        kwargs.pop("_lw_index", None)
        gcn_kwargs, tcn_kwargs = route_prefix(kwargs)
        tcn_type = tcn_kwargs.pop("type", "unit_tcn")
        return STGCNBlock(in_c, out_c, A=A, stride=stride, residual=residual,
                          gcn_kwargs=gcn_kwargs, tcn_type=tcn_type,
                          tcn_kwargs=tcn_kwargs)
