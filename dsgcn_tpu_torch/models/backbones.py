"""STGCN (ST-GCN, STGCN++), AAGCN, CTRGCN, DGSTGCN (DG-STGCN, DS-GCN),
GTGCN, STGIN and STGCN_GC backbones, train and eval.

The port of ``split_stage_kwargs``, ``route_prefix``, ``DataBN``,
``_make_tcn``, ``ResidualTCN``, ``STGCNBlock``, ``STGINBlock``,
``GTGCNBlock``, ``AAGCNBlock``, ``CTRGCNBlock``, ``DGBlock``,
``stage_plan``, ``_BackboneBase``, ``STGCN``, ``STGIN``, ``STGCNGC``,
``GTGCN``, ``AAGCN``, ``CTRGCN`` and ``DGSTGCN`` from
``dsgcn_tpu/models/backbones.py`` (MS-G3D and SGN are
``models/msg3d_sgn.py``'s): the 10-stage template of the reference
(stgcn.py:100-128), channel inflation x2 and temporal stride 2 at stages 5
and 8, block = spatial GCN (``unit_gcn`` for STGCN and STGCN_GC, with the
external graph ``A_ext`` for STGCN_GC, ``unit_gtgcn`` for GTGCN,
``unit_gcnedge`` for STGIN, ``unit_aagcn`` or
``unit_aahgcn`` for AAGCN, ``unit_ctrgcn`` or ``unit_ctrhgcn`` for
CTRGCN, ``dggcn`` for DG-STGCN, ``dghgcn``, ``dgphgcn1`` for DS-GCN) ->
temporal conv (``unit_tcn``, ``mstcn``, ``dgmstcn``, the author's
temporal MLPs ``unitmlp``, ``msmlp``, ``gcmlp``, ``dgmsmlp``,
CTR-GCN's ``CTRMSTCN``, or STGIN's ``unit_tcnedge``, which threads the
spatial and temporal edge representations from block to block)
(+ residual, ReLU).  Input ``(N, M, T, V, C)``
channels-last, output ``(N, M, T/4, V, C_out)``.  Blocks are named
``block{i}`` as the flax scopes are.  ``remat`` (training only, JAX
``_BackboneBase.remat``): True recomputes each whole block in the backward,
'tcn' each DGBlock's temporal unit only (``ops/common.py:remat_call``);
the state dict is the same either way.  ``joint_pad`` (DGSTGCN only, JAX
``_BackboneBase.joint_pad``) puts the units in joint-padded mode (their
``v_pad``): JAX's refusals (training, 'mega'), at the real joints
(``ops/common.py:joint_pad_check``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph import Graph, GraphConfig
from ..ops.common import BatchNorm, remat_call
from ..parallel.joint_partition import all_gather
from ..parallel.mesh import axis
from ..ops.common import PointConv
from ..ops.gcn import (DGGCN, DGHGCN, DGPHGCN1, UnitAAGCN, UnitAAHGCN,
                       UnitCTRGCN, UnitCTRHGCN, UnitGCN, UnitGCNEdge,
                       UnitGTGCN)
from ..ops.tcn import (CTRMSTCN, DGMSTCN, GCMLP, MSTCN, UnitMLP, UnitTCN,
                       UnitTCNEdge)

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
    (k = 9), 'mstcn', 'dgmstcn', or the author's temporal MLPs 'unitmlp'
    (k = 9), 'msmlp' (``MSTCN`` with mlp branches), 'gcmlp' and 'dgmsmlp'
    (``DGMSTCN`` with mlp branches)."""
    kw = {k: (tuple(map(tuple_ify, v)) if k == "ms_cfg" else v)
          for k, v in tcn_kwargs.items()}
    if tcn_type == "unit_tcn":
        return UnitTCN(in_channels, out_channels, kernel_size=9,
                       stride=stride, **kw)
    if tcn_type == "unitmlp":
        return UnitMLP(in_channels, out_channels, kernel_size=9,
                       stride=stride, **kw)
    if tcn_type in ("mstcn", "msmlp"):
        return MSTCN(in_channels, out_channels, stride=stride,
                     branch_kind="mlp" if tcn_type == "msmlp" else "tcn",
                     **kw)
    if tcn_type in ("dgmstcn", "dgmsmlp"):
        return DGMSTCN(in_channels, out_channels, stride=stride,
                       branch_kind="mlp" if tcn_type == "dgmsmlp" else "tcn",
                       **kw)
    if tcn_type == "gcmlp":
        return GCMLP(in_channels, out_channels, stride=stride, **kw)
    raise ValueError(f"unknown tcn type {tcn_type!r}")


class DataBN(BatchNorm):
    """Input batchnorm over the flattened joint-channel features of each
    frame (reference stgcn.py:93-98, BatchNorm1d): kind 'VC' normalizes
    the V*C features of each body, 'MVC' the M*V*C features of all bodies
    of a frame (JAX ``backbones.py:DataBN``)."""

    def __init__(self, num_features: int, kind: str = "VC"):
        super().__init__(num_features)
        self.kind = kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m, t, v, c = x.shape
        if self.kind == "MVC":
            y = super().forward(x.transpose(1, 2).reshape(n, t, m * v * c))
            return y.reshape(n, t, m, v, c).transpose(1, 2)
        return super().forward(x.reshape(n * m, t, v * c)).reshape(
            n, m, t, v, c)


class ResidualTCN(nn.Module):
    """Block residual path: identity, zero, or strided 1x1 unit_tcn (its BN
    synced over ``bn_axis`` in a joint-partitioned block)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 enabled: bool = True, bn_axis: Optional[str] = None):
        super().__init__()
        self.enabled = enabled
        self.identity = in_channels == out_channels and stride == 1
        if enabled and not self.identity:
            self.down = UnitTCN(in_channels, out_channels, kernel_size=1,
                                stride=stride, bn_axis=bn_axis)

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

    def forward(self, x: torch.Tensor,
                A_ext: Optional[torch.Tensor] = None) -> torch.Tensor:
        res = self.residual(x)
        return F.relu(self.tcn(self.gcn(x, A_ext)) + res)


class STGINBlock(nn.Module):
    """unit_gcnedge + unit_tcnedge with the edge representations threaded
    through (reference STGINBlock, stgin.py:17-72): ``gcn`` updates the
    nodes, spatial and temporal edges, ``tcn`` strides them in time; the
    block residual is added to the nodes.  ``edge_t_channels``: the width
    of the temporal edges coming in (the backbone's ``edge_conv`` output
    in the first block)."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True,
                 gcn_kwargs: Optional[Dict[str, Any]] = None,
                 tcn_kwargs: Optional[Dict[str, Any]] = None,
                 edge_t_channels: Optional[int] = None):
        super().__init__()
        self.residual = ResidualTCN(in_channels, out_channels, stride,
                                    residual)
        self.gcn = UnitGCNEdge(in_channels, out_channels, A_init=A,
                               edge_t_channels=edge_t_channels,
                               **(gcn_kwargs or {}))
        self.tcn = UnitTCNEdge(out_channels, out_channels, stride=stride,
                               **(tcn_kwargs or {}))

    def forward(self, x: torch.Tensor, edge_t: torch.Tensor,
                edge_s: torch.Tensor):
        res = self.residual(x)
        y, edge_s, edge_t = self.gcn(x, edge_s, edge_t)
        y, edge_t, edge_s = self.tcn(y, edge_t, edge_s)
        return F.relu(y + res), edge_t, edge_s


class GTGCNBlock(nn.Module):
    """unit_gtgcn + temporal unit + residual (reference MEGA-era
    GTGCNBlock, gtgcn.py:11-64): ``gcn1`` and ``tcn1``, the edge and node
    types going to the unit."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True,
                 edge_type: Optional[np.ndarray] = None,
                 node_type: Optional[np.ndarray] = None,
                 gcn_kwargs: Optional[Dict[str, Any]] = None,
                 tcn_type: str = "unit_tcn",
                 tcn_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.residual = ResidualTCN(in_channels, out_channels, stride,
                                    residual)
        self.gcn1 = UnitGTGCN(in_channels, out_channels, A_init=A,
                              edge_type=edge_type, node_type=node_type,
                              **(gcn_kwargs or {}))
        self.tcn1 = _make_tcn(tcn_type, out_channels, out_channels, stride,
                              tcn_kwargs or {})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.residual(x)
        return F.relu(self.tcn1(self.gcn1(x)) + res)


class DGBlock(nn.Module):
    """{dggcn | dghgcn | dgphgcn1} + a temporal unit of :func:`_make_tcn`
    (reference dgstgcn.py:12-65); the edge and node types go to dghgcn and
    dgphgcn1.  ``graph_axis`` (JAX backbones.py:288-316) reaches the GCN
    unit, the residual's BN and the temporal unit (``dgmstcn``'s
    graph_axis, ``unit_tcn``'s bn_axis; JAX asserts one of the two, and a
    GCN unit other than dghgcn)."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 edge_type: Optional[np.ndarray],
                 node_type: Optional[np.ndarray], stride: int = 1,
                 residual: bool = True, gcn_type: str = "dggcn",
                 gcn_kwargs: Optional[Dict[str, Any]] = None,
                 tcn_type: str = "dgmstcn",
                 tcn_kwargs: Optional[Dict[str, Any]] = None,
                 remat_tcn: bool = False,
                 graph_axis: Optional[str] = None):
        super().__init__()
        self.remat_tcn = remat_tcn
        if gcn_type not in ("dggcn", "dghgcn", "dgphgcn1"):
            raise ValueError(f"unknown gcn type {gcn_type!r}")
        tcn_kwargs = dict(tcn_kwargs or {})
        if graph_axis is not None:
            if gcn_type == "dghgcn":
                raise ValueError("graph_axis takes gcn_type 'dggcn' or "
                                 "'dgphgcn1', not 'dghgcn'")
            if tcn_type not in ("dgmstcn", "unit_tcn"):
                raise ValueError(
                    f"graph_axis takes tcn_type 'dgmstcn' or 'unit_tcn', "
                    f"not {tcn_type!r}")
            tcn_kwargs["graph_axis" if tcn_type == "dgmstcn"
                       else "bn_axis"] = graph_axis
        self.residual = ResidualTCN(in_channels, out_channels, stride,
                                    residual, bn_axis=graph_axis)
        if gcn_type == "dggcn":
            self.gcn = DGGCN(in_channels, out_channels, A_init=A,
                             graph_axis=graph_axis, **(gcn_kwargs or {}))
        elif gcn_type == "dghgcn":
            self.gcn = DGHGCN(in_channels, out_channels, A_init=A,
                              edge_type=edge_type, node_type=node_type,
                              **(gcn_kwargs or {}))
        else:
            self.gcn = DGPHGCN1(in_channels, out_channels, A_init=A,
                                edge_type=edge_type, node_type=node_type,
                                graph_axis=graph_axis, **(gcn_kwargs or {}))
        self.tcn = _make_tcn(tcn_type, out_channels, out_channels, stride,
                             tcn_kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.residual(x)
        y = self.gcn(x)
        y = (remat_call(self.tcn, y) if self.remat_tcn and self.training
             else self.tcn(y))
        return F.relu(y + res)


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
                 data_bn_type: Optional[str] = "VC", remat: Any = False,
                 block_args: Optional[Mapping[str, Any]] = None,
                 joint_pad: int = 0, graph_axis: Optional[str] = None):
        super().__init__()
        if remat not in (False, True, "tcn"):
            raise ValueError(f"remat must be False, True or 'tcn'; got "
                             f"{remat!r}")
        if graph_axis is not None and not self._supports_graph_axis:
            raise ValueError(f"{type(self).__name__} does not support "
                             "graph_axis (the joint partition is DGSTGCN's)")
        if graph_axis is not None and joint_pad:
            raise ValueError("graph_axis and joint_pad exclude each other")
        self.remat = remat
        self.graph_axis = graph_axis
        graph = Graph.from_config(graph_cfg)
        A = graph.A.astype(np.float32)
        if data_bn_type not in ("VC", "MVC", None):
            raise ValueError(f"unknown data_bn_type {data_bn_type!r}")
        self.data_bn = None
        if data_bn_type is not None:
            bodies = num_person if data_bn_type == "MVC" else 1
            self.data_bn = DataBN(bodies * graph.num_node * in_channels,
                                  data_bn_type)
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
        self.joint_pad = 0
        if joint_pad:
            self.set_joint_pad(joint_pad)

    _supports_graph_axis = False

    def make_block(self, i, graph, A, in_c, out_c, stride, residual, kwargs):
        raise NotImplementedError

    def set_joint_pad(self, v_pad: int) -> None:
        """Joint-padded eval at ``v_pad`` joints (0: off).  DGSTGCN's alone
        (JAX asserts ``_supports_joint_pad``)."""
        raise ValueError(f"{type(self).__name__} does not support joint_pad "
                         "(joint-padded eval is DGSTGCN's)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m, t, v, c = x.shape
        if self.data_bn is not None:
            x = self.data_bn(x)
        x = x.reshape(n * m, t, v, c)
        if self.graph_axis is not None:
            # this process's block of the joints (JAX backbones.py:420-426)
            ax = axis(self.graph_axis)
            if v % ax.size:
                raise ValueError(f"graph-axis shards ({ax.size}) must "
                                 f"divide V ({v})")
            vl = v // ax.size
            x = x[:, :, ax.index * vl:(ax.index + 1) * vl]
        for i in range(self.num_blocks):
            blk = getattr(self, f"block{i}")
            x = (remat_call(blk, x) if self.remat is True and self.training
                 else blk(x))
        if self.graph_axis is not None:
            x = all_gather(x, axis(self.graph_axis).group, dim=2)
        return x.reshape((n, m) + x.shape[1:])


class AAGCNBlock(nn.Module):
    """unit_aagcn | unit_aahgcn + temporal unit + residual (reference
    aagcn.py:12-55); the edge and node types go to unit_aahgcn only."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True,
                 gcn_type: str = "unit_aagcn",
                 edge_type: Optional[np.ndarray] = None,
                 node_type: Optional[np.ndarray] = None,
                 gcn_kwargs: Optional[Dict[str, Any]] = None,
                 tcn_type: str = "unit_tcn",
                 tcn_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        if gcn_type not in ("unit_aagcn", "unit_aahgcn"):
            raise ValueError(f"unknown AAGCN gcn_type {gcn_type!r}")
        self.residual = ResidualTCN(in_channels, out_channels, stride,
                                    residual)
        if gcn_type == "unit_aahgcn":
            self.gcn = UnitAAHGCN(in_channels, out_channels, A_init=A,
                                  edge_type=edge_type, node_type=node_type,
                                  **(gcn_kwargs or {}))
        else:
            self.gcn = UnitAAGCN(in_channels, out_channels, A_init=A,
                                 **(gcn_kwargs or {}))
        self.tcn = _make_tcn(tcn_type, out_channels, out_channels, stride,
                             tcn_kwargs or {})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.residual(x)
        return F.relu(self.tcn(self.gcn(x)) + res)


class CTRGCNBlock(nn.Module):
    """unit_ctrgcn | unit_ctrhgcn + CTRMSTCN (k = 5, dilations (1, 2), its
    own residual off) + the block residual (reference ctrgcn.py:9-61)."""

    def __init__(self, in_channels: int, out_channels: int, A: np.ndarray,
                 stride: int = 1, residual: bool = True, kernel_size: int = 5,
                 dilations: Sequence[int] = (1, 2), tcn_dropout: float = 0.0,
                 gcn_type: str = "unit_ctrgcn", semantic_index: bool = False,
                 edge_type: Optional[np.ndarray] = None,
                 node_type: Optional[np.ndarray] = None,
                 gcn_kwargs: Optional[Dict[str, Any]] = None):
        super().__init__()
        if gcn_type not in ("unit_ctrgcn", "unit_ctrhgcn"):
            raise ValueError(f"unknown CTRGCN gcn_type {gcn_type!r}")
        self.residual = ResidualTCN(in_channels, out_channels, stride,
                                    residual)
        if gcn_type == "unit_ctrhgcn":
            self.gcn = UnitCTRHGCN(in_channels, out_channels, A_init=A,
                                   edge_type=edge_type, node_type=node_type,
                                   semantic_index=semantic_index,
                                   **(gcn_kwargs or {}))
        else:
            self.gcn = UnitCTRGCN(in_channels, out_channels, A_init=A,
                                  **(gcn_kwargs or {}))
        self.tcn = CTRMSTCN(out_channels, out_channels,
                            kernel_size=kernel_size, stride=stride,
                            dilations=dilations, residual=False,
                            tcn_dropout=tcn_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.residual(x)
        return F.relu(self.tcn(self.gcn(x)) + res)


class DGSTGCN(_BackboneBase):
    """DG-STGCN / DS-GCN backbone (reference dgstgcn.py:74-170): blocks of
    gcn_type 'dggcn' (DG-STGCN, the default) or 'dgphgcn1' (DS-GCN) with
    tcn_type 'dgmstcn'.  The per-stage 'gcn_stage' list toggles semantics
    on listed stages (dgstgcn.py:115-120).  ``graph_axis`` (joint
    partition, JAX backbones.py:410-435): after ``data_bn`` each process of
    the axis keeps its V / G joints, the blocks run joint-partitioned, and
    the output is all-gathered back to every joint before the head.
    """

    _supports_graph_axis = True

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
                       tcn_type=tcn_type, tcn_kwargs=tcn_kwargs,
                       remat_tcn=self.remat == "tcn",
                       graph_axis=self.graph_axis)

    def set_joint_pad(self, v_pad: int) -> None:
        """Joint-padded mode at ``v_pad`` joints (0: off): the blocks'
        ``dggcn``/``dgphgcn1`` and ``dgmstcn`` units take ``v_pad``;
        ``mstcn`` and ``unit_tcn`` need nothing; ``dghgcn`` and the temporal
        MLPs are refused (JAX backbones.py:612-619)."""
        if v_pad and self.graph_axis is not None:
            raise ValueError("graph_axis and joint_pad exclude each other")
        for i in range(self.num_blocks):
            blk = getattr(self, f"block{i}")
            if v_pad and not isinstance(blk.gcn, (DGGCN, DGPHGCN1)):
                raise ValueError(f"joint_pad unsupported for the GCN unit "
                                 f"{type(blk.gcn).__name__}")
            tcn_ok = isinstance(blk.tcn, UnitTCN) or (
                isinstance(blk.tcn, (DGMSTCN, MSTCN))
                and blk.tcn.branches.branch_kind == "tcn")
            if v_pad and not tcn_ok:
                raise ValueError(f"joint_pad unsupported for the temporal "
                                 f"unit {type(blk.tcn).__name__} (JAX takes "
                                 "dgmstcn, mstcn and unit_tcn)")
            if 0 < v_pad < blk.gcn.A.shape[-1]:
                raise ValueError(f"joint_pad={v_pad} is under the graph's "
                                 f"{blk.gcn.A.shape[-1]} joints")
            blk.gcn.v_pad = v_pad
            if isinstance(blk.tcn, DGMSTCN):
                blk.tcn.v_pad = v_pad
        self.joint_pad = v_pad


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


def _types(graph):
    nt = np.array(graph.node_type) if graph.node_type is not None else None
    return graph.edge_type, nt


class AAGCN(_BackboneBase):
    """2s-AGCN / AAGCN (reference aagcn.py:57-142): blocks of unit_aagcn
    (the default) or unit_aahgcn and tcn_type 'unit_tcn' (the default);
    data_bn_type 'MVC' by default."""

    def __init__(self, data_bn_type: Optional[str] = "MVC", **kwargs):
        super().__init__(data_bn_type=data_bn_type, **kwargs)

    def make_block(self, i, graph, A, in_c, out_c, stride, residual, kwargs):
        kwargs = dict(kwargs)
        kwargs.pop("_lw_index", None)
        gcn_kwargs, tcn_kwargs = route_prefix(kwargs)
        tcn_type = tcn_kwargs.pop("type", "unit_tcn")
        gcn_type = gcn_kwargs.pop("type", "unit_aagcn")
        edge_type, node_type = _types(graph)
        return AAGCNBlock(in_c, out_c, A=A, stride=stride, residual=residual,
                          gcn_type=gcn_type, edge_type=edge_type,
                          node_type=node_type, gcn_kwargs=gcn_kwargs,
                          tcn_type=tcn_type, tcn_kwargs=tcn_kwargs)


class CTRGCN(_BackboneBase):
    """CTR-GCN (reference ctrgcn.py:69-123): blocks of unit_ctrgcn (the
    default) or unit_ctrhgcn, each with a CTRMSTCN; data_bn_type 'MVC' by
    default.  A block's ``semantic_index`` is set where its stage number
    (1-based, the stem's included, so one more than the block index when
    the stem is dropped) is in ``semantic_stage``."""

    def __init__(self, data_bn_type: Optional[str] = "MVC",
                 semantic_stage: Sequence[int] = tuple(range(1, 11)),
                 **kwargs):
        # make_block reads it while the base class builds the blocks
        self.semantic_stage = tuple(semantic_stage)
        super().__init__(data_bn_type=data_bn_type, **kwargs)

    def make_block(self, i, graph, A, in_c, out_c, stride, residual, kwargs):
        kwargs = dict(kwargs)
        lw_index = kwargs.pop("_lw_index", i)
        gcn_kwargs, tcn_kwargs = route_prefix(kwargs)
        gcn_type = gcn_kwargs.pop("type", "unit_ctrgcn")
        tcn_kwargs.pop("type", None)
        extra = {k: tuple_ify(v) for k, v in tcn_kwargs.items()}
        edge_type, node_type = _types(graph)
        semantic = (lw_index + 1) in self.semantic_stage
        return CTRGCNBlock(in_c, out_c, A=A, stride=stride, residual=residual,
                           gcn_type=gcn_type, semantic_index=semantic,
                           edge_type=edge_type, node_type=node_type,
                           gcn_kwargs=gcn_kwargs, **extra)


class GTGCN(_BackboneBase):
    """Graph-transformer GCN (reference gtgcn.py:68-141): the STGCN stage
    plan with ``unit_gtgcn`` spatial units (:class:`GTGCNBlock`) and
    tcn_type 'unit_tcn' (the default) or any of :func:`_make_tcn`'s."""

    def make_block(self, i, graph, A, in_c, out_c, stride, residual, kwargs):
        kwargs = dict(kwargs)
        kwargs.pop("_lw_index", None)
        gcn_kwargs, tcn_kwargs = route_prefix(kwargs)
        tcn_type = tcn_kwargs.pop("type", "unit_tcn")
        gcn_kwargs.pop("type", None)
        edge_type, node_type = _types(graph)
        return GTGCNBlock(in_c, out_c, A=A, stride=stride, residual=residual,
                          edge_type=edge_type, node_type=node_type,
                          gcn_kwargs=gcn_kwargs, tcn_type=tcn_type,
                          tcn_kwargs=tcn_kwargs)


class STGIN(_BackboneBase):
    """ST-GIN (reference stgin.py:74-162): the STGCN stage plan with
    edge-representation blocks (:class:`STGINBlock`).  The spatial edges
    start as the joint differences x_u - x_v, the temporal edges as the
    forward frame difference (the last frame zero) through the 1x1
    ``edge_conv`` to ``base_channels`` (stgin.py:149-156).  As JAX's, it
    takes the committed configuration only (unit_gcnedge, unit_tcnedge;
    a ``type`` in the block args is dropped) and ignores ``remat``."""

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 **kwargs):
        # make_block reads it while the base class builds the blocks
        self.base_channels = base_channels
        super().__init__(in_channels=in_channels,
                         base_channels=base_channels, **kwargs)
        self.edge_conv = PointConv(in_channels, base_channels)

    def make_block(self, i, graph, A, in_c, out_c, stride, residual, kwargs):
        kwargs = dict(kwargs)
        kwargs.pop("_lw_index", None)
        gcn_kwargs, tcn_kwargs = route_prefix(kwargs)
        gcn_kwargs.pop("type", None)
        tcn_kwargs.pop("type", None)
        return STGINBlock(in_c, out_c, A=A, stride=stride, residual=residual,
                          gcn_kwargs=gcn_kwargs, tcn_kwargs=tcn_kwargs,
                          edge_t_channels=self.base_channels if i == 0
                          else in_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m, t, v, c = x.shape
        if self.data_bn is not None:
            x = self.data_bn(x)
        x = x.reshape(n * m, t, v, c)
        edge_s = x[:, :, :, None, :] - x[:, :, None, :, :]  # (NM,T,V,V,C)
        diff = torch.cat([x[:, 1:] - x[:, :-1], torch.zeros_like(x[:, :1])],
                         dim=1)
        edge_t = self.edge_conv(diff)
        for i in range(self.num_blocks):
            x, edge_t, edge_s = getattr(self, f"block{i}")(x, edge_t, edge_s)
        return x.reshape((n, m) + x.shape[1:])


class STGCNGC(_BackboneBase):
    """STGCN_GC (reference stgcn_gc.py:68-149): the STGCN trunk with an
    external (K, V, V) graph ``A_ext`` given to the forward and fed to every
    block's unit_gcn (e.g. a Granger-causality graph).  ``gcn_adaptive``
    must be None, 'offset' or 'importance': the default 'init' refuses an
    external graph (:class:`UnitGCN`), as in JAX.  Like JAX's, it ignores
    ``remat``."""

    def make_block(self, i, graph, A, in_c, out_c, stride, residual, kwargs):
        kwargs = dict(kwargs)
        kwargs.pop("_lw_index", None)
        gcn_kwargs, tcn_kwargs = route_prefix(kwargs)
        tcn_type = tcn_kwargs.pop("type", "unit_tcn")
        gcn_kwargs.pop("type", None)
        return STGCNBlock(in_c, out_c, A=A, stride=stride, residual=residual,
                          gcn_kwargs=gcn_kwargs, tcn_type=tcn_type,
                          tcn_kwargs=tcn_kwargs)

    def forward(self, x: torch.Tensor,
                A_ext: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, m, t, v, c = x.shape
        if self.data_bn is not None:
            x = self.data_bn(x)
        x = x.reshape(n * m, t, v, c)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, A_ext)
        return x.reshape((n, m) + x.shape[1:])
