"""Model factory: config dict -> RecognizerGCN module.

The port of ``dsgcn_tpu/models/builder.py`` for what the port has: the
``STGCN`` backbone (ST-GCN, STGCN++; alias ``MEGASTGCN``), ``AAGCN``,
``CTRGCN``, the ``DGSTGCN`` backbone in its DG-STGCN and DS-GCN forms,
``GTGCN``, ``STGIN``, ``STGCN_GC`` (whose forward takes the external graph
``A_ext``), ``MSG3D`` and ``SGN``, the Granger-causality learners
``GCGCN`` and ``GCGCN_component``, and the ``GCNHead`` and ``GCHead``.
Config keys are the JAX package's.  ``STGCN_GC`` and the two learners are
built with ``build_backbone`` and composed by hand (the learners with
``GCHead`` and ``core/flows.py:gc_recognizer_losses``); ``build_model``
builds a ``RecognizerGCN``, which feeds a backbone the clip alone.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..graph import GraphConfig
from ..ops.causal import GCGCN, GCComponent, GCSparse
from ..ops.common import (branch_normal_, kaiming_normal_fan_out_,
                          trunc_normal_scaled_)
from ..ops.gcn import (CTRGC, CTRHGC, AttentionChain, UnitAAHGCN, UnitGCN,
                       UnitGCNEdge, UnitGTGCN)
from ..ops.msg3d import MSG3DBlock, _ScaledGraphs
from ..ops.tcn import CTRMSTCN
from .backbones import AAGCN, CTRGCN, DGSTGCN, GTGCN, STGCN, STGCNGC, STGIN
from .heads import GCHead, GCNHead
from .msg3d_sgn import MSG3D, SGN
from .recognizer import RecognizerGCN

BACKBONES = {"STGCN": STGCN, "MEGASTGCN": STGCN, "GTGCN": GTGCN,
             "STGIN": STGIN, "STGCN_GC": STGCNGC, "GCGCN": GCGCN,
             "GCGCN_component": GCComponent, "AAGCN": AAGCN,
             "CTRGCN": CTRGCN, "DGSTGCN": DGSTGCN, "MSG3D": MSG3D,
             "SGN": SGN}
# backbones configured by plain fields (no gcn_/tcn_ block routing)
_PLAIN_BACKBONES = ("GCGCN", "GCGCN_component", "MSG3D", "SGN")
HEADS = {"GCNHead": GCNHead, "GCHead": GCHead}

_BACKBONE_FIELDS = {
    "in_channels", "base_channels", "ch_ratio", "num_person", "num_stages",
    "inflate_stages", "down_stages", "data_bn_type", "remat",
    "semantic_stage", "joint_pad", "graph_axis",
}


def _lookup(table, typ, what):
    if typ not in table:
        raise NotImplementedError(f"{what} {typ!r} is not ported yet "
                                  f"(the port has {sorted(table)})")
    return table[typ]


def build_backbone(cfg: Dict[str, Any]):
    cfg = copy.deepcopy(dict(cfg))
    typ = cfg.pop("type")
    cls = _lookup(BACKBONES, typ, "backbone")
    if typ in _PLAIN_BACKBONES:
        if "graph_cfg" in cfg:
            gc = cfg.pop("graph_cfg")
            cfg["graph_cfg"] = gc if isinstance(gc, GraphConfig) \
                else GraphConfig(**gc)
        return cls(**cfg)
    gc = cfg.pop("graph_cfg")
    if not isinstance(gc, GraphConfig):
        gc = GraphConfig(**gc)
    if typ == "DGSTGCN":
        # the dynamic-graph kernels are the default: the CUDA kernels on a
        # CUDA device, their plain versions on the CPU (builder.py:91-101
        # defaults them on where Pallas runs, for DGSTGCN only)
        cfg.setdefault("gcn_use_pallas", True)
    fields = {k: v for k, v in cfg.items() if k in _BACKBONE_FIELDS}
    for k in ("inflate_stages", "down_stages", "semantic_stage"):
        if k in fields:
            fields[k] = tuple(fields[k])
    block_args = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in cfg.items() if k not in _BACKBONE_FIELDS}
    return cls(graph_cfg=gc, block_args=block_args, **fields)


def build_head(cfg: Dict[str, Any]):
    cfg = copy.deepcopy(dict(cfg))
    cls = _lookup(HEADS, cfg.pop("type"), "head")
    cfg.pop("mode", None)
    return cls(**cfg)


def build_model(cfg: Dict[str, Any]) -> RecognizerGCN:
    cfg = copy.deepcopy(dict(cfg))
    typ = cfg.pop("type", "RecognizerGCN")
    if typ != "RecognizerGCN":
        raise NotImplementedError(f"recognizer {typ!r} is not ported yet")
    if cfg.get("neck") is not None:
        raise NotImplementedError("recognizer necks are not ported yet")
    compute_dtype = cfg.get("compute_dtype")
    if compute_dtype is not None:
        compute_dtype = getattr(torch, compute_dtype)
    return RecognizerGCN(backbone=build_backbone(cfg["backbone"]),
                         head=build_head(cfg["cls_head"]),
                         compute_dtype=compute_dtype)


MODEL_NAMES = ("stgcn", "stgcn++", "aagcn", "ctrgcn", "dgstgcn", "dsgcn",
               "msg3d", "sgn")


def model_cfg(name: str, num_classes: int = 60, layout: str = "nturgb+d",
              graph_seed: int = 0, use_pallas=None) -> Dict[str, Any]:
    """The reference's published setup of a ported model.

    * stgcn: plain ST-GCN (stgcn_spatial graph, unit_tcn)
    * stgcn++: gcn_adaptive='init', gcn_with_res, mstcn
      (configs/stgcnpp/STGCNPP_60_model.py)
    * aagcn: unit_aagcn defaults (configs/aagcn/AAGCN_60_model.py)
    * ctrgcn: unit_ctrgcn + CTRMSTCN k=5 dil(1,2)
      (configs/ctrgcn/CTRGCN_60_model.py)
    * dgstgcn: dggcn+dgmstcn, random graph (DG-STGCN, configs/dgstgcn
      upstream)
    * dsgcn: dgphgcn1 with semantic node+edge attention, decompose,
      subset_wise, ratio=0.125 (configs/dsstgcn/DSSTGCN_model.py)
    * msg3d: MS-G3D on the binary adjacency, head width 384
    * sgn: SGN (T = 30), head width 512

    ``use_pallas`` sets ``gcn_use_pallas`` and ``tcn_use_pallas`` of the
    DGSTGCN models, as the JAX package does (builder.py:196-198); STGCN++
    takes the fused TCN kernel K7 with
    ``cfg['backbone']['tcn_use_pallas'] = True``.
    """
    graph = dict(layout=layout, mode="random", init_off=0.04, init_std=0.02,
                 seed=graph_seed)
    width = 256                               # the head's input channels
    if name == "stgcn":
        bb = dict(type="STGCN",
                  graph_cfg=dict(layout=layout, mode="stgcn_spatial"))
    elif name == "stgcn++":
        bb = dict(type="STGCN", gcn_adaptive="init", gcn_with_res=True,
                  tcn_type="mstcn",
                  graph_cfg=dict(layout=layout, mode="spatial"))
    elif name == "aagcn":
        bb = dict(type="AAGCN",
                  graph_cfg=dict(layout=layout, mode="spatial"))
    elif name == "ctrgcn":
        bb = dict(type="CTRGCN", gcn_type="unit_ctrgcn",
                  graph_cfg=dict(layout=layout, mode="spatial"))
    elif name == "dgstgcn":
        bb = dict(type="DGSTGCN", gcn_type="dggcn", gcn_ratio=0.25,
                  gcn_ctr="T", gcn_ada="T", tcn_type="dgmstcn",
                  graph_cfg=dict(graph, num_filter=8))
    elif name == "dsgcn":
        bb = dict(type="DGSTGCN", gcn_type="dgphgcn1", gcn_ratio=0.125,
                  gcn_node_attention=True, gcn_edge_attention=True,
                  gcn_decompose=True, gcn_subset_wise=True,
                  gcn_ctr="T", gcn_ada="T", tcn_type="dgmstcn",
                  graph_cfg=dict(graph, num_filter=3))
    elif name == "msg3d":
        bb = dict(type="MSG3D",
                  graph_cfg=dict(layout=layout, mode="binary_adj"))
        width = 384
    elif name == "sgn":
        bb = dict(type="SGN")
        width = 512
    else:
        raise ValueError(f"unknown model {name!r} (model_cfg has "
                         f"{', '.join(map(repr, MODEL_NAMES))})")
    if use_pallas is not None and bb["type"] == "DGSTGCN":
        bb["gcn_use_pallas"] = use_pallas
        bb["tcn_use_pallas"] = use_pallas
    head = dict(type="GCNHead", num_classes=num_classes, in_channels=width)
    return dict(type="RecognizerGCN", backbone=bb, cls_head=head)


def build_named_model(name: str, **kw) -> RecognizerGCN:
    return build_model(model_cfg(name, **kw))


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw the model's random weights from ``generator`` with the JAX
    package's initializers (``dsgcn_tpu/ops/common.py``; the same
    distributions, not the same bits).  By default every 1x1 and temporal
    conv kernel and bias is U(+-1/sqrt(fan_in)) (torch's defaults, fan_in =
    in_channels * kernel size), the classifier N(0, init_std) with a zero
    bias, an 'offset' PA of UnitGCN, UnitGTGCN or UnitGCNEdge U(0, 2e-6).
    Then the per-module rules of :func:`_module_rules` (AAGCN's and
    CTR-GCN's units and TCN, MS-G3D's graph offsets and window convs, the
    Granger banks).  Graphs, gates, joint coefficients and BatchNorms keep
    their deterministic initial values (the 1e-6 scale of a unit's closing
    ``bn`` included).  The generator lives on the CPU; call this before
    moving the model to its device."""
    head_types = (GCNHead, GCHead)
    heads = {id(m.fc_cls) for m in model.modules()
             if isinstance(m, head_types)}
    for m in model.modules():
        if isinstance(m, (UnitGCN, UnitGTGCN, UnitGCNEdge)) \
                and m.adaptive == "offset":
            m.PA.uniform_(0.0, 2e-6, generator=generator)
        elif isinstance(m, head_types):
            m.fc_cls.weight.normal_(0.0, m.init_std, generator=generator)
            m.fc_cls.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)) \
                and id(m) not in heads:
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
    for m in model.modules():
        _module_rules(m, generator)
    return model


def _module_rules(m: nn.Module, gen: torch.Generator) -> None:
    """The JAX modules' own initializers where they differ from the
    default: ``kaiming_normal_fan_out`` (N(0, 2/fan_out)) with zero biases
    for the graph embeddings, ``branch_init(K)`` for AAGCN's ``conv_d``,
    flax's ``xavier_normal``/``kaiming_normal`` (truncated normals) and
    zeros in :class:`AttentionChain`, ``kaiming_normal_fan_out`` kernels
    (default biases) for the residual 1x1s and CTRMSTCN's branch 1x1s
    (MS-G3D's too); MS-G3D's graph offsets ``PA`` U(-1e-6, 1e-6)
    (``uniform_eps_init``) and window kernels ``out_conv_kernel``
    ``variance_scaling(1/3, fan_in, uniform)`` (U(+-1/sqrt(w C))) with zero
    biases; the Granger banks JAX's ``torch_default_kernel``/``_bias``
    over its fans (GCComponent's ``weight_norm`` then taken from the new
    weight, as JAX's init computes it)."""
    if isinstance(m, UnitAAHGCN):
        for name, sub in m.named_children():
            if name.startswith(("conv_a", "conv_b", "conv_edge")):
                kaiming_normal_fan_out_(sub.weight, gen)
                sub.bias.zero_()
            elif name.startswith("conv_d"):
                branch_normal_(sub.weight, m.K, gen)
            elif name == "down_conv":
                kaiming_normal_fan_out_(sub.weight, gen)
    elif isinstance(m, AttentionChain):
        k = m.conv_sa.weight.shape[-1]
        fan_in, fan_out = m.conv_sa.weight.shape[1] * k, k
        trunc_normal_scaled_(m.conv_sa.weight, 2.0 / (fan_in + fan_out), gen)
        trunc_normal_scaled_(m.fc1c.weight, 2.0 / m.fc1c.in_features, gen)
        m.zero_init_()
    elif isinstance(m, (CTRGC, CTRHGC)):
        for sub in m.children():
            kaiming_normal_fan_out_(sub.weight, gen)
            sub.bias.zero_()
    elif isinstance(m, CTRMSTCN):
        for name, sub in m.named_children():
            if name.endswith("_pre"):
                kaiming_normal_fan_out_(sub.weight, gen)
            elif name.endswith("_conv"):
                kaiming_normal_fan_out_(sub.conv.weight, gen)
    elif isinstance(m, _ScaledGraphs):
        m.PA.uniform_(-1e-6, 1e-6, generator=gen)
    elif isinstance(m, MSG3DBlock):
        w = m.out_conv_kernel
        bound = (w.shape[0] * w.shape[1]) ** -0.5
        w.uniform_(-bound, bound, generator=gen)
        m.out_conv_bias.zero_()
    elif isinstance(m, (GCSparse, GCComponent)):
        m.draw_(gen)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Let every dropout of ``model`` draw its masks from ``generator`` (on
    the model's device)."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator
