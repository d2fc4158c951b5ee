"""Model factory: config dict -> RecognizerGCN module.

The port of ``dsgcn_tpu/models/builder.py`` for what the port has: the
``STGCN`` backbone (ST-GCN, STGCN++; alias ``MEGASTGCN``), ``AAGCN``,
``CTRGCN``, the ``DGSTGCN`` backbone in its DG-STGCN and DS-GCN forms,
``GTGCN``, ``STGIN``, ``STGCN_GC`` (whose forward takes the external graph
``A_ext``), ``MSG3D`` and ``SGN``, the Granger-causality learners
``GCGCN`` and ``GCGCN_component``, and the ``GCNHead``, ``GCHead``,
``HGTHead`` and ``ClsHead``; a ``RecognizerGCN`` takes any neck of
``models/necks.py:NECKS`` from ``cfg['neck']``.  The 3-D and 2-D CNNs
``ResNet3d``, ``ResNet3dSlowOnly``, ``C3D``, ``X3D``, ``ResNet3dSlowFast``,
``RGBPoseConv3D`` and ``PoTion`` go under a ``RecognizerPoseC3D``,
``Recognizer3D``, ``Recognizer2D`` or ``MMRecognizer3D`` with the heads
``SimpleHead`` / ``I3DHead`` / ``SlowFastHead``, ``TSNHead`` and
``RGBPoseHead``.  Config keys are the JAX package's.  ``STGCN_GC`` and
the two learners are built with ``build_backbone`` and composed by hand
(the learners with
``GCHead`` and ``core/flows.py:gc_recognizer_losses``); ``build_model``
builds a ``RecognizerGCN``, which feeds a backbone the clip alone, or
one of the CNN recognizers (``cfg['type']``).
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
from .cnns import (C3D, X3D, ConvBN2d, PoTion, RecognizerPoseC3D, ResNet3d,
                   ResNet3dSlowFast, ResNet3dSlowOnly, RGBPoseConv3D)
from .heads import (ClsHead, GCHead, GCNHead, HGTHead, RGBPoseHead,
                    SimpleHead3D, TSNHead)
from .necks import (CausalNeck, PretrainNeck, ReadoutNeck, Set2Set,
                    SimpleNeck, build_neck)
from ..sparse.supermask import SparseKernel
from .msg3d_sgn import MSG3D, SGN
from .recognizer import (MMRecognizer3D, Recognizer2D, Recognizer3D,
                         RecognizerGCN)

BACKBONES = {"STGCN": STGCN, "MEGASTGCN": STGCN, "GTGCN": GTGCN,
             "STGIN": STGIN, "STGCN_GC": STGCNGC, "GCGCN": GCGCN,
             "GCGCN_component": GCComponent, "AAGCN": AAGCN,
             "CTRGCN": CTRGCN, "DGSTGCN": DGSTGCN, "MSG3D": MSG3D,
             "SGN": SGN, "ResNet3d": ResNet3d,
             "ResNet3dSlowOnly": ResNet3dSlowOnly,
             "ResNet3dSlowFast": ResNet3dSlowFast, "X3D": X3D, "C3D": C3D,
             "PoTion": PoTion, "RGBPoseConv3D": RGBPoseConv3D}
# backbones configured by plain fields (no gcn_/tcn_ block routing)
_PLAIN_BACKBONES = ("GCGCN", "GCGCN_component", "MSG3D", "SGN", "ResNet3d",
                    "ResNet3dSlowOnly", "ResNet3dSlowFast", "X3D", "C3D",
                    "PoTion", "RGBPoseConv3D")
# the CNN fields a config gives as lists (JAX builder.py:82-85)
_TUPLE_FIELDS = ("stage_blocks", "conv1_stride", "pool1_stride", "inflate",
                 "spatial_strides", "temporal_strides", "conv1_kernel",
                 "channels", "num_layers", "lateral_activate")
HEADS = {"GCNHead": GCNHead, "GCHead": GCHead, "HGTHead": HGTHead,
         "ClsHead": ClsHead, "SimpleHead": SimpleHead3D,
         "I3DHead": SimpleHead3D, "SlowFastHead": SimpleHead3D,
         "TSNHead": TSNHead, "RGBPoseHead": RGBPoseHead}
# recognizers of a backbone and a head, with a compute_dtype
_CNN_RECOGNIZERS = {"Recognizer3D": Recognizer3D,
                    "Recognizer2D": Recognizer2D,
                    "MMRecognizer3D": MMRecognizer3D}

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
        for k in _TUPLE_FIELDS:
            if cfg.get(k) is not None:
                cfg[k] = tuple(cfg[k])
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
    cfg.pop("mode", None)       # SimpleHead's mode is chosen by the class
    if isinstance(cfg.get("in_channels"), list):
        cfg["in_channels"] = tuple(cfg["in_channels"])
    return cls(**cfg)


def build_model(cfg: Dict[str, Any]) -> nn.Module:
    cfg = copy.deepcopy(dict(cfg))
    typ = cfg.pop("type", "RecognizerGCN")
    if typ == "RecognizerPoseC3D":
        return RecognizerPoseC3D(build_backbone(cfg["backbone"]),
                                 num_classes=cfg.get("num_classes", 60),
                                 dropout=cfg.get("dropout", 0.5))
    compute_dtype = cfg.get("compute_dtype")
    if compute_dtype is not None:
        compute_dtype = getattr(torch, compute_dtype)
    if typ in _CNN_RECOGNIZERS:
        return _CNN_RECOGNIZERS[typ](build_backbone(cfg["backbone"]),
                                     build_head(cfg["cls_head"]),
                                     compute_dtype=compute_dtype)
    if typ != "RecognizerGCN":
        raise NotImplementedError(
            f"recognizer {typ!r} is not ported yet (the port has "
            f"'RecognizerGCN', 'RecognizerPoseC3D' and "
            f"{', '.join(map(repr, _CNN_RECOGNIZERS))})")
    neck = cfg.get("neck")
    return RecognizerGCN(backbone=build_backbone(cfg["backbone"]),
                         head=build_head(cfg["cls_head"]),
                         compute_dtype=compute_dtype,
                         neck=None if neck is None else build_neck(neck))


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
    bias (each of ``RGBPoseHead``'s two), an 'offset' PA of UnitGCN,
    UnitGTGCN or UnitGCNEdge U(0, 2e-6), a 3-D conv kernel N(0, 2 /
    fan_out) (flax's untruncated ``variance_scaling(2, 'fan_out',
    'normal')`` in ``ConvBN3d``, SE's ``fc1``/``fc2`` and the laterals;
    fan_out is the output channels times the kernel's taps, for a grouped
    kernel too, and for a transposed lateral its (I, O, ...) weight's O)
    with a zero bias (SE's).
    Then the per-module rules of :func:`_module_rules` (AAGCN's and
    CTR-GCN's units and TCN, MS-G3D's graph offsets and window convs, the
    Granger banks).  Graphs, gates, joint coefficients and BatchNorms keep
    their deterministic initial values (the 1e-6 scale of a unit's closing
    ``bn`` included).  The generator lives on the CPU; call this before
    moving the model to its device."""
    head_types = (GCNHead, GCHead, HGTHead, ClsHead, RecognizerPoseC3D,
                  SimpleHead3D, TSNHead, RGBPoseHead)
    heads = {id(fc) for m in model.modules() if isinstance(m, head_types)
             for fc in _head_fcs(m)}
    for m in model.modules():
        if isinstance(m, (UnitGCN, UnitGTGCN, UnitGCNEdge)) \
                and m.adaptive == "offset":
            m.PA.uniform_(0.0, 2e-6, generator=generator)
        elif isinstance(m, head_types):
            for fc in _head_fcs(m):
                fc.weight.normal_(0.0, m.init_std, generator=generator)
                fc.bias.zero_()
        elif isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose3d):    # (I, O, *kernel)
                w = w.transpose(0, 1)
            kaiming_normal_fan_out_(w, generator)
            if m.bias is not None:
                m.bias.zero_()
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


def _head_fcs(m: nn.Module):
    """A head's classifiers: ``fc_cls`` (and HGTHead's ``node_cls``), or
    RGBPoseHead's ``fc_rgb`` and ``fc_pose``."""
    names = ("fc_cls", "node_cls", "fc_rgb", "fc_pose")
    return [getattr(m, n) for n in names if getattr(m, n, None) is not None]


def _module_rules(m: nn.Module, gen: torch.Generator) -> None:
    """The JAX modules' own initializers where they differ from the
    default: ``kaiming_normal_fan_out`` (N(0, 2/fan_out)) with zero biases
    for the graph embeddings, flax's ``variance_scaling(2, 'fan_out',
    'normal')`` (the same normal) for PoTion's 2-D convs, ``branch_init(K)`` for AAGCN's ``conv_d``,
    flax's ``xavier_normal``/``kaiming_normal`` (truncated normals) and
    zeros in :class:`AttentionChain`, ``kaiming_normal_fan_out`` kernels
    (default biases) for the residual 1x1s and CTRMSTCN's branch 1x1s
    (MS-G3D's too); MS-G3D's graph offsets ``PA`` U(-1e-6, 1e-6)
    (``uniform_eps_init``) and window kernels ``out_conv_kernel``
    ``variance_scaling(1/3, fan_in, uniform)`` (U(+-1/sqrt(w C))) with zero
    biases; the Granger banks JAX's ``torch_default_kernel``/``_bias``
    over its fans (GCComponent's ``weight_norm`` then taken from the new
    weight, as JAX's init computes it); the necks' prototypes flax's
    ``xavier_normal`` (truncated, variance 2 / (P + C)), ``Set2Set``
    U(+-1/sqrt(C)), ``PretrainNeck``'s and ``CausalNeck``'s ``fc_cls``
    N(0, 0.01) with a zero bias, ``PretrainNeck``'s ``gate`` flax's
    default Dense, the cMLP and the sparse layers their own ``init_``."""
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
    elif isinstance(m, (ReadoutNeck, PretrainNeck)):
        for name, p in m.named_parameters(recurse=False):
            trunc_normal_scaled_(p, 2.0 / sum(p.shape), gen)   # protos
        if isinstance(m, PretrainNeck):
            _normal_head_(m.fc_cls, 0.01, gen)
            if m.read_op == "attention":
                _lecun_(m.gate, gen)
    elif isinstance(m, Set2Set):
        for p in m.parameters():
            p.uniform_(-m.in_channels ** -0.5, m.in_channels ** -0.5,
                       generator=gen)
    elif isinstance(m, CausalNeck):
        _normal_head_(m.fc_cls, 0.01, gen)
        m.cMLP.init_(gen)
    elif isinstance(m, SparseKernel):
        m.init_(gen)
    elif isinstance(m, ConvBN2d):
        kaiming_normal_fan_out_(m.conv.weight, gen)


def _normal_head_(fc: nn.Linear, std: float, gen: torch.Generator) -> None:
    fc.weight.normal_(0.0, std, generator=gen)
    fc.bias.zero_()


def _lecun_(fc: nn.Linear, gen: torch.Generator) -> None:
    """flax's default Dense: a ``lecun_normal`` kernel (truncated, variance
    1 / fan_in) and a zero bias."""
    trunc_normal_scaled_(fc.weight, 1.0 / fc.in_features, gen)
    fc.bias.zero_()


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Let every dropout of ``model`` draw its masks from ``generator`` (on
    the model's device)."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator
