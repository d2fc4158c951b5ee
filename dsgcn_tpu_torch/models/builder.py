"""Model factory: config dict -> RecognizerGCN module.

The port of ``dsgcn_tpu/models/builder.py`` for what the port has: the
``DGSTGCN`` backbone in its DS-GCN form and the ``GCNHead``.  Config keys
are the JAX package's.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

from ..graph import GraphConfig
from .backbones import DGSTGCN
from .heads import GCNHead
from .recognizer import RecognizerGCN

BACKBONES = {"DGSTGCN": DGSTGCN}
HEADS = {"GCNHead": GCNHead}

_BACKBONE_FIELDS = {
    "in_channels", "base_channels", "ch_ratio", "num_person", "num_stages",
    "inflate_stages", "down_stages", "data_bn_type",
}


def _lookup(table, typ, what):
    if typ not in table:
        raise NotImplementedError(f"{what} {typ!r} is not ported yet "
                                  f"(the port has {sorted(table)})")
    return table[typ]


def build_backbone(cfg: Dict[str, Any]):
    cfg = copy.deepcopy(dict(cfg))
    cls = _lookup(BACKBONES, cfg.pop("type"), "backbone")
    gc = cfg.pop("graph_cfg")
    if not isinstance(gc, GraphConfig):
        gc = GraphConfig(**gc)
    # the dynamic-graph kernels are the default: the CUDA kernels on a CUDA
    # device, their plain versions on the CPU (builder.py:100-101 defaults
    # them on where Pallas runs)
    cfg.setdefault("gcn_use_pallas", True)
    fields = {k: v for k, v in cfg.items() if k in _BACKBONE_FIELDS}
    for k in ("inflate_stages", "down_stages"):
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
        import torch
        compute_dtype = getattr(torch, compute_dtype)
    return RecognizerGCN(backbone=build_backbone(cfg["backbone"]),
                         head=build_head(cfg["cls_head"]),
                         compute_dtype=compute_dtype)


def model_cfg(name: str, num_classes: int = 60, layout: str = "nturgb+d",
              graph_seed: int = 0) -> Dict[str, Any]:
    """The reference's published setup of a ported model.

    * dsgcn: dgphgcn1 with semantic node+edge attention, decompose,
      subset_wise, ratio=0.125 (configs/dsstgcn/DSSTGCN_model.py)
    """
    if name != "dsgcn":
        raise NotImplementedError(f"model {name!r} is not ported yet "
                                  "(the port has 'dsgcn')")
    bb = dict(type="DGSTGCN", gcn_type="dgphgcn1", gcn_ratio=0.125,
              gcn_node_attention=True, gcn_edge_attention=True,
              gcn_decompose=True, gcn_subset_wise=True,
              gcn_ctr="T", gcn_ada="T", tcn_type="dgmstcn",
              graph_cfg=dict(layout=layout, mode="random", num_filter=3,
                             init_off=0.04, init_std=0.02, seed=graph_seed))
    head = dict(type="GCNHead", num_classes=num_classes, in_channels=256)
    return dict(type="RecognizerGCN", backbone=bb, cls_head=head)
