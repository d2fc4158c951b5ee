"""Classification losses and the on-device top-k metric (port of
``dsgcn_tpu/core/losses.py``; reference pyskl/models/losses/
cross_entropy_loss.py and heads/base.py)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def cross_entropy(cls_score: torch.Tensor, label: torch.Tensor,
                  class_weight: Optional[torch.Tensor] = None,
                  loss_weight: float = 1.0) -> torch.Tensor:
    """Hard- or soft-label cross entropy.

    Hard labels: int (N,) -> standard CE, a class-weighted mean with
    ``class_weight`` (cross_entropy_loss.py:42-78).  Soft labels: float
    (N, K) -> -sum(logsoftmax * label) per sample, normalized by the
    weighted label mass with ``class_weight`` (cross_entropy_loss.py:55-66).
    """
    logp = torch.log_softmax(cls_score, dim=-1)
    if label.dim() == cls_score.dim():
        lsm = -(logp * label)
        if class_weight is not None:
            lsm = lsm * class_weight[None]
        loss = lsm.sum(dim=-1)
        if class_weight is not None:
            loss = loss / (class_weight[None] * label).sum(dim=-1)
        loss = loss.mean()
    else:
        picked = torch.gather(logp, -1, label[:, None].long())[:, 0]
        if class_weight is not None:
            w = class_weight[label.long()]
            loss = -(picked * w).sum() / w.sum()
        else:
            loss = -picked.mean()
    return loss * loss_weight


def bce_with_logits(cls_score: torch.Tensor, label: torch.Tensor,
                    class_weight: Optional[torch.Tensor] = None,
                    loss_weight: float = 1.0) -> torch.Tensor:
    """Binary cross entropy with logits for multi-label targets, the mean
    over samples and classes, each class weighted by ``class_weight``
    (reference cross_entropy_loss.py BCELossWithLogits; JAX
    ``losses.py:bce_with_logits``)."""
    loss = -(label * F.logsigmoid(cls_score)
             + (1.0 - label) * F.logsigmoid(-cls_score))
    if class_weight is not None:
        loss = loss * class_weight[None]
    return loss.mean() * loss_weight


def mm_cross_entropy(scores: Dict[str, torch.Tensor], labels: torch.Tensor,
                     loss_weights=None):
    """Weighted per-stream cross entropy of a multimodal recognizer
    (reference mm_recognizer3d.py:26-34; JAX ``losses.py:mm_cross_entropy``):
    total = sum_k w_k CE(scores[k], labels), ``loss_weights`` a dict by
    stream (1.0 where absent), one number for every stream, or None (1.0).
    Returns (total, {'<stream>_loss_cls': weighted loss})."""
    parts, total = {}, 0.0
    for name, score in scores.items():
        if loss_weights is None:
            w = 1.0
        elif isinstance(loss_weights, dict):
            w = loss_weights.get(name, 1.0)
        else:
            w = loss_weights
        loss = cross_entropy(score, labels) * w
        parts[f"{name}_loss_cls"] = loss
        total = total + loss
    return total, parts


def top_k_correct(cls_score: torch.Tensor, label: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Fraction of samples whose true label is among the k highest scores
    (reference heads/base.py:66-72)."""
    topk = torch.topk(cls_score, min(k, cls_score.shape[-1]), dim=-1).indices
    return (topk == label[:, None]).any(dim=-1).float().mean()
