"""Recognizer: backbone + head (port of ``dsgcn_tpu/models/recognizer.py``).

Reference: pyskl/models/recognizers/recognizergcn.py and base.py
average_clip (:93-116).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.common import cast


class RecognizerGCN(nn.Module):
    """Composes a GCN backbone, an optional neck and a classification head.

    ``forward`` takes ``(N, M, T, V, C)`` and returns logits
    ``(N, classes)`` in the input's type.  A ``neck`` (``models/necks.py``)
    reads the backbone's feature out to (N, C) before the head, as in the
    reference's neck-bearing recognizers (recognizergcnR.py:30-31).  ``compute_dtype`` (e.g.
    ``torch.bfloat16``) casts the input so the whole forward runs in that
    type, and the logits come back in float32.  Multi-clip averaging is
    done by the caller (:func:`average_clip`).
    """

    def __init__(self, backbone: nn.Module, head: nn.Module,
                 compute_dtype: Optional[torch.dtype] = None,
                 neck: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head
        self.compute_dtype = compute_dtype

    def forward(self, keypoint: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            keypoint = keypoint.to(self.compute_dtype)
        feat = self.backbone(keypoint)
        if self.neck is not None:
            feat = self.neck(feat)
        logits = self.head(feat)
        return logits if self.compute_dtype is None else logits.float()


@torch.no_grad()
def extract_pooled_feat(model: RecognizerGCN, keypoint: torch.Tensor,
                        pool_opt: str = "nmtv",
                        score_ext: bool = False) -> torch.Tensor:
    """Pooled backbone features, or per-location class scores, for analysis
    (JAX ``dsgcn_tpu/models/recognizer.py:extract_pooled_feat``; reference
    recognizergcn.py:53-107 feat_ext/score_ext).

    keypoint: (N, M, T, V, C).  The backbone runs in eval (the model's mode
    is put back afterwards) and gives (N, M, T', V, C').  With ``score_ext``
    the head's ``fc_cls`` is applied at every location first
    (recognizergcn.py:88-93).  Then the mean over each axis of ``pool_opt``
    (a subset of 'nmtv', kept as size 1; 'none' keeps everything)."""
    was = model.training
    model.eval()
    try:
        feat = model.backbone(keypoint)
    finally:
        model.train(was)
    if score_ext:
        fc = model.head.fc_cls
        feat = torch.nn.functional.linear(feat, cast(fc.weight, feat.dtype),
                                          cast(fc.bias, feat.dtype))
    if pool_opt != "none":
        for d in pool_opt:
            feat = feat.mean(dim="nmtv".index(d), keepdim=True)
    return feat


def average_clip(cls_score: torch.Tensor,
                 mode: Optional[str] = "prob") -> torch.Tensor:
    """Average class scores over clips: (N, nc, K) -> (N, K)
    (reference base.py:93-116)."""
    if mode is None:
        return cls_score
    if mode == "prob":
        return torch.softmax(cls_score, dim=2).mean(dim=1)
    if mode == "score":
        return cls_score.mean(dim=1)
    raise ValueError(f"average_clips={mode!r} not supported")
