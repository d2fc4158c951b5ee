"""Recognizers: backbone + head (port of ``dsgcn_tpu/models/recognizer.py``):
``RecognizerGCN`` and the 3D-CNN, 2D-CNN and multimodal ``Recognizer3D``,
``Recognizer2D`` and ``MMRecognizer3D``.

Reference: pyskl/models/recognizers/recognizergcn.py, recognizer3d.py,
recognizer2d.py, mm_recognizer3d.py and base.py average_clip (:93-116).
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


def _cast_logits(logits, compute_dtype):
    return logits if compute_dtype is None else logits.float()


class Recognizer3D(nn.Module):
    """3D-CNN recognizer (reference recognizer3d.py:10-85): a backbone over
    (N, T, H, W, C) volumes and a 3-D head.  Multi-clip folding and score
    averaging are the caller's (fold (N, nc, ...) -> (N nc, ...) and
    :func:`average_clip`), as in JAX.  ``compute_dtype`` casts the input
    and the logits come back in float32; with ``feat_ext`` the forward
    returns the backbone's feature pooled over every axis but the first
    and the last (each pathway's, concatenated), in float32
    (recognizer3d.py:58-78)."""

    def __init__(self, backbone: nn.Module, head: nn.Module,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone, self.head = backbone, head
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, feat_ext: bool = False):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        feat = self.backbone(x)
        if feat_ext:
            feats = feat if isinstance(feat, (tuple, list)) else (feat,)
            return torch.cat([f.mean(dim=tuple(range(1, f.dim() - 1)))
                              for f in feats], dim=-1).float()
        return _cast_logits(self.head(feat), self.compute_dtype)


class Recognizer2D(nn.Module):
    """2D-CNN recognizer over frame segments (reference recognizer2d.py:
    9-58): (N, S, H, W, C) folded to (N S, H, W, C) for a 2-D backbone,
    unfolded to (N, S, H', W', C') for a 2-D head (``TSNHead``: the
    segment mean inside).  ``compute_dtype`` and ``feat_ext`` (the spatial
    then the segment mean, float32) as :class:`Recognizer3D`'s.

    A 3-D backbone is refused: JAX builds one, and flax's 3-D conv then
    reads the folded rank-4 batch as one unbatched volume of N S frames,
    which mixes the videos (a change to one video's frames moved another's
    eval logits by 4.9e-3)."""

    def __init__(self, backbone: nn.Module, head: nn.Module,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if getattr(backbone, "spatial_dims", None) != 2:
            raise ValueError(
                f"Recognizer2D takes a 2-D backbone over (N S, H, W, C) "
                f"frames (PoTion), not {type(backbone).__name__}: a 3-D "
                f"backbone would read the folded segments as one volume")
        self.backbone, self.head = backbone, head
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, feat_ext: bool = False):
        n, s = x.shape[:2]
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        feat = self.backbone(x.reshape((n * s,) + tuple(x.shape[2:])))
        feat = feat.reshape((n, s) + tuple(feat.shape[1:]))
        if feat_ext:
            return feat.mean(dim=(2, 3)).mean(dim=1).float()
        return _cast_logits(self.head(feat), self.compute_dtype)


class MMRecognizer3D(nn.Module):
    """Multimodal RGB + pose recognizer (reference mm_recognizer3d.py:
    6-62): a two-input backbone (``RGBPoseConv3D``) over ``imgs`` (N, T,
    H, W, 3) and ``heatmap_imgs`` (N, T', H', W', 17) and an
    ``RGBPoseHead``; returns ``{'rgb', 'pose'}`` logits (float32 under a
    ``compute_dtype``, which casts both inputs).  Its loss is
    ``core/losses.py:mm_cross_entropy``; as in JAX, no trainer or CLI
    takes it."""

    def __init__(self, backbone: nn.Module, head: nn.Module,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone, self.head = backbone, head
        self.compute_dtype = compute_dtype

    def forward(self, imgs: torch.Tensor, heatmap_imgs: torch.Tensor):
        if self.compute_dtype is not None:
            imgs = imgs.to(self.compute_dtype)
            heatmap_imgs = heatmap_imgs.to(self.compute_dtype)
        scores = self.head(self.backbone(imgs, heatmap_imgs))
        return {k: _cast_logits(v, self.compute_dtype)
                for k, v in scores.items()}
