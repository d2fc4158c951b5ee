"""Classification heads (port of ``dsgcn_tpu/models/heads.py``:
``GCNHead``, ``GCHead``, ``HGTHead``, ``ClsHead``, the 3D-CNN heads
``SimpleHead3D`` (alias ``I3DHead``, ``SlowFastHead``), ``TSNHead`` and
``RGBPoseHead``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.common import accum_dtype, cast
from ..ops.common import dropout as _dropout


def _classifier(in_channels: int, num_classes: int,
                init_std: float) -> nn.Linear:
    fc = nn.Linear(in_channels, num_classes)
    nn.init.normal_(fc.weight, std=init_std)
    nn.init.zeros_(fc.bias)
    return fc


def _linear(fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``fc`` applied in the activation dtype."""
    return torch.nn.functional.linear(x, cast(fc.weight, x.dtype),
                                      cast(fc.bias, x.dtype))


class GCNHead(nn.Module):
    """GCN-mode SimpleHead (simple_head.py:83-96, GCNHead at :125-140).

    Pools (N, M, T, V, C) -> mean over (T, V) then mean over persons M,
    dropout (training only, mask from ``self.generator``), linear
    classifier with normal(std=0.01) init.
    """

    def __init__(self, num_classes: int, in_channels: int,
                 dropout: float = 0.0, init_std: float = 0.01):
        super().__init__()
        self.dropout, self.init_std = dropout, init_std
        self.generator: Optional[torch.Generator] = None
        self.fc_cls = _classifier(in_channels, num_classes, init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2:
            if x.dim() != 5:
                raise ValueError(f"expect (N, M, T, V, C) or (N, C), got "
                                 f"{tuple(x.shape)}")
            x = x.mean(dim=(2, 3)).mean(dim=1)
        x = _dropout(x, self.dropout, self.training, self.generator)
        return _linear(self.fc_cls, x)


class GCHead(nn.Module):
    """Graph-classification head over adjacency matrices
    (simple_head.py:298-366; JAX ``heads.py:GCHead``): (N, M, V, V) ->
    flattened per person, mean over persons, dropout (training only, mask
    from ``self.generator``), ``fc_cls`` with normal(``init_std``) weights
    and a zero bias.  ``in_channels`` is V * V."""

    def __init__(self, num_classes: int, in_channels: int,
                 dropout: float = 0.5, init_std: float = 0.01):
        super().__init__()
        self.dropout, self.init_std = dropout, init_std
        self.generator: Optional[torch.Generator] = None
        self.fc_cls = _classifier(in_channels, num_classes, init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"expect (N, M, V, V), got {tuple(x.shape)}")
        n, m = x.shape[:2]
        x = x.reshape(n, m, -1).mean(dim=1)
        x = _dropout(x, self.dropout, self.training, self.generator)
        return _linear(self.fc_cls, x)


# fixed per-joint body-part labels (simple_head.py:198-201)
NODE_LABELS = {
    "nturgb+d": (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
                 0, 1, 1, 2, 2),
    "coco": (0, 0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 3, 4, 3, 4, 3, 4),
}


def node_type_loss(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy of the body-part logits (..., P) against
    ``labels`` broadcast to the rows, unreduced; the log-softmax runs in
    ``accum_dtype`` (JAX casts to float32)."""
    logp = torch.log_softmax(cast(logits, accum_dtype(logits.dtype)), dim=-1)
    idx = labels.to(logits.device).long().expand(logp.shape[:-1])
    return -torch.gather(logp, -1, idx[..., None])[..., 0]


def joint_type_losses(x: torch.Tensor, fc: nn.Linear,
                      node_type) -> torch.Tensor:
    """Each (sample, person, joint)'s body-part cross entropy (N M V,):
    ``fc`` on the T-pooled feature of x (N, M, T, V, C), the labels
    ``node_type`` (length V) repeated over samples and persons (the
    necks' ``node_precost``, Simple_neck.py:94-107)."""
    n, m, t, v, c = x.shape
    logits = _linear(fc, x.mean(dim=2).reshape(n * m * v, c))
    labels = torch.as_tensor(node_type, device=x.device).repeat(n * m)
    return node_type_loss(logits, labels)


class HGTHead(nn.Module):
    """Classification head with an auxiliary node-type classifier
    (simple_head.py:162-245, DS-GCN's semantic supervision; JAX
    ``heads.py:HGTHead``).  Returns ``(cls_score, node_loss)``: the action
    logits of the (T, V)- then person-pooled feature, and the mean over
    (N, V) of the cross entropy of each joint's body part
    (``NODE_LABELS[pose_type]``, length V) predicted by ``node_cls`` from
    its T-pooled, person-meaned feature.  Dropout (training only, one mask
    from ``self.generator`` per branch) precedes both classifiers."""

    def __init__(self, num_classes: int, in_channels: int,
                 pose_type: str = "nturgb+d", dropout: float = 0.5,
                 init_std: float = 0.01, num_parts: int = 5):
        super().__init__()
        self.dropout, self.init_std = dropout, init_std
        self.generator: Optional[torch.Generator] = None
        self.register_buffer("labels", torch.tensor(NODE_LABELS[pose_type]),
                             persistent=False)
        self.fc_cls = _classifier(in_channels, num_classes, init_std)
        self.node_cls = _classifier(in_channels, num_parts, init_std)

    def forward(self, x: torch.Tensor):
        if x.dim() != 5:
            raise ValueError(f"expect (N, M, T, V, C), got {tuple(x.shape)}")
        v = x.shape[3]
        if v != self.labels.shape[0]:
            raise ValueError(f"{v} joints against {self.labels.shape[0]} "
                             "node labels")
        pooled = x.mean(dim=(2, 3)).mean(dim=1)
        drop = lambda h: _dropout(h, self.dropout, self.training,  # noqa
                                  self.generator)
        cls_score = _linear(self.fc_cls, drop(pooled))
        nodes = x.mean(dim=2).mean(dim=1)                   # (N, V, C)
        node_score = _linear(self.node_cls, drop(nodes))
        return cls_score, node_type_loss(node_score, self.labels).mean()


class ClsHead(nn.Module):
    """Pre-pooled-feature head (simple_head.py:247-296; JAX
    ``heads.py:ClsHead``): dropout (training only) and ``fc_cls`` on an
    (N, C) input."""

    def __init__(self, num_classes: int, in_channels: int,
                 dropout: float = 0.5, init_std: float = 0.01):
        super().__init__()
        self.dropout, self.init_std = dropout, init_std
        self.generator: Optional[torch.Generator] = None
        self.fc_cls = _classifier(in_channels, num_classes, init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2:
            raise ValueError(f"expect (N, C), got {tuple(x.shape)}")
        x = _dropout(x, self.dropout, self.training, self.generator)
        return _linear(self.fc_cls, x)


def _pool_channels_last(x: torch.Tensor) -> torch.Tensor:
    """The mean over every axis but the first and the last."""
    return x.mean(dim=tuple(range(1, x.dim() - 1)))


class SimpleHead3D(nn.Module):
    """3D-CNN-mode SimpleHead (simple_head.py:77-82): the mean over every
    axis but the first and the last of (N, T, H, W, C) features, or of each
    pathway's, concatenated on channels, for a tuple (SlowFast,
    simple_head.py:79-80); dropout (training only, mask from
    ``self.generator``); ``fc_cls`` with normal(``init_std``) weights and a
    zero bias."""

    def __init__(self, num_classes: int, in_channels: int,
                 dropout: float = 0.5, init_std: float = 0.01):
        super().__init__()
        self.dropout, self.init_std = dropout, init_std
        self.generator: Optional[torch.Generator] = None
        self.fc_cls = _classifier(in_channels, num_classes, init_std)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (tuple, list)):
            x = torch.cat([_pool_channels_last(f) for f in x], dim=-1)
        else:
            x = _pool_channels_last(x)
        x = _dropout(x, self.dropout, self.training, self.generator)
        return _linear(self.fc_cls, x)


# I3DHead (simple_head.py:100-117) and SlowFastHead (:119-121) are
# SimpleHead in 3-D mode; the tuple path covers SlowFast
I3DHead = SimpleHead3D
SlowFastHead = SimpleHead3D


class TSNHead(nn.Module):
    """2-D-mode SimpleHead (simple_head.py:70-77, TSNHead at :143-159):
    (N, S, H, W, C) segments -> the spatial mean -> the mean over segments
    -> dropout (training only, mask from ``self.generator``) -> ``fc_cls``
    (normal(``init_std``), zero bias)."""

    def __init__(self, num_classes: int, in_channels: int,
                 dropout: float = 0.5, init_std: float = 0.01):
        super().__init__()
        self.dropout, self.init_std = dropout, init_std
        self.generator: Optional[torch.Generator] = None
        self.fc_cls = _classifier(in_channels, num_classes, init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 5:
            raise ValueError(f"expect (N, S, H, W, C), got {tuple(x.shape)}")
        x = x.mean(dim=(2, 3)).mean(dim=1)
        x = _dropout(x, self.dropout, self.training, self.generator)
        return _linear(self.fc_cls, x)


class RGBPoseHead(nn.Module):
    """Two-stream head of RGBPoseConv3D (reference heads/rgbpose_head.py:
    9-79): each pathway's features pooled (every axis but the first and
    the last), a dropout mask drawn for each stream (training only, from
    ``self.generator``, rgb first), and ``fc_rgb`` / ``fc_pose``
    (normal(``init_std``), zero biases); returns ``{'rgb', 'pose'}``
    logits.  ``in_channels`` is (rgb C, pose C)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 dropout: float = 0.5, init_std: float = 0.01):
        super().__init__()
        self.dropout, self.init_std = dropout, init_std
        self.generator: Optional[torch.Generator] = None
        self.fc_rgb = _classifier(in_channels[0], num_classes, init_std)
        self.fc_pose = _classifier(in_channels[1], num_classes, init_std)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x_rgb, x_pose = (_dropout(_pool_channels_last(f), self.dropout,
                                  self.training, self.generator) for f in x)
        return {"rgb": _linear(self.fc_rgb, x_rgb),
                "pose": _linear(self.fc_pose, x_pose)}
