"""Classification heads (port of ``dsgcn_tpu/models/heads.py``:
``GCNHead`` and ``GCHead``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.common import cast
from ..ops.common import dropout as _dropout


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
        self.fc_cls = nn.Linear(in_channels, num_classes)
        nn.init.normal_(self.fc_cls.weight, std=init_std)
        nn.init.zeros_(self.fc_cls.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2:
            if x.dim() != 5:
                raise ValueError(f"expect (N, M, T, V, C) or (N, C), got "
                                 f"{tuple(x.shape)}")
            x = x.mean(dim=(2, 3)).mean(dim=1)
        x = _dropout(x, self.dropout, self.training, self.generator)
        w = cast(self.fc_cls.weight, x.dtype)
        return torch.nn.functional.linear(x, w,
                                          cast(self.fc_cls.bias, x.dtype))


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
        self.fc_cls = nn.Linear(in_channels, num_classes)
        nn.init.normal_(self.fc_cls.weight, std=init_std)
        nn.init.zeros_(self.fc_cls.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError(f"expect (N, M, V, V), got {tuple(x.shape)}")
        n, m = x.shape[:2]
        x = x.reshape(n, m, -1).mean(dim=1)
        x = _dropout(x, self.dropout, self.training, self.generator)
        w = cast(self.fc_cls.weight, x.dtype)
        return torch.nn.functional.linear(x, w,
                                          cast(self.fc_cls.bias, x.dtype))
