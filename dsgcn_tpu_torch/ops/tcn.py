"""Temporal convolution ops of DS-GCN (channels-last ``(N, T, V, C)``).

The port of ``UnitTCN``, ``_MSBranches`` and ``DGMSTCN`` from
``dsgcn_tpu/ops/tcn.py``, train and eval.  DGMSTCN runs the reference
``concat`` layout, which is also the layout JAX trains with: the mean joint
is appended as an extra joint row, the branch stack runs once (so in
training the branch BatchNorms see the 26th joint), and the global row is
scaled back onto every joint (tcn.py:428-460).  Submodule names follow the JAX module's flax scopes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, PointConv, TemporalConv, dropout, max_pool_t

MsCfgEntry = Union[str, Tuple[Union[str, int], int]]
DEFAULT_MS_CFG: Tuple[MsCfgEntry, ...] = ((3, 1), (3, 2), (3, 3), (3, 4),
                                          ("max", 3), "1x1")


class UnitTCN(nn.Module):
    """k x 1 temporal conv + BN (reference unit_tcn, tcn.py:10-37)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, dilation: int = 1,
                 norm: Optional[str] = "BN"):
        super().__init__()
        self.conv = TemporalConv(in_channels, out_channels, kernel_size,
                                 stride, dilation)
        self.bn = BatchNorm(out_channels) if norm is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return self.bn(y) if self.bn is not None else y


class _MSBranches(nn.Module):
    """Multi-branch structure of mstcn/dgmstcn (reference tcn.py:134-153).

    Branch i: 1x1 -> BN -> ReLU -> {k x 1 dilated conv | maxpool}, or a plain
    strided 1x1.  Branch 0 gets the remainder channels.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[float] = None,
                 ms_cfg: Sequence[MsCfgEntry] = DEFAULT_MS_CFG,
                 stride: int = 1):
        super().__init__()
        self.ms_cfg = tuple(ms_cfg)
        self.stride = stride
        nb = len(self.ms_cfg)
        if mid_channels is None:
            mid = out_channels // nb
            rem = out_channels - mid * (nb - 1)
        else:
            mid = int(out_channels * mid_channels)
            rem = mid
        self.widths = [rem if i == 0 else mid for i in range(nb)]
        for i, (cfg, bc) in enumerate(zip(self.ms_cfg, self.widths)):
            if cfg == "1x1":
                self.add_module(f"branch{i}_conv", TemporalConv(
                    in_channels, bc, kernel_size=1, stride=stride))
                continue
            kind, val = cfg
            self.add_module(f"branch{i}_pre", PointConv(in_channels, bc))
            self.add_module(f"branch{i}_bn", BatchNorm(bc))
            if kind != "max":
                self.add_module(f"branch{i}_tcn", UnitTCN(
                    bc, bc, kernel_size=kind, stride=stride, dilation=val,
                    norm=None))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for i, cfg in enumerate(self.ms_cfg):
            if cfg == "1x1":
                outs.append(getattr(self, f"branch{i}_conv")(x))
                continue
            kind, val = cfg
            b = getattr(self, f"branch{i}_pre")(x)
            b = F.relu(getattr(self, f"branch{i}_bn")(b))
            if kind == "max":
                b = max_pool_t(b, window=val, stride=self.stride, padding=1)
            else:
                b = getattr(self, f"branch{i}_tcn")(b)
            outs.append(b)
        return torch.cat(outs, dim=-1)


class DGMSTCN(nn.Module):
    """DG-STGCN multi-scale TCN with a global joint-mean branch (reference
    dgmstcn, tcn.py:344-431) in the ``concat`` layout.  ``dropout`` acts in
    training only, its mask drawn from ``self.generator`` (a
    ``torch.Generator`` on the activations' device, or None for torch's
    default).  The JAX module's ``split`` eval layout, ``branch_kind='mlp'``
    and fused eval kernel (K7, ``use_pallas=True``) are not ported yet.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[float] = None, num_joints: int = 25,
                 dropout: float = 0.0,
                 ms_cfg: Sequence[MsCfgEntry] = DEFAULT_MS_CFG,
                 stride: int = 1, use_pallas: bool = False):
        super().__init__()
        if use_pallas:
            raise NotImplementedError(
                "tcn_use_pallas needs the fused DGMSTCN eval kernel K7 "
                "(dsgcn_tpu/ops/pallas/ms_tcn.py:fused_dgmstcn_eval), which "
                "is not ported yet")
        self.branches = _MSBranches(in_channels, out_channels, mid_channels,
                                    ms_cfg, stride)
        width = sum(self.branches.widths)
        self.add_coeff = nn.Parameter(torch.zeros(num_joints))
        self.transform_bn = BatchNorm(width)
        self.transform_conv = PointConv(width, out_channels)
        self.bn = BatchNorm(out_channels)
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.shape[2]
        # append the global mean joint as row v (tcn.py:409)
        xg = torch.cat([x, x.mean(dim=2, keepdim=True)], dim=2)
        out = self.branches(xg)
        coeff = self.add_coeff[:v].to(x.dtype)
        feat = out[:, :, :v] + out[:, :, v:] * coeff[None, None, :, None]
        feat = self.transform_conv(F.relu(self.transform_bn(feat)))
        return dropout(self.bn(feat), self.dropout, self.training,
                       self.generator)
