"""Shared building blocks for the GCN/TCN ops (channels-last ``(N, T, V, C)``).

The port's counterparts of ``dsgcn_tpu/ops/common.py``.  A 1x1 "conv" is a
linear map over the trailing channel axis; a k x 1 temporal conv runs as a
``Conv2d`` over a channels-last view, so no layout copy is made on the card.
Weights are stored in PyTorch's orientation; ``utils/convert.py`` re-orients
JAX checkpoints.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class PointConv(nn.Linear):
    """1x1 conv == linear map over the trailing channel axis (reference
    ``nn.Conv2d(in, out, 1)``).  Computes in the activation dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class TemporalConv(nn.Module):
    """k x 1 temporal convolution over (T, V), channels-last in and out.

    Matches reference ``nn.Conv2d(..., kernel_size=(k, 1), stride=(s, 1),
    dilation=(d, 1), padding=(pad, 0))`` with pad = (k + (k-1)(d-1) - 1) // 2
    (tcn.py:19-27).  ``conv`` holds the ``(O, I, k, 1)`` weight.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, dilation: int = 1,
                 bias: bool = True):
        super().__init__()
        k, d = kernel_size, dilation
        pad = (k + (k - 1) * (d - 1) - 1) // 2
        self.conv = nn.Conv2d(in_channels, out_channels, (k, 1),
                              stride=(stride, 1), dilation=(d, 1),
                              padding=(pad, 0), bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (N, T, V, C) -> an NCHW view with channels-last strides: cuDNN
        # runs it as NHWC without a copy, and the output permutes back
        w = self.conv.weight.to(x.dtype)
        b = None if self.conv.bias is None else self.conv.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.conv.stride,
                     self.conv.padding, self.conv.dilation)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over the trailing axis, eval form only.

    Eval applies the folded affine ``x * a + b`` with
    ``a = rsqrt(var + 1e-5) * weight`` and ``b = bias - mean * a``, computed
    in float32 and applied in the activation dtype, as the JAX package does
    (``dsgcn_tpu/ops/common.py:190-194``).  Batch statistics come with the
    training port; a module in training mode raises.
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.num_features = num_features
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def affine(self):
        """The float32 (a, b) of the eval affine."""
        a = torch.rsqrt(self.running_var.float() + BN_EPS) * self.weight.float()
        return a, self.bias.float() - self.running_mean.float() * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm statistics are not ported yet; "
                "call .eval() first")
        a, b = self.affine()
        return x * a.to(x.dtype) + b.to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.num_features}"


def max_pool_t(x: torch.Tensor, window: int, stride: int,
               padding: int) -> torch.Tensor:
    """Temporal max-pool (window, 1)/(stride, 1) with -inf padding, as torch
    MaxPool2d, on channels-last ``(N, T, V, C)``."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), (window, 1), (stride, 1),
                     (padding, 0))
    return y.permute(0, 2, 3, 1)
