"""3D-CNN backbones and the PoseC3D recognizer (port of the ResNet3d /
SlowOnly part of ``dsgcn_tpu/models/cnns.py``; reference
pyskl/models/cnns/resnet3d.py:201-626, resnet3d_slowonly.py:7-17).

The interface is JAX's: a recognizer takes heatmap volumes ``(N, T, H,
W, C)`` and a backbone returns ``(N, T', H', W', C')``.  Inside, the
backbone permutes once to PyTorch's ``(N, C, T, H, W)`` and runs
``nn.Conv3d``, cuDNN's 3-D convolutions and pools on the card in
channels_last_3d (the activations and each conv's weight alike), on the
CPU in NCDHW.  The
canonical PoseC3D configuration is SlowOnly-R50 with 17 heatmap channels
in, base 32, 3 stages (``configs/posec3d/slowonly_ntu60_xsub.py``).

Submodules carry the JAX scope names (``backbone.conv1``,
``backbone.layer{i}_{b}.conv2``, ``downsample``/``downsample_conv``,
``fc_cls``).  A :class:`ConvBN3d` holds its BatchNorm's parameters and
statistics at its own scope and its kernel in ``conv``: JAX's
``<name>/bn/{scale,bias,mean,var}`` and ``<name>/conv/kernel`` land there
through ``utils/convert.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.common import BN_EPS, BNStats, accum_dtype, cast
from ..ops.common import dropout as _dropout


def _triple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x, x)


def _format_of(x: torch.Tensor) -> torch.memory_format:
    """channels_last_3d where ``x`` is laid out so and not NCDHW."""
    if not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last_3d):
        return torch.channels_last_3d
    return torch.contiguous_format


class ConvBN3d(BNStats):
    """Conv3d without bias, symmetric padding ``(k - 1) // 2``, then a
    BatchNorm with torch's statistics (JAX ``TorchBN``: biased variance in
    the normalization, the unbiased one into the running variance,
    momentum 0.1, eps 1e-5) computed in at least float32 with the result
    cast back to the activation type, then an optional ReLU.  NCDHW in and
    out; the conv computes in the activation type, its weight in the
    activation's memory format."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1), act: bool = True):
        super().__init__()
        kernel, stride = _triple(kernel), _triple(stride)
        self.act = act
        self.conv = nn.Conv3d(in_channels, features, kernel, stride,
                              padding=tuple((k - 1) // 2 for k in kernel),
                              bias=False)
        self._init_bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        w = cast(c.weight, x.dtype).contiguous(memory_format=_format_of(x))
        y = F.conv3d(x, w, None, c.stride, c.padding)
        acc = accum_dtype(x.dtype)
        y = F.batch_norm(cast(y, acc), self.running_mean, self.running_var,
                         cast(self.weight, acc), cast(self.bias, acc),
                         self.training, 0.1, BN_EPS)
        y = cast(y, x.dtype)
        return F.relu(y) if self.act else y


class Bottleneck3d(nn.Module):
    """1x1x1 -> 1x3x3 (or 3x3x3) -> 1x1x1 bottleneck (resnet3d.py:97-198);
    inflate_style '3x1x1' puts the temporal kernel on conv1.  ``stride`` is
    (temporal, spatial) and sits on conv2; the downsample is a strided
    1x1x1 ConvBN3d, or with ``advanced`` a 1x1x1 ConvBN3d and an average
    pool over the stride (VALID)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int,
                 stride: Tuple[int, int] = (1, 1), inflate: bool = True,
                 inflate_style: str = "3x1x1", downsample: bool = False,
                 advanced: bool = False):
        super().__init__()
        mode = "no_inflate" if not inflate else inflate_style
        k1 = {"no_inflate": (1, 1, 1), "3x1x1": (3, 1, 1),
              "3x3x3": (1, 1, 1)}[mode]
        k2 = {"no_inflate": (1, 3, 3), "3x1x1": (1, 3, 3),
              "3x3x3": (3, 3, 3)}[mode]
        ts, ss = stride
        self.stride, self.advanced = (ts, ss, ss), advanced
        out = planes * self.expansion
        self.conv1 = ConvBN3d(inplanes, planes, k1)
        self.conv2 = ConvBN3d(planes, planes, k2, self.stride)
        self.conv3 = ConvBN3d(planes, out, (1, 1, 1), act=False)
        self.downsample = self.downsample_conv = None
        if downsample and advanced:
            self.downsample_conv = ConvBN3d(inplanes, out, (1, 1, 1),
                                            act=False)
        elif downsample:
            self.downsample = ConvBN3d(inplanes, out, (1, 1, 1), self.stride,
                                       act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(self.conv2(self.conv1(x)))
        if self.downsample_conv is not None:
            identity = F.avg_pool3d(self.downsample_conv(x), self.stride,
                                    self.stride)
        elif self.downsample is not None:
            identity = self.downsample(x)
        else:
            identity = x
        return F.relu(out + identity)


class BasicBlock3d(nn.Module):
    """Two 3x3x3 (or 1x3x3) convs (resnet3d.py:14-94); the stride sits on
    conv1 and on the strided 1x1x1 downsample."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int,
                 stride: Tuple[int, int] = (1, 1), inflate: bool = True,
                 downsample: bool = False):
        super().__init__()
        k = (3, 3, 3) if inflate else (1, 3, 3)
        ts, ss = stride
        self.conv1 = ConvBN3d(inplanes, planes, k, (ts, ss, ss))
        self.conv2 = ConvBN3d(planes, planes, k, act=False)
        self.downsample = (ConvBN3d(inplanes, planes, (1, 1, 1), (ts, ss, ss),
                                    act=False) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class ResNet3d(nn.Module):
    """ResNet3d trunk (resnet3d.py:201-626): the stem ConvBN3d at
    ``conv1_stride`` (temporal, spatial), a 1x3x3 max pool padded (0, 1, 1)
    at ``pool1_stride`` (it pools at stride (1, 1) too), the stages
    ``layer{i+1}_{b}`` (the first block of a stage strided and, where the
    stride or the width changes, downsampled), and with ``with_pool2`` a
    2x1x1 temporal max pool after the first stage.  Input (N, T, H, W, C),
    output (N, T', H', W', C') with C' = :attr:`out_channels`.

    The trunk runs channels_last_3d on the card (a SlowOnly-R50 b32 f32
    step ~2% faster than NCDHW on an H100 at 700 W, PERF.md §6) and
    NCDHW-contiguous on the CPU (torch 2.13.0's CPU build has corrupted its
    heap in the backward of a strided 1x1 conv over a channels-last view
    with few channels)."""
    conv1_kernel_default: Tuple[int, int, int] = (3, 7, 7)
    inflate_default: Tuple[int, ...] = (1, 1, 1, 1)

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 base_channels: int = 64, num_stages: int = 4,
                 stage_blocks: Optional[Sequence[int]] = None,
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 temporal_strides: Sequence[int] = (1, 1, 1, 1),
                 conv1_kernel: Optional[Sequence[int]] = None,
                 conv1_stride: Tuple[int, int] = (1, 2),
                 pool1_stride: Tuple[int, int] = (1, 2),
                 with_pool2: bool = False, advanced: bool = False,
                 inflate: Optional[Sequence] = None,
                 inflate_style: str = "3x1x1"):
        super().__init__()
        kind, default_blocks = ARCH_SETTINGS[depth]
        blocks = tuple(stage_blocks or default_blocks)[:num_stages]
        conv1_kernel = conv1_kernel or self.conv1_kernel_default
        inflate = self.inflate_default if inflate is None else inflate
        expansion = 4 if kind == "bottleneck" else 1
        cs_t, cs_s = conv1_stride
        ps_t, ps_s = pool1_stride
        self.pool1_stride = (ps_t, ps_s, ps_s)
        self.with_pool2 = with_pool2
        self.conv1 = ConvBN3d(in_channels, base_channels,
                              _triple(conv1_kernel), (cs_t, cs_s, cs_s))
        self.stages = []
        inplanes = base_channels
        for i, nblocks in enumerate(blocks):
            planes = base_channels * 2 ** i
            stage_inflate = inflate[i] if i < len(inflate) else 1
            infl = ((stage_inflate,) * nblocks
                    if isinstance(stage_inflate, int) else stage_inflate)
            names = []
            for b in range(nblocks):
                stride = ((temporal_strides[i], spatial_strides[i])
                          if b == 0 else (1, 1))
                down = b == 0 and (stride[1] != 1
                                   or inplanes != planes * expansion)
                if kind == "bottleneck":
                    block = Bottleneck3d(inplanes, planes, stride,
                                         inflate=bool(infl[b]),
                                         inflate_style=inflate_style,
                                         downsample=down, advanced=advanced)
                else:
                    block = BasicBlock3d(inplanes, planes, stride,
                                         inflate=bool(infl[b]),
                                         downsample=down)
                names.append(f"layer{i + 1}_{b}")
                self.add_module(names[-1], block)
                inplanes = planes * expansion
            self.stages.append(names)
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)                    # (N, C, T, H, W)
        x = self.conv1(x.contiguous(memory_format=(
            torch.channels_last_3d if x.is_cuda
            else torch.contiguous_format)))
        x = F.max_pool3d(x, (1, 3, 3), self.pool1_stride, (0, 1, 1))
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if self.with_pool2 and i == 0:
                x = F.max_pool3d(x, (2, 1, 1), (2, 1, 1))
        return x.permute(0, 2, 3, 4, 1)


class ResNet3dSlowOnly(ResNet3d):
    """SlowOnly: a 1x7x7 stem, temporal kernels only where ``inflate`` says
    (resnet3d_slowonly.py:7-17; defaults (0, 0, 1, 1))."""
    conv1_kernel_default = (1, 7, 7)
    inflate_default = (0, 0, 1, 1)


def posec3d_slowonly(**kw) -> ResNet3dSlowOnly:
    """SlowOnly-R50 as PoseC3D uses it (pyskl's posec3d configs)."""
    defaults = dict(depth=50, in_channels=17, base_channels=32, num_stages=3,
                    stage_blocks=(4, 6, 3), conv1_stride=(1, 1),
                    pool1_stride=(1, 1), inflate=(0, 1, 1),
                    spatial_strides=(2, 2, 2), temporal_strides=(1, 1, 2))
    defaults.update(kw)
    return ResNet3dSlowOnly(**defaults)


class RecognizerPoseC3D(nn.Module):
    """PoseC3D: heatmap volumes (N, T, H, W, C=V) -> a 3D-CNN backbone ->
    the mean over (T', H', W') -> dropout (training only, its mask from
    ``self.generator``) -> ``fc_cls`` (normal(0.01) weights, zero bias).
    Logits come back in the input's type; multi-clip averaging is the
    caller's (``recognizer.py:average_clip``)."""
    init_std = 0.01

    def __init__(self, backbone: nn.Module, num_classes: int = 60,
                 dropout: float = 0.5):
        super().__init__()
        self.backbone = backbone
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None
        self.fc_cls = nn.Linear(backbone.out_channels, num_classes)
        nn.init.normal_(self.fc_cls.weight, std=self.init_std)
        nn.init.zeros_(self.fc_cls.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.backbone(x).mean(dim=(1, 2, 3))
        pooled = _dropout(pooled, self.dropout, self.training,
                          self.generator)
        return F.linear(pooled, cast(self.fc_cls.weight, pooled.dtype),
                        cast(self.fc_cls.bias, pooled.dtype))
