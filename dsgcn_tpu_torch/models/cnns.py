"""The 3-D and 2-D CNN backbones and the PoseC3D recognizer (port of
``dsgcn_tpu/models/cnns.py``; reference pyskl/models/cnns/resnet3d.py,
resnet3d_slowonly.py, c3d.py, x3d.py, potion.py, resnet3d_slowfast.py,
rgbposeconv3d.py): ResNet3d and SlowOnly, C3D, X3D, PoTion, the SlowFast
pathways and ``ResNet3dSlowFast``, ``RGBPoseConv3D``.

The interface is JAX's: a recognizer takes channels-last volumes ``(N, T,
H, W, C)`` (PoTion images ``(N, H, W, C)``) and a backbone returns ``(N,
T', H', W', C')`` (a two-pathway one a pair).  Inside, the backbone
permutes once to PyTorch's ``(N, C, T, H, W)`` and runs ``nn.Conv3d``,
cuDNN's 3-D convolutions and pools on the card in channels_last_3d (the
activations and each conv's weight alike), on the CPU in NCDHW.  The
canonical PoseC3D configuration is SlowOnly-R50 with 17 heatmap channels
in, base 32, 3 stages (``configs/posec3d/slowonly_ntu60_xsub.py``).

Submodules carry the JAX scope names (``backbone.conv1``,
``backbone.layer{i}_{b}.conv2``, ``downsample``/``downsample_conv``,
``rgb_path.layer{i}.block{b}``, ``pose_path.layer{i}_lateral``,
``fc_cls``).  A :class:`ConvBN3d` (or :class:`ConvBN2d`) holds its
BatchNorm's parameters and statistics at its own scope and its kernel in
``conv``: JAX's ``<name>/bn/{scale,bias,mean,var}`` and
``<name>/conv/kernel`` land there through ``utils/convert.py``.  flax
infers a conv's input channels; torch builds them in, so the backbones
take ``in_channels`` (and the pathways the widths their laterals
receive).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.common import BN_EPS, BNStats, accum_dtype, cast
from ..ops.common import dropout as _dropout


def _triple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x, x)


def _enter(x: torch.Tensor) -> torch.Tensor:
    """JAX's channels-last (N, T, H, W, C) (or (N, H, W, C)) as PyTorch's
    (N, C, T, H, W) (or (N, C, H, W)), laid out channels-last on the card
    and contiguous on the CPU."""
    x = x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))
    fmt = ((torch.channels_last_3d if x.dim() == 5 else torch.channels_last)
           if x.is_cuda else torch.contiguous_format)
    return x.contiguous(memory_format=fmt)


def _leave(x: torch.Tensor) -> torch.Tensor:
    """(N, C, ...) back to JAX's channels-last (N, ..., C) (a view)."""
    return x.permute(0, *range(2, x.dim()), 1)


def _format_of(x: torch.Tensor) -> torch.memory_format:
    """channels_last_3d (channels_last for a 4-D ``x``) where ``x`` is
    laid out so and not contiguous."""
    fmt = torch.channels_last_3d if x.dim() == 5 else torch.channels_last
    if not x.is_contiguous() and x.is_contiguous(memory_format=fmt):
        return fmt
    return torch.contiguous_format


class ConvBN3d(BNStats):
    """Conv3d without bias, symmetric padding ``(k - 1) // 2``, then a
    BatchNorm with torch's statistics (JAX ``TorchBN``: biased variance in
    the normalization, the unbiased one into the running variance,
    momentum 0.1, eps 1e-5) computed in at least float32 with the result
    cast back to the activation type, then an optional ReLU.  NCDHW in and
    out; the conv computes in the activation type, its weight in the
    activation's memory format.  ``groups`` makes a grouped (depthwise)
    conv; ``zero_gamma`` starts the BatchNorm's scale at 0 (X3D's
    zero_init_residual); ``with_bn=False`` leaves the BatchNorm out and
    keeps no BatchNorm state (X3D's ``conv1_s``), as JAX's tree then has
    no ``bn`` scope."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1), act: bool = True,
                 groups: int = 1, zero_gamma: bool = False,
                 with_bn: bool = True):
        super().__init__()
        kernel, stride = _triple(kernel), _triple(stride)
        self.act, self.with_bn = act, with_bn
        self.conv = nn.Conv3d(in_channels, features, kernel, stride,
                              padding=tuple((k - 1) // 2 for k in kernel),
                              groups=groups, bias=False)
        if with_bn:
            self._init_bn(features)
            if zero_gamma:
                nn.init.zeros_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        w = cast(c.weight, x.dtype).contiguous(memory_format=_format_of(x))
        y = F.conv3d(x, w, None, c.stride, c.padding, 1, c.groups)
        if self.with_bn:
            acc = accum_dtype(x.dtype)
            y = F.batch_norm(cast(y, acc), self.running_mean,
                             self.running_var, cast(self.weight, acc),
                             cast(self.bias, acc), self.training, 0.1,
                             BN_EPS)
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
        x = self.conv1(_enter(x))
        x = F.max_pool3d(x, (1, 3, 3), self.pool1_stride, (0, 1, 1))
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if self.with_pool2 and i == 0:
                x = F.max_pool3d(x, (2, 1, 1), (2, 1, 1))
        return _leave(x)


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


class C3D(nn.Module):
    """C3D (reference cnns/c3d.py:11-95): 3x3x3 ``ConvBN3d`` stacks
    ``conv1a``, ``conv2a``, ``conv3a``/``conv3b``, ``conv4a``/``conv4b``
    (and with four stages ``conv5a``/``conv5b``) between VALID average
    pools, spatial (1, 2, 2) after the first conv and (2, 2, 2), or (1, 2,
    2) without ``temporal_downsample``, after the others.  Input (N, T, H,
    W, C), output (N, T', H', W', 8 ``base_channels``)."""
    spatial_dims = 3

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 num_stages: int = 4, temporal_downsample: bool = True):
        super().__init__()
        if num_stages not in (3, 4):
            raise ValueError(f"C3D has 3 or 4 stages, not {num_stages}")
        b = base_channels
        self.pool = (2, 2, 2) if temporal_downsample else (1, 2, 2)
        self.num_stages = num_stages
        widths = [("conv1a", b), ("conv2a", 2 * b), ("conv3a", 4 * b),
                  ("conv3b", 4 * b), ("conv4a", 8 * b), ("conv4b", 8 * b)]
        if num_stages == 4:
            widths += [("conv5a", 8 * b), ("conv5b", 8 * b)]
        c = in_channels
        for name, f in widths:
            self.add_module(name, ConvBN3d(c, f, (3, 3, 3)))
            c = f
        self.out_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pk = self.pool
        x = F.avg_pool3d(self.conv1a(_enter(x)), (1, 2, 2), (1, 2, 2))
        x = F.avg_pool3d(self.conv2a(x), pk, pk)
        x = F.avg_pool3d(self.conv3b(self.conv3a(x)), pk, pk)
        x = self.conv4b(self.conv4a(x))
        if self.num_stages == 4:
            x = F.avg_pool3d(x, pk, pk)
            x = self.conv5b(self.conv5a(x))
        return _leave(x)


def _round_width(width, multiplier, min_width=8, divisor=8):
    """X3D's filter rounding (reference cnns/x3d.py:26-34, 299-311)."""
    if not multiplier:
        return int(width)
    width *= multiplier
    min_width = min_width or divisor
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def _round_repeats(repeats, multiplier):
    """X3D's depth rounding (reference cnns/x3d.py:313-318)."""
    if not multiplier:
        return repeats
    return int(math.ceil(multiplier * repeats))


class SEModule3d(nn.Module):
    """Squeeze-and-excitation over (T, H, W) (reference cnns/x3d.py:13-43):
    the mean, the biased 1x1x1 convs ``fc1`` (to ``_round_width(channels,
    reduction)``), ReLU, ``fc2``, and the sigmoid's gate.  NCDHW."""

    def __init__(self, channels: int, reduction: float):
        super().__init__()
        bottleneck = _round_width(channels, reduction)
        self.fc1 = nn.Conv3d(channels, bottleneck, 1)
        self.fc2 = nn.Conv3d(bottleneck, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        s = F.relu(F.conv3d(s, cast(self.fc1.weight, x.dtype),
                            cast(self.fc1.bias, x.dtype)))
        s = F.conv3d(s, cast(self.fc2.weight, x.dtype),
                     cast(self.fc2.bias, x.dtype))
        return x * torch.sigmoid(s)


class BlockX3D(nn.Module):
    """X3D's inverted bottleneck (reference cnns/x3d.py:46-157): a 1x1x1
    expansion to ``planes``, a depthwise 3x3x3 (``groups=planes``, the
    spatial stride there) without ReLU, SE where ``se_ratio`` is given,
    swish where ``use_swish``, a 1x1x1 projection to ``outplanes`` whose
    BatchNorm scale starts at 0, and the residual (a strided 1x1x1
    ``downsample`` where asked)."""

    def __init__(self, inplanes: int, planes: int, outplanes: int,
                 spatial_stride: int = 1, downsample: bool = False,
                 se_ratio: Optional[float] = None, use_swish: bool = True):
        super().__init__()
        s = spatial_stride
        self.use_swish = use_swish
        self.conv1 = ConvBN3d(inplanes, planes, (1, 1, 1))
        self.conv2 = ConvBN3d(planes, planes, (3, 3, 3), (1, s, s),
                              act=False, groups=planes)
        self.se_module = (SEModule3d(planes, se_ratio)
                          if se_ratio is not None else None)
        self.conv3 = ConvBN3d(planes, outplanes, (1, 1, 1), act=False,
                              zero_gamma=True)
        self.downsample = (ConvBN3d(inplanes, outplanes, (1, 1, 1),
                                    (1, s, s), act=False)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if self.se_module is not None:
            out = self.se_module(out)
        if self.use_swish:
            out = out * torch.sigmoid(out)
        out = self.conv3(out)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class X3D(nn.Module):
    """X3D (reference cnns/x3d.py:161-503): widths scaled by ``gamma_w``
    (``_round_width``), depths by ``gamma_d`` (``_round_repeats``), the
    blocks' expansion by ``gamma_b``; a stem of ``conv1_s`` (1x3x3, spatial
    stride 2, no BatchNorm, no ReLU) and the depthwise temporal ``conv1_t``
    (5x1x1); stages ``layer{i+1}_{b}`` of :class:`BlockX3D` (SE on every
    block with ``se_style='all'``, on every other one with 'half'); a
    closing 1x1x1 ``conv5``.  Input (N, T, H, W, C), output (N, T, H', W',
    :attr:`out_channels`)."""
    spatial_dims = 3

    def __init__(self, gamma_w: float = 1.0, gamma_b: float = 2.25,
                 gamma_d: float = 2.2, in_channels: int = 3,
                 base_channels: int = 24, num_stages: int = 4,
                 stage_blocks: Sequence[int] = (1, 2, 5, 3),
                 spatial_strides: Sequence[int] = (2, 2, 2, 2),
                 se_style: str = "half", se_ratio: Optional[float] = 1 / 16,
                 use_swish: bool = True):
        super().__init__()
        if se_style not in ("all", "half"):
            raise ValueError(f"se_style {se_style!r}: 'all' or 'half'")
        base = _round_width(base_channels, gamma_w)
        blocks = [_round_repeats(b, gamma_d)
                  for b in stage_blocks][:num_stages]
        self.conv1_s = ConvBN3d(in_channels, base, (1, 3, 3), (1, 2, 2),
                                act=False, with_bn=False)
        self.conv1_t = ConvBN3d(base, base, (5, 1, 1), groups=base)
        self.blocks = []
        layer_inplanes = base
        for i, nblocks in enumerate(blocks):
            inplanes = base * 2 ** i
            planes = int(inplanes * gamma_b)
            stride = spatial_strides[i]
            for b in range(nblocks):
                use_se = se_style == "all" or b % 2 == 0
                self.blocks.append(f"layer{i + 1}_{b}")
                self.add_module(self.blocks[-1], BlockX3D(
                    layer_inplanes if b == 0 else inplanes, planes,
                    inplanes, spatial_stride=stride if b == 0 else 1,
                    downsample=b == 0 and (stride != 1
                                           or layer_inplanes != inplanes),
                    se_ratio=se_ratio if use_se else None,
                    use_swish=use_swish))
            layer_inplanes = inplanes
        feat_dim = base * 2 ** (len(blocks) - 1)
        self.out_channels = int(feat_dim * gamma_b)
        self.conv5 = ConvBN3d(feat_dim, self.out_channels, (1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1_t(self.conv1_s(_enter(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return _leave(self.conv5(x))


class ConvBN2d(BNStats):
    """PoTion's ConvModule: Conv2d without bias, padding ``(k - 1) // 2``,
    a BatchNorm in at least float32 (as :class:`ConvBN3d`'s) and ReLU.
    NCHW in and out."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Tuple[int, int] = (3, 3), stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride,
                              padding=tuple((k - 1) // 2 for k in kernel),
                              bias=False)
        self._init_bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        w = cast(c.weight, x.dtype).contiguous(memory_format=_format_of(x))
        y = F.conv2d(x, w, None, c.stride, c.padding)
        acc = accum_dtype(x.dtype)
        y = F.batch_norm(cast(y, acc), self.running_mean, self.running_var,
                         cast(self.weight, acc), cast(self.bias, acc),
                         self.training, 0.1, BN_EPS)
        return F.relu(cast(y, x.dtype))


class PoTion(nn.Module):
    """PoTion's 2-D CNN over pose-motion images (reference
    cnns/potion.py:7-80): stages of ``num_layers`` :class:`ConvBN2d`
    (``layer{i+1}_{j}``, 3x3, the first of a stage at stride 2) with
    ``channels`` outputs, each followed by elementwise dropout of
    ``lw_dropout`` in training (its mask from ``self.generator``).  Input
    (N, H, W, C), output (N, H', W', ``channels[-1]``)."""
    spatial_dims = 2

    def __init__(self, in_channels: int = 17,
                 channels: Sequence[int] = (128, 256, 512),
                 num_layers: Sequence[int] = (2, 2, 2),
                 lw_dropout: float = 0.0):
        super().__init__()
        if len(channels) != len(num_layers):
            raise ValueError(f"channels {channels} and num_layers "
                             f"{num_layers} differ in length")
        self.lw_dropout = lw_dropout
        self.generator: Optional[torch.Generator] = None
        self.layers = []
        c = in_channels
        for i, (ch, nl) in enumerate(zip(channels, num_layers)):
            for j in range(nl):
                self.layers.append(f"layer{i + 1}_{j}")
                self.add_module(self.layers[-1], ConvBN2d(
                    c, ch, (3, 3), stride=2 if j == 0 else 1))
                c = ch
        self.out_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _enter(x)
        for name in self.layers:
            x = _dropout(getattr(self, name)(x), self.lw_dropout,
                         self.training, self.generator)
        return _leave(x)


def _torch_nearest_resize_t(x: torch.Tensor, out_t: int) -> torch.Tensor:
    """``F.interpolate(mode='nearest')`` on the T axis of (N, C, T, H, W):
    source frame floor(dst * in / out), the reference's slow/fast frame
    resampling (resnet3d_slowfast.py:300-306)."""
    in_t = x.shape[2]
    idx = np.floor(np.arange(out_t) * (in_t / out_t)).astype(np.int64)
    return x.index_select(2, torch.from_numpy(idx).to(x.device))


class _PathwayStem(nn.Module):
    """A pathway's stem (resnet3d.py:526-543): ``conv1``, then a 1x3x3 max
    pool padded (0, 1, 1) at ``pool1_stride``.  NCDHW."""

    def __init__(self, in_channels: int, base_channels: int,
                 conv1_kernel: Sequence[int], conv1_stride: Tuple[int, int],
                 pool1_stride: Tuple[int, int]):
        super().__init__()
        cs_t, cs_s = conv1_stride
        ps_t, ps_s = pool1_stride
        self.pool1_stride = (ps_t, ps_s, ps_s)
        self.conv1 = ConvBN3d(in_channels, base_channels,
                              _triple(conv1_kernel), (cs_t, cs_s, cs_s))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(self.conv1(x), (1, 3, 3), self.pool1_stride,
                            (0, 1, 1))


class _ResStage(nn.Module):
    """One ResNet3d stage of ``blocks`` blocks ``block{b}``, the first at
    ``stride`` (temporal, spatial) and downsampled where the stride or the
    input's (lateral-widened) ``in_channels`` ask for it.  NCDHW."""

    def __init__(self, kind: str, in_channels: int, planes: int,
                 blocks: int, stride: Tuple[int, int],
                 inflate: Sequence[int], inflate_style: str = "3x1x1"):
        super().__init__()
        expansion = 4 if kind == "bottleneck" else 1
        self.names = []
        c = in_channels
        for b in range(blocks):
            st = tuple(stride) if b == 0 else (1, 1)
            down = b == 0 and (st[1] != 1 or c != planes * expansion)
            if kind == "bottleneck":
                block = Bottleneck3d(c, planes, st, inflate=bool(inflate[b]),
                                     inflate_style=inflate_style,
                                     downsample=down)
            else:
                block = BasicBlock3d(c, planes, st, inflate=bool(inflate[b]),
                                     downsample=down)
            self.names.append(f"block{b}")
            self.add_module(self.names[-1], block)
            c = planes * expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class _LateralConv(nn.Module):
    """A cross-pathway fusion conv (resnet3d_slowfast.py:40-72) to twice
    its input's channels (divided by ``infl`` with ``inv``), kernel
    (``fusion_kernel``, 1, 1), no bias.  Forward: time strided by
    ``speed_ratio``, padding (k - 1) // 2.  ``inv``: time upsampled by
    ``speed_ratio`` as flax's ``ConvTranspose(padding='SAME')``, which is
    ``conv_transpose3d`` with the kernel flipped in time, padding k - 1 -
    ceil((k + s - 2) / 2) and the output cut to T s frames (for k 7, s 4:
    padding 1, the last of 4T + 1 frames dropped); the weight is torch's
    (I, O, k, 1, 1), ``utils/convert.py`` flips JAX's kernel into it.
    NCDHW."""

    def __init__(self, in_channels: int, speed_ratio: int,
                 fusion_kernel: int = 7, inv: bool = False, infl: int = 1):
        super().__init__()
        k, s = fusion_kernel, speed_ratio
        self.inv, self.speed_ratio = inv, s
        self.out_channels = in_channels * 2 // infl if inv \
            else in_channels * 2
        if inv:
            if s > k:
                raise ValueError(f"a transposed lateral of stride {s} over "
                                 f"kernel {k} is not supported")
            pad = k - 1 - (k - 1 if s > k - 1 else -(-(k + s - 2) // 2))
            self.conv = nn.ConvTranspose3d(in_channels, self.out_channels,
                                           (k, 1, 1), (s, 1, 1),
                                           padding=(pad, 0, 0), bias=False)
        else:
            self.conv = nn.Conv3d(in_channels, self.out_channels, (k, 1, 1),
                                  (s, 1, 1), padding=((k - 1) // 2, 0, 0),
                                  bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        w = cast(c.weight, x.dtype).contiguous(memory_format=_format_of(x))
        if not self.inv:
            return F.conv3d(x, w, None, c.stride, c.padding)
        y = F.conv_transpose3d(x, w, None, c.stride, c.padding)
        return y[:, :, :x.shape[2] * self.speed_ratio]


def pathway_width(depth: int, base_channels: int, level: int) -> int:
    """A pathway's channels after its stem (level 0) or after stage
    ``level`` (counted from 1)."""
    if level == 0:
        return base_channels
    expansion = 4 if ARCH_SETTINGS[depth][0] == "bottleneck" else 1
    return base_channels * 2 ** (level - 1) * expansion


class ResNet3dPathway(nn.Module):
    """One SlowFast or RGBPose pathway (reference
    cnns/resnet3d_slowfast.py:15-94): a ResNet3d trunk whose ``stem``,
    ``stage(i, x)`` and ``lateral_conv(i, x)`` are callable one by one on
    NCDHW tensors, so that the parent interleaves the cross-pathway
    fusion; ``forward`` takes (N, T, H, W, C) through the stem and stages
    alone.  With ``lateral`` a :class:`_LateralConv` feeds each stage i
    whose ``lateral_activate[i]`` is set (all without it), named
    ``conv1_lateral`` (i = 0, after the stem) or ``layer{i}_lateral``;
    its output is concatenated to the stage's input.  flax infers each
    conv's input channels, torch must know them: ``lateral_in[i]`` is the
    channels that lateral i receives (the other pathway's at that point),
    and each stage is built for its own input plus its lateral's output.
    ``channel_ratio`` is accepted as JAX's field and unused, as there."""
    spatial_dims = 3

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 base_channels: int = 64, num_stages: int = 4,
                 stage_blocks: Optional[Sequence[int]] = None,
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 temporal_strides: Sequence[int] = (1, 1, 1, 1),
                 conv1_kernel: Sequence[int] = (1, 7, 7),
                 conv1_stride: Tuple[int, int] = (1, 2),
                 pool1_stride: Tuple[int, int] = (1, 2),
                 inflate: Sequence = (0, 0, 1, 1),
                 inflate_style: str = "3x1x1", lateral: bool = False,
                 lateral_inv: bool = False, lateral_infl: int = 1,
                 lateral_activate: Optional[Sequence[int]] = None,
                 speed_ratio: int = 8, channel_ratio: int = 8,
                 fusion_kernel: int = 7,
                 lateral_in: Optional[Sequence[int]] = None):
        super().__init__()
        kind, default_blocks = ARCH_SETTINGS[depth]
        blocks = tuple(stage_blocks or default_blocks)[:num_stages]
        self.stem = _PathwayStem(in_channels, base_channels, conv1_kernel,
                                 conv1_stride, pool1_stride)
        self.laterals = {}
        if lateral:
            if lateral_in is None:
                raise ValueError("a lateral pathway needs lateral_in, the "
                                 "channels each lateral conv receives")
            for i in range(num_stages):
                if lateral_activate is None or lateral_activate[i]:
                    self.laterals[i] = ("conv1_lateral" if i == 0
                                        else f"layer{i}_lateral")
                    self.add_module(self.laterals[i], _LateralConv(
                        lateral_in[i], speed_ratio, fusion_kernel,
                        inv=lateral_inv, infl=lateral_infl))
        self.stages = []
        for i, nblocks in enumerate(blocks):
            stage_inflate = inflate[i] if i < len(inflate) else 1
            infl = ((stage_inflate,) * nblocks
                    if isinstance(stage_inflate, int) else stage_inflate)
            c = pathway_width(depth, base_channels, i)
            if i in self.laterals:
                c += getattr(self, self.laterals[i]).out_channels
            self.stages.append(f"layer{i + 1}")
            self.add_module(self.stages[-1], _ResStage(
                kind, c, base_channels * 2 ** i, nblocks,
                (temporal_strides[i], spatial_strides[i]), infl,
                inflate_style))
        self.out_channels = pathway_width(depth, base_channels, len(blocks))

    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.stages[i])(x)

    def lateral_conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The lateral conv feeding stage i (0: the stem's level)."""
        return getattr(self, self.laterals[i])(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(_enter(x))
        for i in range(len(self.stages)):
            x = self.stage(i, x)
        return _leave(x)


class ResNet3dSlowFast(nn.Module):
    """SlowFast (reference cnns/resnet3d_slowfast.py:220-328): the slow
    pathway sees every ``resample_rate``-th frame, the fast one every
    (``resample_rate // speed_ratio``)-th (nearest, by floor index); the
    fast pathway's features feed the slow one through a lateral after the
    stem and after every stage but the last.  The slow pathway is a
    SlowOnly ResNet of ``slow_depth`` (1x7x7 stem, inflate (0, 0, 1, 1)),
    the fast one a ResNet of ``fast_depth`` at ``fast_base_channels``
    (5x7x7 stem, every stage inflated).  Input (N, T, H, W, C) with
    ``in_channels`` (JAX has no such field: flax infers it); returns
    (x_slow, x_fast), each (N, T', H', W', C')."""
    spatial_dims = 3

    def __init__(self, resample_rate: int = 8, speed_ratio: int = 8,
                 channel_ratio: int = 8, slow_depth: int = 50,
                 fast_depth: int = 50, fast_base_channels: int = 8,
                 in_channels: int = 3):
        super().__init__()
        self.resample_rate, self.speed_ratio = resample_rate, speed_ratio
        self.fast_path = ResNet3dPathway(
            depth=fast_depth, in_channels=in_channels,
            base_channels=fast_base_channels, conv1_kernel=(5, 7, 7),
            inflate=(1, 1, 1, 1))
        self.slow_path = ResNet3dPathway(
            depth=slow_depth, in_channels=in_channels, lateral=True,
            conv1_kernel=(1, 7, 7), inflate=(0, 0, 1, 1),
            speed_ratio=speed_ratio, channel_ratio=channel_ratio,
            lateral_in=[pathway_width(fast_depth, fast_base_channels, i)
                        for i in range(4)])
        self.out_channels = (self.slow_path.out_channels,
                             self.fast_path.out_channels)

    def forward(self, x: torch.Tensor):
        x = _enter(x)
        t = x.shape[2]
        x_slow = _torch_nearest_resize_t(x, t // self.resample_rate)
        x_fast = _torch_nearest_resize_t(
            x, t // (self.resample_rate // self.speed_ratio))
        slow, fast = self.slow_path, self.fast_path
        x_slow, x_fast = slow.stem(x_slow), fast.stem(x_fast)
        x_slow = torch.cat([x_slow, slow.lateral_conv(0, x_fast)], dim=1)
        n = len(slow.stages)
        for i in range(n):
            x_slow = slow.stage(i, x_slow)
            x_fast = fast.stage(i, x_fast)
            if i != n - 1:
                x_slow = torch.cat(
                    [x_slow, slow.lateral_conv(i + 1, x_fast)], dim=1)
        return _leave(x_slow), _leave(x_fast)


class RGBPoseConv3D(nn.Module):
    """Two-stream RGB and pose-heatmap backbone with laterals both ways
    (reference cnns/rgbposeconv3d.py:13-179; JAX ``cnns.py:RGBPoseConv3D``,
    the working form of the reference's unconstructible module): an R50
    rgb pathway (base 64, four stages) and a SlowOnly-R50 pose pathway
    (base 32, blocks (4, 6, 3), spatial strides 2, no temporal stride).
    After (rgb layer2, pose layer1) and again after (rgb layer3, pose
    layer2) the rgb laterals take pose features (time strided by
    ``speed_ratio``) and the pose laterals rgb features (time upsampled,
    a transposed conv, channels divided by 16), each concatenated to the
    receiving pathway.  ``rgb_detach``/``pose_detach`` detach the features
    a lateral of that stream receives; in training ``rgb_drop_path`` /
    ``pose_drop_path`` drop a whole lateral output (kept where a uniform
    draw from ``self.generator`` is >= p, not rescaled).  Inputs (N, T, H,
    W, 3) and (N, 4T, H / 4, W / 4, 17) by default (``rgb_in_channels``,
    ``pose_in_channels``: flax infers them); returns (x_rgb, x_pose)."""
    spatial_dims = 3

    def __init__(self, speed_ratio: int = 4, channel_ratio: int = 4,
                 rgb_detach: bool = False, pose_detach: bool = False,
                 rgb_drop_path: float = 0.0, pose_drop_path: float = 0.0,
                 rgb_in_channels: int = 3, pose_in_channels: int = 17):
        super().__init__()
        self.rgb_detach, self.pose_detach = rgb_detach, pose_detach
        self.rgb_drop_path, self.pose_drop_path = rgb_drop_path, \
            pose_drop_path
        self.generator: Optional[torch.Generator] = None
        rgb_w = [pathway_width(50, 64, i) for i in range(5)]
        pose_w = [pathway_width(50, 32, i) for i in range(4)]
        self.rgb_path = ResNet3dPathway(
            depth=50, in_channels=rgb_in_channels, num_stages=4,
            base_channels=64, conv1_kernel=(1, 7, 7), inflate=(0, 0, 1, 1),
            lateral=True, lateral_infl=1, lateral_activate=(0, 0, 1, 1),
            speed_ratio=speed_ratio, channel_ratio=channel_ratio,
            fusion_kernel=7, lateral_in=[0, 0, pose_w[1], pose_w[2]])
        self.pose_path = ResNet3dPathway(
            depth=50, in_channels=pose_in_channels, num_stages=3,
            stage_blocks=(4, 6, 3), base_channels=32,
            conv1_kernel=(1, 7, 7), conv1_stride=(1, 1),
            pool1_stride=(1, 1), inflate=(0, 1, 1),
            spatial_strides=(2, 2, 2), temporal_strides=(1, 1, 1),
            lateral=True, lateral_inv=True, lateral_infl=16,
            lateral_activate=(0, 1, 1), speed_ratio=speed_ratio,
            channel_ratio=channel_ratio, fusion_kernel=7,
            lateral_in=[0, rgb_w[2], rgb_w[3]])
        self.out_channels = (self.rgb_path.out_channels,
                             self.pose_path.out_channels)

    def _drop(self, lat: torch.Tensor, p: float) -> torch.Tensor:
        """Whole-lateral drop-path (rgbposeconv3d.py:112-116)."""
        if p <= 0 or not self.training:
            return lat
        keep = torch.rand((), generator=self.generator,
                          device=lat.device) >= p
        return lat * keep.to(lat.dtype)

    def _exchange(self, x_rgb, x_pose, rgb_lat: int, pose_lat: int):
        feat_p = x_pose.detach() if self.rgb_detach else x_pose
        lat_p = self._drop(self.rgb_path.lateral_conv(rgb_lat, feat_p),
                           self.rgb_drop_path)
        feat_r = x_rgb.detach() if self.pose_detach else x_rgb
        lat_r = self._drop(self.pose_path.lateral_conv(pose_lat, feat_r),
                           self.pose_drop_path)
        return (torch.cat([x_rgb, lat_p], dim=1),
                torch.cat([x_pose, lat_r], dim=1))

    def forward(self, imgs: torch.Tensor, heatmap_imgs: torch.Tensor):
        rgb, pose = self.rgb_path, self.pose_path
        x_rgb = rgb.stage(1, rgb.stage(0, rgb.stem(_enter(imgs))))
        x_pose = pose.stage(0, pose.stem(_enter(heatmap_imgs)))
        x_rgb, x_pose = self._exchange(x_rgb, x_pose, 2, 1)
        x_rgb, x_pose = rgb.stage(2, x_rgb), pose.stage(1, x_pose)
        x_rgb, x_pose = self._exchange(x_rgb, x_pose, 3, 2)
        x_rgb, x_pose = rgb.stage(3, x_rgb), pose.stage(2, x_pose)
        return _leave(x_rgb), _leave(x_pose)


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
