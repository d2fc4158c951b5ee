"""Temporal convolution ops (channels-last ``(N, T, V, C)``).

The port of ``UnitTCN``, ``_MSBranches``, ``MSTCN`` (STGCN++),
``DGMSTCN`` (DG-STGCN, DS-GCN) and ``CTRMSTCN`` (CTR-GCN) from
``dsgcn_tpu/ops/tcn.py``, train and eval.  DGMSTCN trains in the
reference ``concat`` layout, as JAX does: the mean joint is appended as an
extra joint row, the branch stack runs once (so in training the branch
BatchNorms see the 26th joint), and the global row is scaled back onto
every joint (tcn.py:428-460).  Eval runs the same layout whatever
``eval_layout`` says (``DGMSTCN``).  With
``use_pallas=True`` both take the fused eval kernel K7
(``ops/kernels/ms_tcn.py``) in eval where JAX does (``DEFAULT_MS_CFG``,
default widths); training keeps the module path.  Submodule names follow
the JAX modules' flax scopes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .common import (BatchNorm, PointConv, TemporalConv, cast, dropout,
                     joint_pad_check, max_pool_t)
from .kernels.ms_tcn import fused_dgmstcn_eval

MsCfgEntry = Union[str, Tuple[Union[str, int], int]]
DEFAULT_MS_CFG: Tuple[MsCfgEntry, ...] = ((3, 1), (3, 2), (3, 3), (3, 4),
                                          ("max", 3), "1x1")


class UnitTCN(nn.Module):
    """k x 1 temporal conv + BN + dropout (reference unit_tcn,
    tcn.py:10-37).  ``dropout`` acts in training only, its mask drawn from
    ``self.generator``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, dilation: int = 1,
                 norm: Optional[str] = "BN", dropout: float = 0.0):
        super().__init__()
        self.conv = TemporalConv(in_channels, out_channels, kernel_size,
                                 stride, dilation)
        self.bn = BatchNorm(out_channels) if norm is not None else None
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return dropout(y, self.dropout, self.training, self.generator)


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
        self.mid_channels = mid_channels
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


def _k7_applies(mod) -> bool:
    """JAX's condition for the fused eval kernel (tcn.py:231-233, :337-340):
    eval, the default branches at the default widths."""
    return (mod.use_pallas and not mod.training
            and mod.branches.mid_channels is None
            and mod.branches.ms_cfg == DEFAULT_MS_CFG)


def fused_ms_eval(mod: nn.Module, x: torch.Tensor,
                  coeff: Optional[torch.Tensor]) -> torch.Tensor:
    """The eval region of an ``MSTCN`` (``coeff=None``) or ``DGMSTCN`` in
    K7 (JAX ``tcn.py:_fused_ms_eval``): every BatchNorm folded into an
    affine, each branch BN into its pre 1x1's columns, the weights gathered
    per branch in the JAX (in, out) orientation.  The folding runs in
    float32 whatever the parameters' type, as JAX promotes bf16 parameters
    against float32 statistics."""
    br, f32 = mod.branches, torch.float32
    w_pre, b_pre, taps_w, taps_b, dilations = [], [], [], [], []
    for i, cfg in enumerate(br.ms_cfg):
        if cfg == "1x1":
            conv = getattr(br, f"branch{i}_conv").conv
            w11 = cast(conv.weight, f32)[:, :, 0, 0].t()     # (C, mid)
            b11 = cast(conv.bias, f32)
            continue
        a, b = getattr(br, f"branch{i}_bn").affine(f32)
        pre = getattr(br, f"branch{i}_pre")
        w_pre.append(cast(pre.weight, f32).t() * a[None])
        b_pre.append(cast(pre.bias, f32) * a + b)
        kind, val = cfg
        if kind != "max":
            conv = getattr(br, f"branch{i}_tcn").conv.conv   # (O, I, 3, 1)
            taps_w.append(cast(conv.weight, f32)[..., 0].permute(2, 1, 0))
            taps_b.append(cast(conv.bias, f32))
            dilations.append(val)
    a_tr, b_tr = mod.transform_bn.affine(f32)
    a_out, b_out = mod.bn.affine(f32)
    tc = mod.transform_conv
    # the kernel reads x row-major; UnitGCN's einsum may leave it permuted
    return fused_dgmstcn_eval(
        x.contiguous(), torch.cat(w_pre, 1), torch.cat(b_pre), taps_w, taps_b, w11, b11,
        a_tr, b_tr, cast(tc.weight, f32).t(), cast(tc.bias, f32), a_out,
        b_out, coeff, dilations=dilations, stride=br.stride)


class MSTCN(nn.Module):
    """STGCN++ multi-scale TCN (reference mstcn, tcn.py:104-180): the
    branches, then BN -> ReLU -> 1x1 transform -> BN.  ``dropout`` acts in
    training only, its mask drawn from ``self.generator``.  The JAX
    module's ``branch_kind='mlp'`` (msmlp) is not ported and raises."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[float] = None, dropout: float = 0.0,
                 ms_cfg: Sequence[MsCfgEntry] = DEFAULT_MS_CFG,
                 stride: int = 1, branch_kind: str = "tcn",
                 use_pallas: bool = False):
        super().__init__()
        if branch_kind != "tcn":
            raise NotImplementedError(
                f"MSTCN branch_kind={branch_kind!r} is not ported yet (the "
                "port has 'tcn')")
        self.branches = _MSBranches(in_channels, out_channels, mid_channels,
                                    ms_cfg, stride)
        width = sum(self.branches.widths)
        self.transform_bn = BatchNorm(width)
        self.transform_conv = PointConv(width, out_channels)
        self.bn = BatchNorm(out_channels)
        self.dropout = dropout
        self.use_pallas = use_pallas
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _k7_applies(self):
            return fused_ms_eval(self, x, None)
        feat = self.transform_conv(F.relu(self.transform_bn(
            self.branches(x))))
        return dropout(self.bn(feat), self.dropout, self.training,
                       self.generator)


class DGMSTCN(nn.Module):
    """DG-STGCN multi-scale TCN with a global joint-mean branch (reference
    dgmstcn, tcn.py:344-431) in the ``concat`` layout, or K7 in eval with
    ``use_pallas=True`` where it applies.  ``eval_layout`` takes JAX's
    'auto' | 'split' | 'concat' (and its ValueError for anything else), and
    all three run concat: JAX's ``split`` (tcn.py:341-403) is an exact
    rewrite of the same function, and on the H100 the port's copy of it
    never beat concat, at b16 or b64 x M2 x T100 (PERF.md §5), so it was
    taken out.  ``dropout`` acts in training only, its mask drawn from
    ``self.generator`` (a ``torch.Generator`` on the activations' device,
    or None for torch's default).  ``v_pad`` (joint-padded mode) keeps
    JAX's refusal of training and runs at the real joints
    (``ops/common.py:joint_pad_check``).  The JAX module's joint-partition
    mode (``graph_axis``) and ``branch_kind='mlp'`` are not ported: each
    raises, naming the option, when set.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[float] = None, num_joints: int = 25,
                 dropout: float = 0.0,
                 ms_cfg: Sequence[MsCfgEntry] = DEFAULT_MS_CFG,
                 stride: int = 1, use_pallas: bool = False,
                 eval_layout: str = "auto", graph_axis=None, v_pad: int = 0,
                 branch_kind: str = "tcn"):
        super().__init__()
        for name, value, default in (("graph_axis", graph_axis, None),
                                     ("branch_kind", branch_kind, "tcn")):
            if value != default:
                raise NotImplementedError(
                    f"DGMSTCN {name}={value!r} is not ported yet")
        if eval_layout not in ("auto", "split", "concat"):
            raise ValueError(
                f"eval_layout must be 'auto', 'split' or 'concat'; "
                f"got {eval_layout!r}")
        self.eval_layout, self.v_pad = eval_layout, v_pad
        self.branches = _MSBranches(in_channels, out_channels, mid_channels,
                                    ms_cfg, stride)
        width = sum(self.branches.widths)
        self.add_coeff = nn.Parameter(torch.zeros(num_joints))
        self.transform_bn = BatchNorm(width)
        self.transform_conv = PointConv(width, out_channels)
        self.bn = BatchNorm(out_channels)
        self.dropout = dropout
        self.use_pallas = use_pallas
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.shape[2]
        joint_pad_check(self)
        if _k7_applies(self):
            return fused_ms_eval(self, x, self.add_coeff[:v])
        # append the global mean joint as row v (tcn.py:409)
        xg = torch.cat([x, x.mean(dim=2, keepdim=True)], dim=2)
        out = self.branches(xg)
        coeff = cast(self.add_coeff[:v], x.dtype)
        feat = out[:, :, :v] + out[:, :, v:] * coeff[None, None, :, None]
        feat = self.transform_conv(F.relu(self.transform_bn(feat)))
        return dropout(self.bn(feat), self.dropout, self.training,
                       self.generator)


class CTRMSTCN(nn.Module):
    """CTR-GCN's multi-scale TCN (reference MSTCN, msg3d_utils.py:64-142;
    JAX ``dsgcn_tpu/ops/tcn.py:CTRMSTCN``).  Unlike :class:`MSTCN`: branch
    i < len(dilations) is 1x1 -> BN -> ReLU -> a k x 1 dilated
    ``UnitTCN`` with its own BN; then a max-pool branch with a second BN
    (``bn2``) and a strided 1x1 + BN branch that takes the remainder
    channels (the last branch, not the first); the residual (a strided
    1x1 ``UnitTCN``, or x) is added before the ReLU; ``tcn_dropout`` acts
    in training only, its mask drawn from ``self.generator``.  It runs no
    kernel: the fused eval kernel K7 computes MSTCN's region, not this
    one, and JAX takes no kernel here either."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Sequence[int]] = 3, stride: int = 1,
                 dilations: Sequence[int] = (1, 2, 3, 4),
                 residual: bool = True, tcn_dropout: float = 0.0):
        super().__init__()
        self.dilations = tuple(dilations)
        nb = len(self.dilations) + 2
        bc = out_channels // nb
        rem = out_channels - bc * (nb - 1)
        ks = (list(kernel_size) if isinstance(kernel_size, (list, tuple))
              else [kernel_size] * len(self.dilations))
        self.stride, self.tcn_dropout = stride, tcn_dropout
        self.use_residual = residual
        self.identity = in_channels == out_channels and stride == 1
        if residual and not self.identity:
            self.residual = UnitTCN(in_channels, out_channels, kernel_size=1,
                                    stride=stride)
        for i, (k, d) in enumerate(zip(ks, self.dilations)):
            self.add_module(f"branch{i}_pre", PointConv(in_channels, bc))
            self.add_module(f"branch{i}_bn", BatchNorm(bc))
            self.add_module(f"branch{i}_tcn", UnitTCN(
                bc, bc, kernel_size=k, stride=stride, dilation=d))
        i = len(self.dilations)
        self.add_module(f"branch{i}_pre", PointConv(in_channels, bc))
        self.add_module(f"branch{i}_bn", BatchNorm(bc))
        self.add_module(f"branch{i}_bn2", BatchNorm(bc))
        self.add_module(f"branch{i + 1}_conv", TemporalConv(
            in_channels, rem, kernel_size=1, stride=stride))
        self.add_module(f"branch{i + 1}_bn", BatchNorm(rem))
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def pre(i):
            b = getattr(self, f"branch{i}_pre")(x)
            return F.relu(getattr(self, f"branch{i}_bn")(b))
        outs = [getattr(self, f"branch{i}_tcn")(pre(i))
                for i in range(len(self.dilations))]
        i = len(self.dilations)
        b = max_pool_t(pre(i), window=3, stride=self.stride, padding=1)
        outs.append(getattr(self, f"branch{i}_bn2")(b))
        b = getattr(self, f"branch{i + 1}_conv")(x)
        outs.append(getattr(self, f"branch{i + 1}_bn")(b))
        out = torch.cat(outs, dim=-1)
        if self.use_residual:
            out = out + (x if self.identity else self.residual(x))
        return dropout(F.relu(out), self.tcn_dropout, self.training,
                       self.generator)
