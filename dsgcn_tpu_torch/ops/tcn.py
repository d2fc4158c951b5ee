"""Temporal convolution ops (channels-last ``(N, T, V, C)``).

The port of ``UnitTCN``, ``UnitMLP``, ``_MSBranches``, ``MSTCN``
(STGCN++; msmlp with ``branch_kind='mlp'``), ``GCMLP``, ``DGMSTCN``
(DG-STGCN, DS-GCN; dgmsmlp with ``branch_kind='mlp'``), ``CTRMSTCN``
(CTR-GCN, MS-G3D) and ``UnitTCNEdge`` (STGIN) from
``dsgcn_tpu/ops/tcn.py``, train and eval.  DGMSTCN trains
in the reference ``concat`` layout, as JAX does: the mean joint is
appended as an extra joint row, the branch stack runs once (so in
training the branch BatchNorms see the 26th joint), and the global row is
scaled back onto every joint (tcn.py:428-460).  Eval runs the same
layout whatever ``eval_layout`` says (``DGMSTCN``).  With
``use_pallas=True`` both take the fused eval kernel K7
(``ops/kernels/ms_tcn.py``) in eval where JAX does (``DEFAULT_MS_CFG``,
default widths, ``branch_kind='tcn'``); training, and the temporal MLPs
(which JAX computes outside any Pallas kernel), keep the module path.
Submodule names follow the JAX modules' flax scopes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.joint_partition import all_reduce_sum
from ..parallel.mesh import axis
from .common import (BatchNorm, PointConv, TemporalConv, cast, dropout,
                     joint_pad_check, max_pool_t)
from .kernels.ms_tcn import fused_dgmstcn_eval

MsCfgEntry = Union[str, Tuple[Union[str, int], int]]
DEFAULT_MS_CFG: Tuple[MsCfgEntry, ...] = ((3, 1), (3, 2), (3, 3), (3, 4),
                                          ("max", 3), "1x1")


class UnitTCN(nn.Module):
    """k x 1 temporal conv + BN + dropout (reference unit_tcn,
    tcn.py:10-37).  ``dropout`` acts in training only, its mask drawn from
    ``self.generator``.  ``bn_axis``: the mesh axis the BN's statistics are
    synced over (joint-partitioned blocks)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, dilation: int = 1,
                 norm: Optional[str] = "BN", dropout: float = 0.0,
                 bn_axis: Optional[str] = None):
        super().__init__()
        self.conv = TemporalConv(in_channels, out_channels, kernel_size,
                                 stride, dilation)
        self.bn = (BatchNorm(out_channels, axis_name=bn_axis)
                   if norm is not None else None)
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return dropout(y, self.dropout, self.training, self.generator)


class UnitMLP(nn.Module):
    """The author's temporal-MLP unit (reference unitmlp, tcn.py:525-610;
    JAX ``dsgcn_tpu/ops/tcn.py:UnitMLP``): a depthwise causal temporal conv
    of (k + 1) // 2 taps, left-padded mlp_size + (mlp_size - 1)(d - 1) - 1
    frames, with its stride, dilation and bias (``conv``, a grouped
    ``Conv2d`` holding the (C, 1, taps, 1) weight), then the 1x1 ``conv1``,
    the optional BN and dropout (training only, its mask from
    ``self.generator``).

    ``channel_annention`` averages T' in ``group`` contiguous blocks
    (8 if C <= 16, else C // ``reduce``), which must divide T' (JAX
    asserts it).  ``add_tcn`` adds a k x 1 ``TemporalConv`` of x
    (``conv2``) through the gate ``alpha`` (learned, from zero, when
    ``adaptive``, else 1), after ``conv1`` with ``merge_after``, else before
    it."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 1, dilation: int = 1,
                 norm: Optional[str] = "BN", dropout: float = 0.0,
                 adaptive: bool = True, channel_annention: bool = False,
                 reduce: int = 4, add_tcn: bool = False,
                 merge_after: bool = False):
        super().__init__()
        if in_channels != out_channels:
            raise ValueError("depthwise mlp expects in == out channels "
                             f"({in_channels} != {out_channels})")
        c, d = out_channels, dilation
        taps = (kernel_size + 1) // 2
        self.pad = taps + (taps - 1) * (d - 1) - 1          # causal left pad
        self.conv = nn.Conv2d(c, c, (taps, 1), stride=(stride, 1),
                              dilation=(d, 1), groups=c)
        self.channel_annention, self.reduce = channel_annention, reduce
        self.add_tcn, self.merge_after = add_tcn, merge_after
        self.adaptive = adaptive
        if add_tcn:
            self.conv2 = TemporalConv(c, c, kernel_size, stride, d)
            if adaptive:
                self.alpha = nn.Parameter(torch.zeros(1))
        self.conv1 = PointConv(c, c)
        self.bn = BatchNorm(c) if norm is not None else None
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, v, c = x.shape
        w = cast(self.conv.weight, x.dtype)
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (0, 0, self.pad, 0)), w,
                     cast(self.conv.bias, x.dtype), self.conv.stride, 0,
                     self.conv.dilation, groups=c).permute(0, 2, 3, 1)
        if self.channel_annention:
            group = 8 if c <= 16 else c // self.reduce
            t2 = y.shape[1]
            if t2 % group:
                raise ValueError(f"channel_annention needs group {group} | "
                                 f"T' {t2}")
            y = y.reshape(n, group, t2 // group, v, c).mean(dim=1)
        if self.add_tcn:
            x_tcn = self.conv2(x)
            if self.adaptive:
                x_tcn = x_tcn * cast(self.alpha, x.dtype)
            y = (self.conv1(y) + x_tcn if self.merge_after
                 else self.conv1(y + x_tcn))
        else:
            y = self.conv1(y)
        if self.bn is not None:
            y = self.bn(y)
        return dropout(y, self.dropout, self.training, self.generator)


class _MSBranches(nn.Module):
    """Multi-branch structure of mstcn/dgmstcn/msmlp (reference
    tcn.py:134-153, 215-234).

    Branch i: 1x1 -> BN -> ReLU -> {k x 1 dilated conv | causal mlp |
    maxpool}, or a plain strided 1x1.  Branch 0 gets the remainder
    channels.  ``branch_kind='mlp'`` makes the conv branches ``UnitMLP``s
    without BN (``branch{i}_mlp``), with ``channel_annention``, ``add_tcn``
    and ``merge_after`` passed through.  ``bn_axis``: the mesh axis the
    branch BNs sync their statistics over; the forward's ``bn_weight``
    weighs their locations (JAX tcn.py:194).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[float] = None,
                 ms_cfg: Sequence[MsCfgEntry] = DEFAULT_MS_CFG,
                 stride: int = 1, bn_axis: Optional[str] = None,
                 branch_kind: str = "tcn", channel_annention: bool = False,
                 add_tcn: bool = False, merge_after: bool = False):
        super().__init__()
        if branch_kind not in ("tcn", "mlp"):
            raise ValueError(f"unknown branch_kind {branch_kind!r} ('tcn' "
                             "or 'mlp')")
        self.ms_cfg = tuple(ms_cfg)
        self.stride = stride
        self.mid_channels = mid_channels
        self.branch_kind = branch_kind
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
            self.add_module(f"branch{i}_bn", BatchNorm(bc, axis_name=bn_axis))
            if kind == "max":
                continue
            if branch_kind == "mlp":
                self.add_module(f"branch{i}_mlp", UnitMLP(
                    bc, bc, kernel_size=kind, stride=stride, dilation=val,
                    norm=None, channel_annention=channel_annention,
                    add_tcn=add_tcn, merge_after=merge_after))
            else:
                self.add_module(f"branch{i}_tcn", UnitTCN(
                    bc, bc, kernel_size=kind, stride=stride, dilation=val,
                    norm=None))

    def forward(self, x: torch.Tensor,
                bn_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        outs = []
        for i, cfg in enumerate(self.ms_cfg):
            if cfg == "1x1":
                outs.append(getattr(self, f"branch{i}_conv")(x))
                continue
            kind, val = cfg
            b = getattr(self, f"branch{i}_pre")(x)
            b = F.relu(getattr(self, f"branch{i}_bn")(b, bn_weight))
            if kind == "max":
                b = max_pool_t(b, window=val, stride=self.stride, padding=1)
            else:
                b = getattr(self, f"branch{i}_{self.branch_kind}")(b)
            outs.append(b)
        return torch.cat(outs, dim=-1)


def _k7_applies(mod) -> bool:
    """JAX's condition for the fused eval kernel (tcn.py:231-233, :337-340):
    eval, the default conv branches at the default widths."""
    return (mod.use_pallas and not mod.training
            and getattr(mod, "graph_axis", None) is None
            and mod.branches.branch_kind == "tcn"
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
    training only, its mask drawn from ``self.generator``.  With
    ``branch_kind='mlp'`` it is the author's msmlp (tcn.py:182-262), which
    runs the module path with or without ``use_pallas``: K7 computes the
    conv branches only, as JAX's dispatch says."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[float] = None, dropout: float = 0.0,
                 ms_cfg: Sequence[MsCfgEntry] = DEFAULT_MS_CFG,
                 stride: int = 1, branch_kind: str = "tcn",
                 use_pallas: bool = False):
        super().__init__()
        self.branches = _MSBranches(in_channels, out_channels, mid_channels,
                                    ms_cfg, stride, branch_kind=branch_kind)
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


class GCMLP(nn.Module):
    """msmlp without the 1x1 transform after the concat (reference gcmlp,
    tcn.py:263-340; JAX ``tcn.py:GCMLP``): the mlp branches, concat, BN,
    dropout (training only, its mask from ``self.generator``).  The width
    is the branches' sum.  ``channel_annention`` defaults to False, as in
    JAX: the reference's default (1) shrinks T on the mlp branches only,
    and the concat then fails."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[float] = None, dropout: float = 0.0,
                 ms_cfg: Sequence[MsCfgEntry] = DEFAULT_MS_CFG,
                 stride: int = 1, channel_annention: bool = False,
                 add_tcn: bool = False, merge_after: bool = False):
        super().__init__()
        self.branches = _MSBranches(
            in_channels, out_channels, mid_channels, ms_cfg, stride,
            branch_kind="mlp", channel_annention=channel_annention,
            add_tcn=add_tcn, merge_after=merge_after)
        self.bn = BatchNorm(sum(self.branches.widths))
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(self.bn(self.branches(x)), self.dropout,
                       self.training, self.generator)


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
    (``ops/common.py:joint_pad_check``).  ``branch_kind='mlp'`` is the
    author's dgmsmlp (tcn.py:432-524): the same region with ``UnitMLP``
    branches, the module path always (K7 computes the conv branches only,
    as JAX's dispatch says); it keeps the appended joint in training too.

    ``graph_axis`` (joint-partitioned, JAX tcn.py:440-459): x holds this
    process's v of the G v joints; the appended joint is the mean over all
    of them (a sum all-reduced over the axis, over G v), the same row on
    every process, so the branch BNs weigh it 1/G; each process scales it
    back with its own v entries of ``add_coeff``; every BN syncs over the
    axis.  K7 and ``v_pad`` are refused with it, as in JAX.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[float] = None, num_joints: int = 25,
                 dropout: float = 0.0,
                 ms_cfg: Sequence[MsCfgEntry] = DEFAULT_MS_CFG,
                 stride: int = 1, use_pallas: bool = False,
                 eval_layout: str = "auto", graph_axis=None, v_pad: int = 0,
                 branch_kind: str = "tcn"):
        super().__init__()
        if eval_layout not in ("auto", "split", "concat"):
            raise ValueError(
                f"eval_layout must be 'auto', 'split' or 'concat'; "
                f"got {eval_layout!r}")
        if graph_axis is not None and v_pad:
            raise ValueError("DGMSTCN: graph_axis and joint-padded mode "
                             "(v_pad) exclude each other")
        self.eval_layout, self.v_pad = eval_layout, v_pad
        self.graph_axis = graph_axis
        self.branches = _MSBranches(in_channels, out_channels, mid_channels,
                                    ms_cfg, stride, bn_axis=graph_axis,
                                    branch_kind=branch_kind)
        width = sum(self.branches.widths)
        self.add_coeff = nn.Parameter(torch.zeros(num_joints))
        self.transform_bn = BatchNorm(width, axis_name=graph_axis)
        self.transform_conv = PointConv(width, out_channels)
        self.bn = BatchNorm(out_channels, axis_name=graph_axis)
        self.dropout = dropout
        self.use_pallas = use_pallas
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.shape[2]
        joint_pad_check(self)
        if _k7_applies(self):
            return fused_ms_eval(self, x, self.add_coeff[:v])
        bn_weight = None
        if self.graph_axis is None:
            mean_joint = x.mean(dim=2, keepdim=True)
            coeff = self.add_coeff[:v]
        else:
            ax = axis(self.graph_axis)
            mean_joint = all_reduce_sum(x.sum(dim=2, keepdim=True),
                                        ax.group) / (ax.size * v)
            coeff = self.add_coeff[ax.index * v:(ax.index + 1) * v]
            bn_weight = x.new_ones(v + 1, 1)
            bn_weight[v] = 1.0 / ax.size
        # append the global mean joint as row v (tcn.py:409)
        xg = torch.cat([x, mean_joint], dim=2)
        out = self.branches(xg, bn_weight)
        coeff = cast(coeff, x.dtype)
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

    def branch_outputs(self, x: torch.Tensor) -> torch.Tensor:
        """The branches' outputs concatenated over channels."""
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
        return torch.cat(outs, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.branch_outputs(x)
        if self.use_residual:
            out = out + (x if self.identity else self.residual(x))
        return dropout(F.relu(out), self.tcn_dropout, self.training,
                       self.generator)


class UnitTCNEdge(nn.Module):
    """unit_tcnedge (reference tcn.py:39-103; JAX ``UnitTCNEdge``): STGIN's
    temporal conv.  The nodes take the temporal edges (``conv`` over x +
    edge_t); the temporal edges are re-emitted from (x, edge_t, x with
    frame 0 zeroed) (``edge_conv``); the spatial edges are time-strided to
    match (``edge_conv_S``, built where ``stride`` > 1).  One ``bn`` serves
    every stream, and the node output passes it twice (tcn.py:85/97), in
    JAX's order: node, the strided spatial edges, node again, the temporal
    edges; in training each call moves the running statistics on from the
    last.  Dropout (training only, masks from ``self.generator``) after
    each BN."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 9, stride: int = 1, dilation: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        args = (kernel_size, stride, dilation)
        self.conv = TemporalConv(in_channels, out_channels, *args)
        self.edge_conv = TemporalConv(2 * in_channels + out_channels,
                                      out_channels, *args)
        if stride > 1:
            self.edge_conv_S = TemporalConv(out_channels, out_channels, *args)
        self.bn = BatchNorm(out_channels)
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None

    def _bn(self, y: torch.Tensor) -> torch.Tensor:
        return dropout(self.bn(y), self.dropout, self.training,
                       self.generator)

    def forward(self, x: torch.Tensor, edge_t: torch.Tensor,
                edge_s: torch.Tensor):
        v = x.shape[2]
        node = self._bn(self.conv(x + edge_t))
        node_remove = torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:]], 1)
        edge_out = self.edge_conv(torch.cat([x, edge_t, node_remove], -1))
        if edge_s.shape[1] != node.shape[1]:
            ns, ts = edge_s.shape[:2]
            flat = self._bn(self.edge_conv_S(edge_s.reshape(ns, ts, v * v,
                                                            -1)))
            edge_s = flat.reshape(ns, flat.shape[1], v, v, -1)
        return self._bn(node), self._bn(edge_out), edge_s
