"""Granger-causality graph learners (port of ``dsgcn_tpu/ops/causal.py``;
reference causal_GC.py gc_sparse :376-618, gc_component :619-842, GCGCN
gcgcn.py:10-45).

``GCSparse`` is a cMLP-style bank of causal Conv1d's, one per target
joint over every source joint's time series; the norms of those
first-layer weights, gated per sample, are the causality graph.
``GCComponent`` is a VAR-style learner: a shared generator weight,
modulated per edge by a tanh difference attention, convolved per target
joint.  Both run torch convolutions and einsums only: JAX reaches no
Pallas kernel here.  The raw weights keep JAX's names and orientation
(``branch{i}_w``/``_b``, ``follow_w``/``_b``, ``follow{j}_w``/``_b``,
``weight``), so ``utils/convert.py`` carries them over unchanged.
``num_joints`` sizes the banks, which JAX infers from its input.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, PointConv, cast


def _causal_conv1d(x_ncw: torch.Tensor, w_oiw: torch.Tensor,
                   b: torch.Tensor, dilation: int) -> torch.Tensor:
    """Left-padded (causal) Conv1d in torch's NCW layout."""
    k = w_oiw.shape[-1]
    pad = k + (k - 1) * (dilation - 1) - 1
    y = F.conv1d(F.pad(x_ncw, (pad, 0)), cast(w_oiw, x_ncw.dtype),
                 dilation=dilation)
    return y + cast(b, x_ncw.dtype)[None, :, None]


def _conv_bn_chain(mod: nn.Module, prefix: str, in_channels: int,
                   widths: Sequence[int]) -> None:
    for i, ch in enumerate(widths):
        mod.add_module(f"{prefix}{i}_conv", PointConv(in_channels, ch))
        mod.add_module(f"{prefix}{i}_bn", BatchNorm(ch))
        in_channels = ch


def _run_chain(mod: nn.Module, prefix: str, depth: int,
               x: torch.Tensor) -> torch.Tensor:
    for i in range(depth):
        x = getattr(mod, f"{prefix}{i}_conv")(x)
        x = F.relu(getattr(mod, f"{prefix}{i}_bn")(x))
    return x


class _RawBanks(nn.Module):
    """A module whose raw weights JAX draws with ``torch_default_kernel``
    / ``torch_default_bias``: U(+-1/sqrt(fan_in)) over the fan_in JAX
    computes for each (``_fan_in``)."""

    def _raw(self, name: str, shape, fan_in: int) -> None:
        self.fans = getattr(self, "fans", {})
        self.fans[name] = fan_in
        self.register_parameter(name, nn.Parameter(torch.empty(shape)))

    @torch.no_grad()
    def draw_(self, generator=None) -> None:
        """Draw every raw weight (from ``generator`` when given)."""
        for name, fan_in in self.fans.items():
            bound = fan_in ** -0.5 if fan_in > 0 else 0.0
            getattr(self, name).uniform_(-bound, bound, generator=generator)


def _fan_in(shape) -> int:
    """JAX's ``_fan_in_out`` fan_in: I of an (I, O) kernel, else
    shape[-2] times the product of the leading dims."""
    return shape[0] if len(shape) == 2 else shape[-2] * math.prod(shape[:-2])


class GCSparse(_RawBanks):
    """gc_sparse (causal_GC.py:376-618); input (N*M, T, V, C)
    channels-last.  Returns (prediction squared error (N*M*C, V, T - 1),
    the causality graph (N*M, V, V), the GSGL penalty).

    Faithful quirks (JAX ``GCSparse``): the banks' outputs are concatenated
    joint-major along time and that buffer is read back as (time, joint)
    by a raw reshape (causal_GC.py:474); the graph stacks the branches'
    weights, so every branch has the same kernel size (refused
    otherwise, as JAX asserts)."""

    def __init__(self, in_channels: int = 3, mid_channels: int = 50,
                 feature_hidden: Sequence[int] = (10, 100, 10, 1),
                 causal_hidden: Sequence[int] = (100,),
                 ms_cfg: Sequence[Tuple[int, int]] = ((3, 1), (3, 2), (3, 3),
                                                      (3, 4)),
                 gl_lam: float = 1e-2, num_joints: int = 25):
        super().__init__()
        self.ms_cfg = tuple(tuple(e) for e in ms_cfg)
        if len({k for k, _ in self.ms_cfg}) != 1:
            raise ValueError("GC_pool stacks branch weights; the reference "
                             "requires equal kernels")
        v, mid = num_joints, mid_channels
        self.mid, self.gl_lam = mid, gl_lam
        out_ch = mid * len(self.ms_cfg)
        for i, (k, _) in enumerate(self.ms_cfg):
            self._raw(f"branch{i}_w", (v, mid, v, k), _fan_in((v, mid, v, k)))
            self._raw(f"branch{i}_b", (v, mid), v * k)
        self.feature_hidden = tuple(feature_hidden)
        self.causal_hidden = tuple(causal_hidden) + (out_ch,)
        _conv_bn_chain(self, "feature", in_channels, self.feature_hidden)
        _conv_bn_chain(self, "causal", v, self.causal_hidden)
        self._raw("follow_w", (v, out_ch), v)
        self._raw("follow_b", (v,), out_ch)
        self.draw_()

    def forward(self, x: torch.Tensor):
        b0, t, v, c = x.shape
        mid, nb = self.mid, len(self.ms_cfg)
        out_ch = mid * nb
        bc = b0 * c
        # the torch-layout series: (B0*C, V, T)
        x_temp = x.permute(0, 3, 1, 2).reshape(bc, t, v).transpose(1, 2)
        preds = []
        for i, (k, d) in enumerate(self.ms_cfg):
            w = getattr(self, f"branch{i}_w")
            out = _causal_conv1d(x_temp, w.reshape(v * mid, v, k),
                                 getattr(self, f"branch{i}_b").reshape(-1),
                                 d)                      # (BC, V*mid, T)
            # joint-major cat along time (causal_GC.py:469)
            preds.append(out.reshape(bc, v, mid, t).transpose(1, 2)
                         .reshape(bc, mid, v * t))
        # the raw (joint, time) -> (time, joint) reading (:474)
        predic = torch.stack(preds, dim=1).reshape(b0, c, out_ch, t, v)

        # the feature chain -> a per-joint gate (causal_GC.py:477-484)
        gate = _run_chain(self, "feature", len(self.feature_hidden), x)
        gate = gate[..., 0].mean(dim=1)                   # (B0, V)
        sel = _run_chain(self, "causal", len(self.causal_hidden),
                         gate[:, None, :])[:, 0]          # (B0, out_ch)

        # causal selection and the channel reduction (:487-496)
        predic = F.relu((predic * sel[:, None, :, None, None]).reshape(
            bc, out_ch, t, v))
        predic_final = (torch.einsum("bcts,sc->bst", predic,
                                     cast(self.follow_w, x.dtype))
                        + cast(self.follow_b, x.dtype)[None, :, None])
        # the Granger prediction error (:499-526)
        predic_loss = (predic_final[:, :, :-1] - x_temp[:, :, 1:]) ** 2

        # the graph: the first-layer weight norms gated per sample
        # (:508-516, :556-575), and the GSGL penalty (:577-599)
        k0 = self.ms_cfg[0][0]
        gcs = torch.stack([getattr(self, f"branch{i}_w")
                           for i in range(nb)])           # (nb, V, mid, V, k)
        gc_pool = gcs.transpose(1, 2).reshape(out_ch, v, v, k0)
        gc = cast(gc_pool, x.dtype)[None] * sel[:, :, None, None, None]
        sq = gc ** 2
        gsgl = self.gl_lam * (torch.sqrt(sq.sum(dim=(1, -1))).sum()
                              + torch.sqrt(sq.sum(dim=1)).sum())
        gc = gc.amax(dim=1).amax(dim=-1)                  # (B0, V, V)
        return predic_loss, gc, gsgl


class GCGCN(nn.Module):
    """The GCGCN backbone (gcgcn.py:10-45): the persons folded into the
    batch, :class:`GCSparse` (``net``), the graph as (N, M, V, V).
    Returns (prediction error, graph, GSGL penalty)."""

    def __init__(self, in_channels: int = 3, num_person: int = 2,
                 mid_channels: int = 50,
                 feature_hidden: Sequence[int] = (10, 100, 10, 1),
                 causal_hidden: Sequence[int] = (100,),
                 ms_cfg: Sequence[Tuple[int, int]] = ((3, 1), (3, 2), (3, 3),
                                                      (3, 4)),
                 num_joints: int = 25):
        super().__init__()
        self.net = GCSparse(in_channels, mid_channels, feature_hidden,
                            causal_hidden, ms_cfg, num_joints=num_joints)

    def forward(self, x: torch.Tensor):
        n, m, t, v, c = x.shape
        loss, gc, gsgl = self.net(x.reshape(n * m, t, v, c))
        return loss, gc.reshape(n, m, v, v), gsgl


class GCComponent(_RawBanks):
    """gc_component (causal_GC.py:619-842), the GCGCN_component backbone
    (gcgcn_componen.py:10-50): a feature chain to one channel per joint,
    the tanh difference attention ``cm`` (B, cc, V, V) of two 1x1 embeds
    (``conv1``, ``conv2``), the generator ``weight`` (cc, V, time_len)
    normalized per (joint, lag) by ``weight_norm`` and modulated per target
    joint i by cm[..., i] in V grouped conv1d calls (groups = N*M), then
    per-joint MLPs (``follow{j}_w``/``_b``).

    ``weight_norm`` is the norm of the generator at init
    (causal_GC.py:654-656; JAX's 'constants' collection): a persistent
    buffer, set when the weight is drawn (``init_weights_`` draws both)
    and never recomputed in the forward.  Returns (graph (N, M, V, V),
    prediction MSE, GSGL penalty, ridge penalty)."""

    def __init__(self, in_channels: int = 3, causal_channel: int = 100,
                 feature_update: Sequence[int] = (64, 128, 1),
                 feature_hidden: Sequence[int] = (100, 10, 1),
                 time_len: int = 9, gl_lam: float = 1e-4,
                 ridge_lam: float = 1e-4, num_joints: int = 25):
        super().__init__()
        v, cc = num_joints, causal_channel
        self.time_len = time_len
        self.gl_lam, self.ridge_lam = gl_lam, ridge_lam
        self.feature_update = tuple(feature_update)
        self.feature_hidden = tuple(feature_hidden)
        _conv_bn_chain(self, "feature", in_channels, self.feature_update)
        self.conv1 = PointConv(self.feature_update[-1], cc)
        self.conv2 = PointConv(self.feature_update[-1], cc)
        self._raw("weight", (cc, v, time_len), _fan_in((cc, v, time_len)))
        self.register_buffer("weight_norm", torch.empty(v, time_len))
        hidden = cc
        for j, ch in enumerate(self.feature_hidden):
            shape = (v, ch, hidden)
            self._raw(f"follow{j}_w", shape, _fan_in(shape))
            self._raw(f"follow{j}_b", (v, ch), hidden)
            hidden = ch
        self.draw_()

    @torch.no_grad()
    def draw_(self, generator=None) -> None:
        """Draw the raw weights and take ``weight_norm`` from the new
        generator weight, as JAX's init computes it."""
        super().draw_(generator)
        self.weight_norm.copy_(torch.sqrt((self.weight ** 2).sum(dim=0)))

    def forward(self, x: torch.Tensor):
        n, m, t, v, c = x.shape
        b0, tl, dt = n * m, self.time_len, x.dtype
        cc = self.weight.shape[0]
        feat = _run_chain(self, "feature", len(self.feature_update),
                          x.reshape(b0, t, v, c))
        x1 = self.conv1(feat).mean(dim=1).transpose(1, 2)   # (B0, cc, V)
        x2 = self.conv2(feat).mean(dim=1).transpose(1, 2)
        cm = torch.tanh(x1[..., None] - x2[..., None, :])   # (B0,cc,V,V)
        weight = cast(self.weight, dt)
        wg = weight / cast(self.weight_norm, dt)[None]       # (cc, V, tl)
        # the torch-layout series (causal_GC.py:714): (1, B0*V, T)
        series = feat[..., 0].transpose(1, 2).reshape(1, b0 * v, t)
        preds = []
        for i in range(v):
            wr = (cm[:, :, :, i, None] * wg[None]).reshape(b0 * cc, v, tl)
            preds.append(F.conv1d(series, wr, groups=b0)[0])  # (B0*cc, T')
        tp = t - tl + 1
        predics = torch.stack(preds).reshape(v, b0, cc, tp).transpose(0, 1)
        ridge = 0.0
        for j in range(len(self.feature_hidden)):
            fw = getattr(self, f"follow{j}_w")
            fb = cast(getattr(self, f"follow{j}_b"), dt)
            predics = F.relu(torch.einsum("bvct,voc->bvot", predics,
                                          cast(fw, dt))
                             + fb[None, :, :, None])
            ridge = ridge + (fw ** 2).sum()
        prediction = predics.reshape(b0, v * self.feature_hidden[-1], tp)
        x_comp = series.reshape(b0, v, t)
        predic_loss = torch.mean((x_comp[:, :, tl:]
                                  - prediction[:, :, :-1]) ** 2)
        # GSGL on the attention field (causal_GC.py:736, 770-785)
        gl1 = torch.sqrt((cm ** 2).sum(dim=1))               # (B0, V, V)
        gsgl = self.gl_lam * (torch.sqrt((gl1 ** 2).sum(dim=1)).sum()
                              + gl1.sum())
        gc = cm[..., None] * weight[None, :, :, None, :]     # (B0,cc,V,V,tl)
        gc = torch.sqrt((gc ** 2).sum(dim=1))
        gc = torch.sqrt((gc ** 2).sum(dim=-1))               # (B0, V, V)
        return (gc.reshape(n, m, v, v), predic_loss, gsgl,
                self.ridge_lam * ridge)
