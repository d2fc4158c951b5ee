"""Shared building blocks for the GCN/TCN ops (channels-last ``(N, T, V, C)``).

The port's counterparts of ``dsgcn_tpu/ops/common.py``.  A 1x1 "conv" is a
linear map over the trailing channel axis; a k x 1 temporal conv runs as a
``Conv2d`` over a channels-last view, so no layout copy is made on the card.
Weights are stored in PyTorch's orientation; ``utils/convert.py`` re-orients
JAX checkpoints.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.joint_partition import all_reduce_sum
from ..parallel.mesh import axis

BN_EPS = 1e-5


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: ``t`` itself where it already is.  Eager PyTorch
    skips a cast to a tensor's own dtype anyway, but ``torch.export``
    records each such ``.to`` (with a metadata assert), and the exported
    program then runs them all: the modules' forwards cast through here."""
    return t if t.dtype == dtype else t.to(dtype)


class PointConv(nn.Linear):
    """1x1 conv == linear map over the trailing channel axis (reference
    ``nn.Conv2d(in, out, 1)``).  Computes in the activation dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else cast(self.bias, x.dtype)
        return F.linear(x, cast(self.weight, x.dtype), bias)


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
        w = cast(self.conv.weight, x.dtype)
        b = None if self.conv.bias is None else cast(self.conv.bias, x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.conv.stride,
                     self.conv.padding, self.conv.dilation)
        return y.permute(0, 2, 3, 1)


def _fans(w: torch.Tensor):
    """(fan_in, fan_out) of a torch (O, I, *kernel) weight."""
    receptive = w[0, 0].numel()
    return w.shape[1] * receptive, w.shape[0] * receptive


def kaiming_normal_fan_out_(w: torch.Tensor, generator: torch.Generator):
    """N(0, 2 / fan_out) (JAX ``ops/common.py:kaiming_normal_fan_out``,
    reference conv_init)."""
    return w.normal_(0.0, (2.0 / _fans(w)[1]) ** 0.5, generator=generator)


def branch_normal_(w: torch.Tensor, branches: int,
                   generator: torch.Generator):
    """N(0, 2 / (O I k branches)) (JAX ``ops/common.py:branch_init``,
    reference conv_branch_init)."""
    k = w.shape[2] if w.dim() > 2 else 1
    std = (2.0 / (w.shape[0] * w.shape[1] * k * branches)) ** 0.5
    return w.normal_(0.0, std, generator=generator)


def trunc_normal_scaled_(w: torch.Tensor, variance: float,
                         generator: torch.Generator):
    """flax's ``variance_scaling(..., 'truncated_normal')``: a standard
    normal truncated to [-2, 2], scaled to ``variance``
    (``xavier_normal``: 2 / (fan_in + fan_out); ``kaiming_normal``: 2 /
    fan_in)."""
    std = variance ** 0.5 / .87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Statistics and accumulation type: at least float32 (bf16 inputs
    accumulate in float32), float64 inputs keep float64 (JAX
    ``ops/common.py:accum_dtype``)."""
    return torch.promote_types(dtype, torch.float32)


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = BN_EPS):
    """Eval BatchNorm as the per-channel affine ``y = x * a + b``:
    ``a = scale * rsqrt(var + eps)``, ``b = bias - mean * a``
    (``dsgcn_tpu/ops/pallas/ms_tcn.py:fold_bn``)."""
    a = scale * torch.rsqrt(var + eps)
    return a, bias - mean * a


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over the trailing axis (torch BatchNorm2d on
    NCTV), as ``dsgcn_tpu/ops/common.py:BatchNorm``.

    Train: batch statistics over every axis but the last in
    :func:`accum_dtype`, the variance as ``E[x^2] - E[x]^2`` and biased in
    the normalization, as JAX computes it; the running statistics move with
    momentum 0.1, the variance with Bessel's correction n/(n-1) (torch).
    Under :func:`remat_call` the recompute in the backward leaves the
    running statistics alone, so a step moves them once.
    Eval applies the folded affine ``x * a + b`` with
    ``a = rsqrt(var + 1e-5) * weight`` and ``b = bias - mean * a``, computed
    in :func:`accum_dtype` and applied in the activation dtype.

    ``axis_name``: the mesh axis (``parallel/mesh.py``) whose processes
    share the batch statistics (the joint-partitioned units: each process
    holds a block of the joints, and the statistics must be the unsharded
    model's); the sums ``s1 = sum(w x)``, ``s2 = sum(w x^2)`` and
    ``cnt = sum(w)`` are all-reduced over it, differentiably, and Bessel's
    factor takes the summed count.  ``weight`` in the forward: a
    per-location weight broadcastable to x's non-channel dims with a
    trailing 1 (DGMSTCN's appended mean joint, present on every process,
    weighs 1/G so that it counts once).
    """

    def __init__(self, num_features: int, axis_name: Optional[str] = None):
        super().__init__()
        self.num_features = num_features
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def affine(self, dtype: torch.dtype = torch.float32):
        """The (a, b) of the eval affine, in ``dtype``."""
        return fold_bn(cast(self.weight, dtype), cast(self.bias, dtype),
                       cast(self.running_mean, dtype),
                       cast(self.running_var, dtype))

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        acc = accum_dtype(x.dtype)
        if not self.training:
            a, b = self.affine(acc)
            return x * cast(a, x.dtype) + cast(b, x.dtype)
        xm = x.to(acc)
        axes = tuple(range(x.dim() - 1))
        if weight is None and self.axis_name is None:
            mean = xm.mean(dim=axes)
            var = (xm * xm).mean(dim=axes) - mean * mean
            n = xm.numel() // self.num_features
            bessel = n / max(n - 1, 1)
        else:
            if weight is None:
                sums = [xm.sum(dim=axes), (xm * xm).sum(dim=axes),
                        xm.new_full((1,), xm.numel() // self.num_features)]
            else:
                w = cast(weight, acc).expand(x.shape[:-1] + (1,))
                sums = [(xm * w).sum(dim=axes), (xm * xm * w).sum(dim=axes),
                        w.sum()[None]]
            # one all-reduce for s1, s2 and the count
            sums = torch.cat(sums)
            if self.axis_name is not None:
                ax = axis(self.axis_name)
                sums = all_reduce_sum(sums, ax.group)
            c = self.num_features
            cnt = sums[2 * c]
            mean = sums[:c] / cnt
            var = sums[c:2 * c] / cnt - mean * mean
            bessel = cnt / torch.clamp(cnt - 1, min=1)
        if not recomputing():
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(
                    0.1 * mean.to(self.running_mean.dtype))
                self.running_var.mul_(0.9).add_(
                    0.1 * (var * bessel).to(self.running_var.dtype))
        mul = torch.rsqrt(var + BN_EPS) * self.weight.to(acc)
        return ((xm - mean) * mul + self.bias.to(acc)).to(x.dtype)

    def extra_repr(self) -> str:
        return (f"{self.num_features}" if self.axis_name is None
                else f"{self.num_features}, axis_name={self.axis_name!r}")


class TorchBN(BatchNorm):
    """JAX ``ops/common.py:TorchBN``, flax's ``BatchNorm`` layout with
    torch's statistics: ``scale``, ``bias``, ``mean`` and ``var`` sit at
    the module's own scope (no inner ``bn``), the normalization uses the
    biased batch variance and the running variance moves with the unbiased
    one (momentum 0.1).  The arithmetic is :class:`BatchNorm`'s; only the
    JAX names differ (``core/train.py:jax_param_names``).  SGN's
    ``BatchNorm1d(C*V)`` over the (c, v) features of a frame."""


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (keep with probability 1 - p, scale by 1/(1 - p)),
    drawing its mask from ``generator`` (flax ``nn.Dropout`` semantics; the
    bits differ from JAX's).  The identity in eval or at p = 0."""
    if not training or p <= 0:
        return x
    if p >= 1:
        return torch.zeros_like(x)
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1 - p, generator=generator)
    return x * (keep / (1 - p)).to(x.dtype)


class _RematState(threading.local):
    recomputing = False


# per thread: the backward's recompute runs on the autograd engine's thread
_REMAT = _RematState()


def recomputing() -> bool:
    """True inside the backward's recompute of a :func:`remat_call`."""
    return _REMAT.recomputing


def _generators(fn) -> list:
    """The distinct ``torch.Generator``s that ``fn``'s modules draw
    dropout masks from."""
    mods = fn.modules() if isinstance(fn, nn.Module) else ()
    gens = {id(g): g for g in (getattr(m, "generator", None) for m in mods)
            if isinstance(g, torch.Generator)}
    return list(gens.values())


class _RematForward:
    """The forward of one :func:`remat_call`: notes the state of each
    generator its dropouts draw from."""

    def __init__(self, gens: list):
        self.gens, self.states = gens, []

    def __enter__(self):
        self.states = [g.get_state() for g in self.gens]

    def __exit__(self, *exc):
        pass


class _RematRecompute:
    """The backward's recompute of one :func:`remat_call` (each time it
    runs): sets the forward's generator states, so dropout draws the same
    masks (torch's ``preserve_rng_state`` restores its default generators
    only), holds :func:`recomputing` true, and afterwards puts back the
    states the generators had."""

    def __init__(self, forward: _RematForward):
        self.forward = forward

    def __enter__(self):
        gens = self.forward.gens
        self.now = [g.get_state() for g in gens]
        self.outer, _REMAT.recomputing = _REMAT.recomputing, True
        for g, state in zip(gens, self.forward.states):
            g.set_state(state)

    def __exit__(self, *exc):
        _REMAT.recomputing = self.outer
        for g, state in zip(self.forward.gens, self.now):
            g.set_state(state)


def _remat_contexts(fn):
    forward = _RematForward(_generators(fn))
    return forward, _RematRecompute(forward)


def remat_call(fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """``fn(*args)`` rematerialized (JAX ``nn.remat``): the activations
    inside are freed after the forward and recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant).  Two effects of ``fn`` that
    a plain recompute would repeat are held to one: a :class:`BatchNorm`
    moves its running statistics in the forward only, and a
    :func:`dropout` draws the forward's mask again from its generator's
    state at the forward, so loss, gradients and statistics equal those
    without remat."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: _remat_contexts(fn))


def max_pool_t(x: torch.Tensor, window: int, stride: int,
               padding: int) -> torch.Tensor:
    """Temporal max-pool (window, 1)/(stride, 1) with -inf padding, as torch
    MaxPool2d, on channels-last ``(N, T, V, C)``."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), (window, 1), (stride, 1),
                     (padding, 0))
    return y.permute(0, 2, 3, 1)


def joint_pad_check(mod: nn.Module) -> None:
    """JAX's refusal of training in joint-padded mode (``mod.v_pad``).

    JAX pads the joint axis to ``v_pad`` for the TPU's 8-row sublanes.  The
    H100 has no such tile on these paths: padding 25 -> 32 joints was
    exact on the real joints and cost 20-26% of serving clips/s there
    (PERF.md §6), so the port runs a unit in this mode at the real joints,
    with JAX's refusals."""
    if mod.v_pad and mod.training:
        raise NotImplementedError(
            f"{type(mod).__name__}: joint-padded mode (v_pad) is eval-only")
