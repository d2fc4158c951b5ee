"""Sparse (supermask / lottery-ticket) training (port of
``dsgcn_tpu/sparse/supermask.py``).

* ``supermask``: the top (1 - sparsity) fraction of a score tensor, with a
  straight-through gradient to the score (GetSubnet, sparse_mosules.py:
  41-54); ``supermask_at`` the same at a given threshold;
* the linear sparsity ramp (init_func.py:24-26) and CTRGCN_sparse's
  schedule (ctrgcn_sparse.py:122-132);
* the score-versus-weight optimizer (core/hooks/sparse_optimizer.py:9-94)
  as two parameter groups and a gate on the score gradients;
* the group-lasso penalty (stgcn_sparse.py:225-263) and the re-drawing of
  pruned weights (sparse_mosules.py:61-118).

Kernels are held in torch's orientation (a 1x1's (out, in), a temporal
conv's (out, in, k, 1)) and each ``score`` beside its kernel in the same
orientation (``utils/convert.py`` turns both the same way).  The masks are
computed in the forward from the sparsity passed in, so a schedule
changes nothing but a number.  No kernel of the port runs here.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, \
    Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.common import cast


def get_sparsity(sparsity: float, current_epoch, start_epoch: float,
                 end_epoch: float):
    """Linear sparsity ramp (reference init_func.py:24-26)."""
    frac = (current_epoch - start_epoch) / (end_epoch - start_epoch)
    return sparsity - sparsity * (1.0 - frac)


def quantile(t: torch.Tensor, q) -> torch.Tensor:
    """``jnp.quantile(t.reshape(-1), q)`` with its linear interpolation
    written as JAX computes it: with i = q (n - 1), the sorted values at
    floor(i) and ceil(i) weighted (1 - w, w), w = i - floor(i), in t's
    dtype (``torch.quantile`` lerps, which rounds differently)."""
    flat = torch.sort(t.reshape(-1)).values
    pos = torch.as_tensor(q, dtype=flat.dtype, device=flat.device) \
        * (flat.numel() - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w = pos - lo
    return flat[lo.long()] * (1 - w) + flat[hi.long()] * w


class _Supermask(torch.autograd.Function):
    @staticmethod
    def forward(ctx, score, sparsity):
        thresh = quantile(score.detach(), sparsity)
        return (score >= thresh).to(score.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SupermaskAt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, score, threshold):
        return (score >= threshold).to(score.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def supermask(score: torch.Tensor, sparsity) -> torch.Tensor:
    """Binary mask of the scores at or above their ``sparsity`` quantile
    (:func:`quantile`), with a straight-through gradient to the score and
    none to the sparsity (GetSubnet's STE, sparse_mosules.py:41-54)."""
    return _Supermask.apply(score, sparsity)


def supermask_at(score: torch.Tensor, threshold) -> torch.Tensor:
    """mask = (score >= threshold), straight through to the score and
    nothing to the threshold (GetSubnet at an external threshold)."""
    return _SupermaskAt.apply(score, threshold)


def torch_percentile(t: torch.Tensor, q) -> torch.Tensor:
    """torch's kthvalue percentile (ctrgcn_sparse.py:155-157): the k-th
    smallest with k = 1 + round(0.01 q (n - 1)), rounded half to even
    (``torch.round`` as ``jnp.round``), clipped to [1, n]."""
    flat = torch.sort(t.reshape(-1)).values
    n = flat.numel()
    k = 1 + torch.round(torch.as_tensor(0.01 * q * (n - 1))).long()
    return flat[torch.clamp(k - 1, 0, n - 1)]


def pooled_threshold(score_leaves: Sequence[torch.Tensor],
                     sparsity) -> torch.Tensor:
    """Global percentile threshold over the concatenated score tensors
    (get_threshold, ctrgcn_sparse.py:145-153).  No gradient reaches it
    (``supermask_at`` gives the threshold none), so it is taken
    detached."""
    flat = torch.cat([s.detach().reshape(-1) for s in score_leaves])
    return torch_percentile(flat, sparsity * 100.0)


def sparsity_schedule(linear_sparsity: float, current_epoch, max_epoch,
                      warm_up: int = 0, sparse_decay: bool = False):
    """CTRGCN_sparse.forward's sparsity schedule (ctrgcn_sparse.py:122-132)."""
    if current_epoch < warm_up:
        return 0.0
    if sparse_decay and current_epoch < max_epoch / 2.0:
        return get_sparsity(linear_sparsity, current_epoch, 0,
                            max_epoch / 2.0)
    return linear_sparsity


class SparseKernel(nn.Module):
    """A kernel ``weight`` with a ``score`` of its shape and an optional
    ``bias`` (a sparse 1x1 or temporal conv).  ``weight`` is JAX's
    ``kernel`` (``core/train.py:jax_param_names``); ``init_`` draws
    JAX's initializers: kernel and score U(+-1/sqrt(fan_in)) (flax's
    ``torch_default_kernel``), the bias U(+-1/sqrt(fan_in)) or zeros
    (``zero_bias``, the ``*At`` modules)."""
    zero_bias = False

    def _init_kernel(self, shape: Tuple[int, ...], bias: bool) -> None:
        self.weight = nn.Parameter(torch.empty(shape))
        self.score = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape[0])) if bias else None
        self.init_(None)

    @torch.no_grad()
    def init_(self, generator: Optional[torch.Generator]) -> None:
        bound = self.weight[0].numel() ** -0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        self.score.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            if self.zero_bias:
                self.bias.zero_()
            else:
                self.bias.uniform_(-bound, bound, generator=generator)

    def masked(self, mask_arg) -> torch.Tensor:
        return self.weight * self.mask(mask_arg)


class SparseDense(SparseKernel):
    """1x1 conv / dense layer whose kernel is multiplied by the STE
    supermask of its score at the ``sparsity`` given to the forward
    (SparseConv2d.forward, sparse_mosules.py:120-160)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self._init_kernel((features, in_features), use_bias)

    def mask(self, sparsity) -> torch.Tensor:
        return supermask(self.score, sparsity)

    def forward(self, x: torch.Tensor, mask_arg) -> torch.Tensor:
        b = None if self.bias is None else cast(self.bias, x.dtype)
        return F.linear(x, cast(self.masked(mask_arg), x.dtype), b)


class SparseTemporalConv(SparseKernel):
    """k x 1 temporal conv (channels-last (N, T, V, C) in and out, as
    ``ops/common.py:TemporalConv``) with a supermasked kernel."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 9, stride: int = 1, dilation: int = 1,
                 use_bias: bool = True):
        super().__init__()
        k, d = kernel_size, dilation
        self.stride, self.dilation = stride, d
        self.pad = (k + (k - 1) * (d - 1) - 1) // 2
        self._init_kernel((features, in_features, k, 1), use_bias)

    def mask(self, sparsity) -> torch.Tensor:
        return supermask(self.score, sparsity)

    def forward(self, x: torch.Tensor, mask_arg) -> torch.Tensor:
        b = None if self.bias is None else cast(self.bias, x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     cast(self.masked(mask_arg), x.dtype), b,
                     (self.stride, 1), (self.pad, 0), (self.dilation, 1))
        return y.permute(0, 2, 3, 1)


def sparse_kernels(model: nn.Module) -> Iterator[Tuple[str, SparseKernel]]:
    """(name, module) of every sparse kernel of ``model``."""
    for name, m in model.named_modules():
        if isinstance(m, SparseKernel):
            yield name, m


def score_mask_tree(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> 'score' (a ``score`` leaf) or 'main'."""
    return {name: "score" if name.split(".")[-1] == "score" else "main"
            for name, _ in model.named_parameters()}


def make_sparse_optimizer(model: nn.Module, main: Mapping, score: Mapping,
                          warmup_epochs: int = 0,
                          optimizer: Callable = torch.optim.SGD):
    """The main/score alternation (reference SparseOptimizer hook; JAX's
    ``optax.multi_transform`` over :func:`score_mask_tree`): one
    ``optimizer`` with two parameter groups, the main weights under the
    keyword arguments ``main`` and the scores under ``score``.  Returns
    (optimizer, ``gate_score_grads(epoch)``): call the gate between the
    backward and the step; before ``warmup_epochs`` it sets every score's
    gradient to zero (a zero tensor where the backward left none), so the
    score group still steps, its weight decay and momentum moving as
    optax's do, while the loss moves no score."""
    labels = score_mask_tree(model)
    named = dict(model.named_parameters())
    groups = [dict(params=[p for n, p in named.items() if labels[n] == k],
                   **cfg) for k, cfg in (("main", main), ("score", score))]
    scores = groups[1]["params"]
    opt = optimizer(groups)

    def gate_score_grads(current_epoch) -> None:
        for p in scores:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif current_epoch < warmup_epochs:
                p.grad.zero_()
    return opt, gate_score_grads


def group_lasso_penalty(model: nn.Module, weight: float = 1e-4,
                        sparsity=None) -> torch.Tensor:
    """Group lasso over the sparse kernels (in the spirit of the
    reference's GSGL, stgcn_sparse.py:225-263): the L2 norm of each output
    feature's group of every kernel that has a ``score`` (JAX groups by
    its kernels' last axis, torch's first), + 1e-12 under the root, summed
    and scaled by ``weight``; with ``sparsity`` each kernel is first
    masked by its supermask at that sparsity."""
    total = 0.0
    for _, m in sparse_kernels(model):
        w = m.weight if sparsity is None \
            else m.weight * supermask(m.score, sparsity)
        flat = w.reshape(w.shape[0], -1)
        total = total + torch.sqrt((flat ** 2).sum(dim=1) + 1e-12).sum()
    return weight * total


# ---------------------------------------------------------------------------
# re-drawing the pruned weights (SparseModule.init_param_/rerandomize_,
# sparse_mosules.py:61-118)
# ---------------------------------------------------------------------------

def draw_init(shape: Sequence[int],
              generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float32, device=None,
              init_mode: str = "kaiming_uniform",
              scale: float = 1.0) -> torch.Tensor:
    """A fresh weight draw of torch shape (out, in, ...) (init_param_,
    sparse_mosules.py:61-79), fan_in = in x kernel size, ReLU gain."""
    fan = max(math.prod(shape[1:]), 1)
    gain = math.sqrt(2.0)
    kw = dict(dtype=dtype, device=device, generator=generator)
    if init_mode == "kaiming_normal":
        w = torch.randn(*shape, **kw) * (gain / math.sqrt(fan))
    elif init_mode == "uniform":
        w = torch.rand(*shape, **kw) * 2.0 - 1.0
    elif init_mode == "kaiming_uniform":
        bound = gain * math.sqrt(3.0 / fan)
        w = (torch.rand(*shape, **kw) * 2.0 - 1.0) * bound
    elif init_mode == "signed_constant":
        w = torch.sign(torch.randn(*shape, **kw)) * (gain / math.sqrt(fan))
    else:
        raise NotImplementedError(init_mode)
    return w * scale


@torch.no_grad()
def rerandomize_param(param: torch.Tensor, score: torch.Tensor, sparsity,
                      generator: Optional[torch.Generator] = None,
                      rerand_rate: float = 1.0, mode: str = "bernoulli",
                      la: float = 0.1, mu: float = 0.0,
                      init_mode: str = "kaiming_uniform",
                      scale: float = 1.0) -> torch.Tensor:
    """A weight tensor re-drawn outside its supermask (rerandomize_,
    sparse_mosules.py:83-118).  The mask is taken at sparsity x
    ``rerand_rate`` (sparse_mosules.py:213-214).  'bernoulli': each pruned
    weight is replaced by a fresh draw with probability ``la``, the kept
    ones unchanged; 'manual': pruned weights become la old + mu fresh.
    ``generator`` lives on the parameter's device."""
    mask = supermask(score, sparsity * rerand_rate)
    rnd = draw_init(param.shape, generator, param.dtype, param.device,
                    init_mode, scale)
    if mode == "bernoulli":
        b = torch.empty_like(param).bernoulli_(la, generator=generator)
        return param * mask + param * (1 - mask) * (1 - b) \
            + rnd * (1 - mask) * b
    if mode == "manual":
        return param * mask + param * (1 - mask) * la + rnd * (1 - mask) * mu
    raise NotImplementedError(mode)


@torch.no_grad()
def rerandomize_tree(model: nn.Module, sparsity,
                     generator: Optional[torch.Generator] = None,
                     **kw) -> nn.Module:
    """:func:`rerandomize_param` on the kernel of every sparse layer of
    ``model``, in place, in module order from one generator (JAX folds a
    hash of each path into its key: other bits, the same law)."""
    for _, m in sparse_kernels(model):
        m.weight.copy_(rerandomize_param(m.weight, m.score, sparsity,
                                         generator, **kw))
    return model
