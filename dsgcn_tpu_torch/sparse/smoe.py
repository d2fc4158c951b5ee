"""The sparse mixture of experts over sparse GCN backbones (port of
``dsgcn_tpu/sparse/smoe.py``; reference ``pyskl/pyskl/models/gcns/SMoE.py``).

Noisy top-k gating (Shazeer et al. 2017, SMoE.py:246-283) over whole
backbones: the last entry of ``model_list`` is the gate's base expert,
whose pooled feature feeds the gate (SMoE.py:285-295).  As in JAX, every
routed expert runs on the whole batch and the gate matrix (zero off each
sample's top k) weights their pooled features: eval answers equal the
reference dispatcher's, while in training an expert's BatchNorms see the
whole batch, not only its routed samples.  ``parallel/expert_parallel.py``
puts one routed expert on each process.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph import GraphConfig
from .models import NTU, SparseCTRGCN, SparseSTGCNExact
from .nested import SparseAAGCN, SparseDGSTGCN
from .supermask import SparseKernel, torch_percentile

FAMILIES = ("ST-GCN", "AA-GCN", "CTR-GCN", "DG-GCN")
# JAX divides by sqrt(2) as a float32 constant, also in float64
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def cv_squared(x: torch.Tensor) -> torch.Tensor:
    """The squared coefficient of variation, var (Bessel-corrected) over
    mean^2 + 1e-10; 0 for a single element (SMoE.py:188-204)."""
    if x.shape[0] == 1:
        return x.new_zeros(())
    return x.var(correction=1) / (x.mean() ** 2 + 1e-10)


def _normal_cdf(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


class NoisyTopKGate(nn.Module):
    """Noisy top-k gating (SMoE.py:246-283): ``w_gate`` and ``w_noise``,
    raw (C, E) parameters starting at zero.  In training with
    ``noisy_gating`` the logits get N(0, 1) noise (``noise`` given, else
    drawn from ``generator``; one of them is required) times softplus(x
    w_noise) + ``noise_epsilon``.  The gates are the softmax of each row's
    top k logits, zero elsewhere; ties rank the lower expert first, as
    ``jax.lax.top_k`` does (a stable descending sort).  ``load`` is each
    expert's in-top-k probability under the noise summed over the batch
    (``_prob_in_top_k``, SMoE.py:206-237), else its count of nonzero
    gates.  Returns (gates (N, E), load (E,))."""

    def __init__(self, in_channels: int, num_experts: int, k: int = 1,
                 noisy_gating: bool = True, noise_epsilon: float = 1e-2):
        super().__init__()
        if k > num_experts:
            raise ValueError(f"k = {k} exceeds the {num_experts} experts")
        self.num_experts, self.k = num_experts, k
        self.noisy_gating, self.noise_epsilon = noisy_gating, noise_epsilon
        self.w_gate = nn.Parameter(torch.zeros(in_channels, num_experts))
        self.w_noise = nn.Parameter(torch.zeros(in_channels, num_experts))

    def forward(self, feat: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        E, k = self.num_experts, self.k
        clean = feat @ self.w_gate.to(feat.dtype)
        use_noise = self.noisy_gating and self.training
        logits = clean
        if use_noise:
            std = F.softplus(feat @ self.w_noise.to(feat.dtype)) \
                + self.noise_epsilon
            if noise is None:
                if generator is None:
                    raise ValueError("train-time noisy gating needs a "
                                     "generator or the noise")
                noise = torch.randn(clean.shape, generator=generator,
                                    dtype=clean.dtype, device=clean.device)
            logits = clean + noise.to(clean) * std
        m = min(k + 1, E)
        vals, idx = torch.sort(logits, dim=1, descending=True, stable=True)
        top_vals, top_idx = vals[:, :m], idx[:, :m]
        gates = torch.zeros_like(logits).scatter(
            1, top_idx[:, :k], torch.softmax(top_vals[:, :k], dim=1))
        if use_noise and k < E:
            thr_in, thr_out = top_vals[:, k:k + 1], top_vals[:, k - 1:k]
            prob = torch.where(logits > thr_in,
                               _normal_cdf((clean - thr_in) / std),
                               _normal_cdf((clean - thr_out) / std))
            load = prob.sum(0)
        else:
            load = (gates > 0).sum(0).to(feat.dtype)
        return gates, load


def _pool(feat: torch.Tensor) -> torch.Tensor:
    """(N, M, T, V, C) -> (N, C): the mean over T and V, then over the
    persons (GCN_feature, SMoE.py:326-339)."""
    return feat.mean(dim=(2, 3)).mean(dim=1)


def make_expert(family: str, ratio: float, graph_cfg: GraphConfig,
                warm_up: int, sparse_decay: bool,
                kwargs: Optional[Mapping] = None) -> nn.Module:
    """One sparse backbone expert with the nested copy's thresholds
    (SMoE.py:158-178): ST-GCN one global percentile
    (``SparseSTGCNExact(global_threshold=True)``), CTR-GCN every score in
    its stage pools (``SparseCTRGCN(pool_all_scores=True)``), AA-GCN and
    DG-GCN per stage."""
    common = dict(graph_cfg=graph_cfg, linear_sparsity=ratio,
                  warm_up=warm_up, sparse_decay=sparse_decay,
                  **dict(kwargs or {}))
    if family == "ST-GCN":
        return SparseSTGCNExact(global_threshold=True, **common)
    if family == "AA-GCN":
        return SparseAAGCN(**common)
    if family == "CTR-GCN":
        return SparseCTRGCN(pool_all_scores=True, **common)
    if family == "DG-GCN":
        return SparseDGSTGCN(**common)
    raise ValueError(f"unknown expert family {family!r} (not in {FAMILIES})")


class SMoEAssembleSparse(nn.Module):
    """SMoEAssemble_sparse (SMoE.py:115-400): ``expert{i}`` for each entry
    of ``model_list`` (``make_expert`` at ``sparse_ratio[i]``, with
    ``expert_kwargs[family]``, the reference's ST_/AA_/CTR_/DG_kwargs),
    the last the gate's base, and ``gate`` (:class:`NoisyTopKGate` over
    the base's pooled feature, one expert for each of the others).

    ``forward(x, current_epoch, max_epoch, generator=None,
    gate_noise=None)`` returns (the gate-weighted sum of the routed
    experts' pooled features (N, C), the balance loss ``loss_coef``
    (cv^2(importance) + cv^2(load)), SMoE.py:295-302); each expert runs at
    its own ``epoch_sparsity``.  ``gates`` holds the last forward's gate
    matrix (detached), as JAX sows it under 'intermediates'.
    ``out_channel`` is the reference's; as in JAX the gate takes the
    base's width."""

    def __init__(self, model_list: Sequence[str],
                 sparse_ratio: Sequence[float], graph_cfg: GraphConfig = NTU,
                 expert_kwargs: Optional[Mapping] = None,
                 out_channel: int = 256, k_num: int = 1,
                 noisy_gating: bool = True, warm_up: int = 0,
                 sparse_decay: bool = False, loss_coef: float = 1e-2):
        super().__init__()
        if len(model_list) != len(sparse_ratio):
            raise ValueError(f"{len(model_list)} experts, "
                             f"{len(sparse_ratio)} ratios")
        self.model_list, self.sparse_ratio = tuple(model_list), \
            tuple(sparse_ratio)
        self.graph_cfg = graph_cfg
        self.expert_kwargs = {k: dict(v) for k, v in
                              dict(expert_kwargs or {}).items()}
        self.out_channel, self.k_num = out_channel, k_num
        self.noisy_gating, self.loss_coef = noisy_gating, loss_coef
        self.warm_up, self.sparse_decay = warm_up, sparse_decay
        self.num_experts = E = len(self.model_list) - 1
        for i, (f, r) in enumerate(zip(self.model_list, self.sparse_ratio)):
            self.add_module(f"expert{i}", make_expert(
                f, r, graph_cfg, warm_up, sparse_decay,
                self.expert_kwargs.get(f)))
        self.gate = NoisyTopKGate(self.expert(E).out_channels, E, k_num,
                                  noisy_gating)
        self.gates: Optional[torch.Tensor] = None

    def expert(self, i: int) -> nn.Module:
        return getattr(self, f"expert{i}")

    def forward(self, x: torch.Tensor, current_epoch, max_epoch,
                generator: Optional[torch.Generator] = None,
                gate_noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        E = self.num_experts
        base = self.expert(E)
        feat = _pool(base(x, base.epoch_sparsity(current_epoch, max_epoch)))
        gates, load = self.gate(feat, generator, gate_noise)
        aux = self.loss_coef * (cv_squared(gates.sum(0)) + cv_squared(load))
        combined = 0.0
        for i in range(E):
            e = self.expert(i)
            out = _pool(e(x, e.epoch_sparsity(current_epoch, max_epoch)))
            combined = combined + gates[:, i:i + 1] * out
        self.gates = gates.detach()
        return combined, aux


def _stage_mask(block: nn.Module, ratio: float) -> torch.Tensor:
    """One stage's pruned weights (get_mask, SMoE.py:363-380): every
    sparse kernel's weights whose score is at most the ``ratio``
    percentile of the stage's scores (the inverted mask), the others
    zero, flattened.  Plain convs (AAGCN's attention) have no score and
    do not count."""
    kernels = [m for m in block.modules() if isinstance(m, SparseKernel)]
    s = torch.cat([m.score.detach().reshape(-1) for m in kernels])
    w = torch.cat([m.weight.reshape(-1) for m in kernels])
    return w * (s <= torch_percentile(s, ratio * 100.0)).to(w.dtype)


def _stage_mask_penalty(blocks_with_ratios, lam: float,
                        penalty: str) -> torch.Tensor:
    terms = [_stage_mask(b, r) for b, r in blocks_with_ratios]
    if penalty == "GL":
        return lam * torch.linalg.vector_norm(torch.cat(terms))
    if penalty == "GSGL":
        return lam * sum(torch.linalg.vector_norm(t) for t in terms)
    raise ValueError(f"unsupported penalty: {penalty}")


def smoe_regularize(model: SMoEAssembleSparse, lam: float,
                    penalty: str = "GSGL") -> torch.Tensor:
    """SMoE.regularize (SMoE.py:341-400): the group lasso over every
    expert stage's pruned weights at the expert's ``sparse_ratio``.  JAX's
    quirk, kept: an expert reached through ``.gcn`` (every family but
    CTR-GCN) has each stage counted twice (the try and its else both
    append, :385-395), so under GSGL its terms double."""
    blocks = []
    for j, family in enumerate(model.model_list):
        reps = 1 if family == "CTR-GCN" else 2
        for blk in model.expert(j).blocks():
            blocks.extend([(blk, model.sparse_ratio[j])] * reps)
    return _stage_mask_penalty(blocks, lam, penalty)
