"""Optimizer, schedule and the train/eval steps (port of
``dsgcn_tpu/core/train.py``).

The reference recipe: SGD lr 0.1, momentum 0.9 with Nesterov, coupled
weight decay 5e-4 on every parameter, cosine annealing to 0 by iteration
(``configs/_init_/schedule.py``).  The JAX package builds it as the optax
chain clip -> add_decayed_weights -> trace(nesterov) -> lr_mult ->
scale_by_learning_rate; here it is ``torch.optim.SGD`` with one parameter
group per (lr_mult, decay_mult), which is the same update: the momentum
trace does not involve the learning rate, so a per-group lr of
``lr * lr_mult`` equals scaling the traced update by ``lr_mult``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..ops.common import BNStats, TorchBN
from ..sparse.supermask import SparseKernel
from .losses import cross_entropy, top_k_correct


def jax_param_names(model: nn.Module) -> Dict[str, str]:
    """Port parameter name -> the dotted path of the same leaf in the JAX
    package's param tree (the inverse of ``utils/convert.py``): a
    :class:`BNStats`'s ``weight``/``bias`` (a BatchNorm's, a
    ``ConvBN3d``'s) live under its ``bn`` scope as ``scale``/``bias`` (a
    :class:`TorchBN`'s at its own scope), the
    weights of linear maps, convolutions (transposed ones too) and sparse
    layers are
    ``kernel``s (a sparse layer's ``score`` keeps its name), and raw
    parameters (``PA``, ``out_conv_kernel``, the causal banks,
    ``GCComponent.weight``, the necks' prototypes, ``Set2Set``'s and the
    cMLP's leaves, the SMoE gate's ``w_gate``/``w_noise``) keep their
    names."""
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if isinstance(mod, BNStats):
                scope = mod_name if isinstance(mod, TorchBN) \
                    else f"{mod_name}.bn"
                path = f"{scope}." + ("scale" if leaf == "weight" else leaf)
            elif leaf == "weight" and isinstance(
                    mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d,
                          nn.ConvTranspose3d, SparseKernel)):
                path = f"{mod_name}.kernel" if mod_name else "kernel"
            else:
                path = name
            out[name] = path
    return out


def paramwise_mults(model: nn.Module,
                    paramwise_cfg: Mapping) -> Dict[str, Tuple[float, float]]:
    """Per-parameter (lr_mult, decay_mult), mmcv DefaultOptimizerConstructor
    semantics as the JAX package applies them to its param paths:

    * ``custom_keys``: substring match on the JAX path; the longest (then
      alphabetically first) matching key wins over every other rule;
    * ``norm_decay_mult``: every parameter of a norm layer (a path component
      containing 'bn');
    * ``bias_lr_mult`` / ``bias_decay_mult``: 'bias' leaves outside norms.
    """
    custom = paramwise_cfg.get("custom_keys", {})
    keys = sorted(custom, key=lambda k: (-len(k), k))
    bias_lr = paramwise_cfg.get("bias_lr_mult", 1.0)
    bias_decay = paramwise_cfg.get("bias_decay_mult", 1.0)
    norm_decay = paramwise_cfg.get("norm_decay_mult", 1.0)
    out = {}
    for name, path in jax_param_names(model).items():
        key = next((k for k in keys if k in path), None)
        parts = path.split(".")
        if key is not None:
            out[name] = (custom[key].get("lr_mult", 1.0),
                         custom[key].get("decay_mult", 1.0))
        elif any("bn" in p.lower() for p in parts[:-1]):
            out[name] = (1.0, norm_decay)
        elif parts[-1] == "bias":
            out[name] = (bias_lr, bias_decay)
        else:
            out[name] = (1.0, 1.0)
    return out


class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` that first clips the gradients by their global
    norm when ``grad_clip`` is set (optax ``clip_by_global_norm``: scale by
    max_norm / norm when norm >= max_norm)."""

    def __init__(self, params, grad_clip: Optional[float] = None, **kw):
        super().__init__(params, **kw)
        self.grad_clip = grad_clip

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_clip is not None:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            if grads:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g) for g in grads]))
                scale = torch.where(norm < self.grad_clip,
                                    torch.ones_like(norm),
                                    self.grad_clip / norm)
                torch._foreach_mul_(grads, scale)
        return super().step(closure)


def cosine_factor(total_steps: int):
    """lr(step) / lr of ``optax.cosine_decay_schedule(lr, total_steps,
    alpha=0)``, in closed form at the step count (the recursive
    ``CosineAnnealingLR`` drifts)."""
    def f(step: int) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * min(step, total_steps)
                                     / total_steps))
    return f


def make_optimizer(model: nn.Module, total_steps: int, lr: float = 0.1,
                   momentum: float = 0.9, weight_decay: float = 5e-4,
                   grad_clip: Optional[float] = None,
                   paramwise_cfg: Optional[Mapping] = None):
    """(optimizer, scheduler): the JAX ``make_optimizer`` recipe, Nesterov
    momentum and the cosine schedule over ``total_steps``.  Call
    ``scheduler.step()`` after every ``optimizer.step()``; the learning
    rate of step s is lr * f(s)."""
    if total_steps < 1:
        raise ValueError(f"total_steps={total_steps}: the cosine schedule "
                         "needs at least one step")
    named = dict(model.named_parameters())
    mults = (paramwise_mults(model, paramwise_cfg) if paramwise_cfg
             else {n: (1.0, 1.0) for n in named})
    groups: Dict[Tuple[float, float], list] = {}
    for name, p in named.items():
        groups.setdefault(mults[name], []).append(p)
    param_groups = [dict(params=ps, lr=lr * lm, weight_decay=weight_decay * dm)
                    for (lm, dm), ps in groups.items()]
    opt = SGD(param_groups, grad_clip=grad_clip, lr=lr, momentum=momentum,
              nesterov=momentum > 0)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, cosine_factor(total_steps))


def input_key(batch: Mapping) -> str:
    """The batch's model input: ``keypoint`` (the GCNs' skeletons), else
    ``imgs`` (PoseC3D's heatmap volumes; JAX ``core/train.py:163``)."""
    return "keypoint" if "keypoint" in batch else "imgs"


def _device_batch(batch: Mapping, device: torch.device):
    x, label = batch[input_key(batch)], batch["label"]
    x = torch.as_tensor(x).to(device, non_blocking=True)
    label = torch.as_tensor(label).to(device, non_blocking=True)
    return x, label


def loss_and_metrics(model: nn.Module, batch: Mapping,
                     compute_dtype: Optional[str] = None):
    """Train-mode forward, cross entropy and the on-device top-1/top-5
    (JAX ``core/train.py:loss_and_metrics``) of the batch's input
    (:func:`input_key`).  ``compute_dtype='bfloat16'``
    casts only the input: the modules cast their float32 master weights to
    the activation dtype, BatchNorm statistics stay float32, and the loss
    is taken on float32 logits."""
    device = next(model.parameters()).device
    kp, label = _device_batch(batch, device)
    if compute_dtype is not None:
        kp = kp.to(getattr(torch, compute_dtype))
    logits = model(kp)
    if compute_dtype is not None:
        logits = logits.float()
    loss = cross_entropy(logits, label)
    with torch.no_grad():
        metrics = dict(loss=loss.detach(),
                       top1_acc=top_k_correct(logits, label, 1),
                       top5_acc=top_k_correct(logits, label, 5))
    return loss, metrics


def zero_missing_grads_(opt: torch.optim.Optimizer) -> None:
    """A zero gradient for each parameter of ``opt`` the backward did not
    reach."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def train_step(model: nn.Module, opt: torch.optim.Optimizer, sched,
               batch: Mapping, compute_dtype: Optional[str] = None
               ) -> Dict[str, torch.Tensor]:
    """One step on the model's device: forward in train mode (BatchNorm
    running statistics move), backward, SGD update, schedule step.  A
    parameter the loss does not reach (STGIN's last temporal-edge conv, a
    gate of a graph that is off) gets a zero gradient, so that it decays
    and its momentum moves as optax moves every leaf in JAX (torch's SGD
    skips a parameter without a gradient).  Returns the metrics
    (``loss``, ``top1_acc``, ``top5_acc``) as 0-d tensors on the
    device."""
    model.train()
    loss, metrics = loss_and_metrics(model, batch, compute_dtype)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    zero_missing_grads_(opt)
    opt.step()
    if sched is not None:
        sched.step()
    return metrics


@torch.no_grad()
def eval_step(model: nn.Module, keypoint) -> torch.Tensor:
    """Eval-mode forward -> logits."""
    model.eval()
    device = next(model.parameters()).device
    return model(torch.as_tensor(keypoint).to(device))
