"""Expert parallelism for the sparse mixture of experts (port of
``dsgcn_tpu/parallel/expert_parallel.py``).

Each process of an expert group holds one routed expert, ``expert{e}`` on
rank e; the gate's base expert and the gate are replicated, as is the
batch.  Every rank runs the base and the gate, its own expert, and adds
``gates[:, e:e+1] * out_e`` over the group with one ``all_reduce(SUM)``:
the dense ``SMoEAssembleSparse`` combine, spread over E processes.  Eval
only.  The routed experts must be homogeneous (one family and ratio, so
one set of kwargs) and the group must have E processes, as JAX requires
(it stacks the experts' trees along a sharded axis).

The group is the one ``parallel/mesh.py:init_distributed`` joined: NCCL
for CUDA devices, gloo on the CPU (or gloo on one card for several
processes, which NCCL refuses).
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from ..sparse.smoe import (NoisyTopKGate, SMoEAssembleSparse, _pool,
                           cv_squared, make_expert)


class ExpertMesh(NamedTuple):
    """The expert axis as this process sees it."""
    group: dist.ProcessGroup
    size: int
    index: int


def make_expert_mesh(n_experts: int) -> ExpertMesh:
    """The expert axis over the first ``n_experts`` ranks of the process
    group (every rank calls it); a rank beyond them gets no axis."""
    world = dist.get_world_size()
    if n_experts > world:
        raise ValueError(f"{n_experts} experts need as many processes; the "
                         f"group has {world}")
    group = dist.new_group(list(range(n_experts)))
    rank = dist.get_rank()
    if rank >= n_experts:
        raise ValueError(f"rank {rank} is outside the {n_experts}-expert "
                         f"axis")
    return ExpertMesh(group, n_experts, rank)


def stack_pytrees(trees: Sequence[Mapping[str, torch.Tensor]]
                  ) -> dict:
    """State dicts of one structure stacked along a new leading axis, as
    JAX stacks the experts' trees."""
    keys = trees[0].keys()
    if any(t.keys() != keys for t in trees[1:]):
        raise ValueError("the trees differ in structure")
    return {k: torch.stack([t[k] for t in trees]) for k in keys}


def _slice(state: Mapping[str, torch.Tensor], prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def make_ep_smoe_eval(mesh: ExpertMesh, model: SMoEAssembleSparse
                      ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``run(state, x, current_epoch, max_epoch) -> (feature, aux)``: the
    eval forward of ``model`` with rank e of ``mesh`` running expert e.

    ``model`` gives the configuration only: this rank builds its own
    expert, the base and the gate, and each call loads them strictly from
    ``state`` (the whole model's ``state_dict``, e.g. from
    ``convert_jax_variables``), as JAX's helper restacks the experts'
    variables each call.  They run on ``x``'s device; ``run.modules`` holds
    them."""
    fams = set(model.model_list[:-1])
    ratios = set(model.sparse_ratio[:-1])
    if len(fams) != 1 or len(ratios) != 1:
        raise ValueError("expert parallelism needs homogeneous routed "
                         f"experts, not {model.model_list[:-1]} at "
                         f"{model.sparse_ratio[:-1]}")
    E = model.num_experts
    if mesh.size != E:
        raise ValueError(f"an expert axis of {mesh.size} for {E} experts")
    fam, ratio = next(iter(fams)), next(iter(ratios))
    e = mesh.index

    def build(family, r):
        return make_expert(family, r, model.graph_cfg, model.warm_up,
                           model.sparse_decay,
                           model.expert_kwargs.get(family)).eval()
    expert = build(fam, ratio)
    base = build(model.model_list[-1], model.sparse_ratio[-1])
    gate = NoisyTopKGate(base.out_channels, E, model.k_num,
                         model.noisy_gating).eval()

    @torch.no_grad()
    def run(state: Mapping[str, torch.Tensor], x: torch.Tensor,
            current_epoch, max_epoch) -> Tuple[torch.Tensor, torch.Tensor]:
        for mod, prefix in ((expert, f"expert{e}."), (base, f"expert{E}."),
                            (gate, "gate.")):
            mod.to(x.device, x.dtype)
            mod.load_state_dict(_slice(state, prefix), strict=True)
        feat = _pool(base(x, base.epoch_sparsity(current_epoch, max_epoch)))
        gates, load = gate(feat)
        out = _pool(expert(x, expert.epoch_sparsity(current_epoch,
                                                    max_epoch)))
        combined = gates[:, e:e + 1] * out
        dist.all_reduce(combined, dist.ReduceOp.SUM, group=mesh.group)
        aux = model.loss_coef * (cv_squared(gates.sum(0)) + cv_squared(load))
        return combined, aux

    run.modules = (expert, base, gate)     # what this rank holds
    return run

