"""Data-parallel and joint-partitioned train and eval steps (port of
``dsgcn_tpu/parallel/train.py``).

The reference recipe is multi-GPU DDP with per-device BatchNorm statistics
(``broadcast_buffers=False``) and gradients averaged over the devices each
step.  Here each process runs the port's ``train_step`` on a module wrapped
in ``DistributedDataParallel(..., broadcast_buffers=False)`` over all
processes of the mesh (:func:`distribute`), and the step adds what JAX's
``shard_map`` step does around it:

* gradients: DDP's mean over every process.  The graph groups are equal in
  size, so it is JAX's ``pmean(pmean(grads, graph), data)``: a
  joint-partitioned model's gradients summed over a graph group are G times
  the true ones (``parallel/joint_partition.py``), which the mean over the
  group divides out.  Gradient clipping (in the optimizer's step) comes
  after the reduction;
* BatchNorm running statistics: averaged over every process after the step
  (JAX's ``pmean`` of the new statistics, so every process holds the same
  state; pyskl keeps rank-local buffers and checkpoints rank 0's);
* metrics: averaged over the data axis;
* dropout: one generator per data rank, seeded from the seed and the data
  index (JAX's ``fold_in(rng, axis_index('data'))``), so the graph ranks of
  one data row draw the same masks.

The eval steps take the global batch on every process (a multiple of the
data axis), score this data rank's rows and all-gather the logits over the
data axis: every process returns the whole batch's logits.
"""
from __future__ import annotations

import warnings
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..core.train import eval_step, train_step
from ..models.builder import set_dropout_generator
from ..ops.common import BNStats
from .mesh import DATA_AXIS, Mesh


def data_seed(seed: int, data_index: int) -> int:
    """The dropout seed of a data rank: ``seed`` itself at data rank 0, so
    one process draws what the single-device trainer draws."""
    return seed + 1_000_003 * data_index


def unwrap(model: nn.Module) -> nn.Module:
    """The module a DistributedDataParallel wraps (or ``model``)."""
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


def distribute(model: nn.Module, mesh: Mesh,
               seed: Optional[int] = None) -> DistributedDataParallel:
    """``model`` (on this process's device) wrapped for the mesh: DDP over
    every process, BatchNorm statistics local to each (no buffer
    broadcast); with ``seed`` its dropouts draw from a generator of this
    data rank (:func:`data_seed`)."""
    dev = next(model.parameters()).device
    if seed is not None:
        set_dropout_generator(model, torch.Generator(device=dev).manual_seed(
            data_seed(seed, mesh.axis(DATA_AXIS).index)))
    with warnings.catch_warnings():
        # newer releases deprecate broadcast_buffers for forward_sync_buffers,
        # which still syncs the buffers at construction; False is the
        # reference's rank-local statistics
        warnings.simplefilter("ignore", FutureWarning)
        return DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            process_group=mesh.world, broadcast_buffers=False)


def _mean_(tensors, group, size: int) -> None:
    """Average ``tensors`` in place over ``group`` (one all-reduce a
    dtype)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= size
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def running_stats(model: nn.Module):
    """Every BatchNorm's running mean and variance (a ``ConvBN3d``'s
    too: every :class:`BNStats` that keeps them; a ``ConvBN3d`` built
    ``with_bn=False`` keeps none)."""
    return [b for m in model.modules()
            if isinstance(m, BNStats) and hasattr(m, "running_mean")
            for b in (m.running_mean, m.running_var)]


def _train_step_fn(mesh: Mesh, compute_dtype: Optional[str], jp: bool):
    data = mesh.axis(DATA_AXIS)

    def step(model: DistributedDataParallel, opt, sched,
             batch: Mapping) -> Dict[str, torch.Tensor]:
        if jp and unwrap(model).backbone.graph_axis is None:
            raise ValueError("the joint-partitioned step needs a backbone "
                             "built with graph_axis")
        metrics = train_step(model, opt, sched, batch, compute_dtype)
        with torch.no_grad():
            _mean_(running_stats(unwrap(model)), mesh.world,
                   mesh.world_size)
            names = sorted(metrics)
            m = torch.stack([metrics[k].to(metrics["loss"].dtype)
                             for k in names])
            _mean_([m], data.group, data.size)
        return dict(zip(names, m.unbind()))
    return step


def make_dp_train_step(mesh: Mesh, compute_dtype: Optional[str] = None):
    """(ddp_model, opt, sched, batch) -> metrics: the data-parallel step,
    ``batch`` this data rank's shard (JAX ``make_dp_train_step``)."""
    return _train_step_fn(mesh, compute_dtype, jp=False)


def make_jp_train_step(mesh: Mesh, compute_dtype: Optional[str] = None):
    """The same step over a (data x graph) mesh for a model whose backbone
    has ``graph_axis``: ``batch`` is the data rank's shard, the same on the
    graph ranks of a data row, each of which runs its block of the joints
    (JAX ``make_jp_train_step``)."""
    return _train_step_fn(mesh, compute_dtype, jp=True)


def _eval_fn(mesh: Mesh):
    data = mesh.axis(DATA_AXIS)

    @torch.no_grad()
    def fwd(model: nn.Module, keypoint) -> torch.Tensor:
        n = keypoint.shape[0]
        if n % data.size:
            raise ValueError(f"the eval batch ({n}) must be a multiple of "
                             f"the data axis ({data.size})")
        rows = n // data.size
        logits = eval_step(unwrap(model),
                           keypoint[data.index * rows:(data.index + 1)
                                    * rows])
        parts = [torch.empty_like(logits) for _ in range(data.size)]
        dist.all_gather(parts, logits.contiguous(), group=data.group)
        return torch.cat(parts)
    return fwd


def make_dp_eval_step(mesh: Mesh):
    """(model, keypoint) -> logits of the whole batch on every process;
    each data rank scores its rows (JAX ``make_dp_eval_step``)."""
    return _eval_fn(mesh)


def make_jp_eval_step(mesh: Mesh):
    """The eval step of a ``graph_axis`` model: each data row's graph ranks
    score its rows together (JAX ``make_jp_eval_step``)."""
    return _eval_fn(mesh)
