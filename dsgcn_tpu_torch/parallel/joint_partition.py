"""Joint-partition (graph-axis) parallelism (port of
``dsgcn_tpu/parallel/joint_partition.py``) and the collectives the
joint-partitioned units differentiate through.

The skeleton's joints are split over the graph axis: each process holds a
contiguous block of V / G joints.  The dense dynamic graphs make the
aggregation all-to-all in the joints, so it runs as a ring: each process
contracts the source-joint block it holds against its output columns while
it passes that block on to its ring neighbour (:func:`ring_permute`, the
transfer started before the contraction and waited after it, as JAX issues
its ``ppermute`` first).  The chunk contraction is a ``torch.einsum``, as JAX
leaves it to XLA outside any Pallas kernel.

Gradients follow JAX's transposes: an all-reduce's cotangents are summed
over the group, an all-gather's are summed and each process keeps its block,
a ring step's go back the other way.  With every process seeding its own
copy of the (replicated) loss, a parameter's gradient summed over the graph
group is G times the true one, so the data-parallel wrapper's mean over all
processes is exact (``parallel/train.py``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import GRAPH_AXIS, axis


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """psum over ``group``, differentiable (its cotangents psummed too)."""
    return _AllReduceSum.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        size = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.rank = group, dim, dist.get_rank(group)
        ctx.width = x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        # psum_scatter: sum the cotangents, keep this process's block
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank order
    (JAX ``all_gather(..., tiled=True)``), differentiable."""
    return _AllGather.apply(x, group, dim % x.dim())


def _exchange(x: torch.Tensor, group, shift: int, out: torch.Tensor):
    """Start sending ``x`` to group rank (r - shift) mod G and receiving
    ``out`` from (r + shift) mod G; returns the requests."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    to = dist.get_global_rank(group, (rank - shift) % size)
    frm = dist.get_global_rank(group, (rank + shift) % size)
    return dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                   dist.P2POp(dist.irecv, out, frm, group)])


class _RingRecv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, transfer):
        ctx.group, ctx.size = transfer.group, transfer.size
        return transfer.finish()

    @staticmethod
    def backward(ctx, g):
        if ctx.size == 1:
            return g, None
        g = g.contiguous()
        out = torch.empty_like(g)
        for req in _exchange(g, ctx.group, -1, out):
            req.wait()
        return out, None


class RingTransfer:
    """One ring step of ``x`` in flight: started at construction, ended by
    :meth:`wait`, which returns the neighbour's block (differentiable)."""

    def __init__(self, x: torch.Tensor, group):
        self.x, self.group = x, group
        self.size = dist.get_world_size(group)
        self.reqs = []
        if self.size > 1:
            if x.is_cuda and dist.get_backend(group) == "gloo":
                # gloo hands the device pointer to its TCP transport: the
                # send aborts the process (chip_smoke.py --parallel)
                raise RuntimeError("ring_permute: gloo cannot send CUDA "
                                   "tensors; run the graph axis over NCCL")
            self.sent = x.detach().contiguous()
            self.out = torch.empty_like(self.sent)
            self.reqs = _exchange(self.sent, group, 1, self.out)
            ring_permute.bytes_sent += self.sent.numel() * \
                self.sent.element_size()

    def finish(self) -> torch.Tensor:
        if self.size == 1:
            return self.x.detach().clone()
        for req in self.reqs:
            req.wait()
        return self.out

    def wait(self) -> torch.Tensor:
        return _RingRecv.apply(self.x, self)


def ring_permute(x: torch.Tensor, group) -> RingTransfer:
    """Start the ring step of JAX's ``ppermute`` with the permutation
    j -> (j - 1) mod G: send ``x`` to the previous rank of ``group``,
    receive the next rank's block (one ``batch_isend_irecv``).  Returns the
    transfer; its ``wait()`` gives the received block, whose gradient goes
    back the other way.  ``ring_permute.bytes_sent`` counts the bytes this
    process has sent forward."""
    return RingTransfer(x, group)


ring_permute.bytes_sent = 0


def pad_to_multiple(V: int, shards: int) -> int:
    return ((V + shards - 1) // shards) * shards


def pad_joints(x: torch.Tensor, shards: int, axis: int) -> torch.Tensor:
    """Zero-pad the joint axis to a multiple of ``shards``."""
    axis %= x.dim()
    V = x.shape[axis]
    Vp = pad_to_multiple(V, shards)
    if Vp == V:
        return x
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, Vp - V]
    return F.pad(x, pads)


def pad_adjacency(A: torch.Tensor, shards: int) -> torch.Tensor:
    """Zero-pad (K, V, V) adjacency on both joint axes."""
    V = A.shape[-1]
    Vp = pad_to_multiple(V, shards)
    return A if Vp == V else F.pad(A, (0, Vp - V, 0, Vp - V))


def ring_spatial_aggregate(x_shard: torch.Tensor, A: torch.Tensor,
                           axis_name: str = GRAPH_AXIS) -> torch.Tensor:
    """Distributed y[.., w, c] = sum_k sum_v x[.., v, k, c] A[k, v, w].

    ``x_shard``: (..., Vg, K, C), this process's source-joint rows (joint
    axis third from last); ``A``: the whole padded (K, Vp, Vp) adjacency.
    Returns this process's output-joint columns (..., Vg, C): at ring step
    i it holds the rows of process (g + i) mod G, starts passing them on,
    contracts them against its columns' rows of A, then takes the next
    block.  Accumulates in at least float32, cast once at the end."""
    ax = axis(axis_name)
    G, g = ax.size, ax.index
    Vg = x_shard.shape[-3]
    acc = torch.promote_types(x_shard.dtype, torch.float32)
    A_cols = A[:, :, g * Vg:(g + 1) * Vg]                      # (K, Vp, Vg)
    y = x_shard.new_zeros(x_shard.shape[:-3] + (Vg, x_shard.shape[-1]),
                          dtype=acc)
    cur = x_shard
    for i in range(G):
        src = (g + i) % G
        rows = A_cols[:, src * Vg:(src + 1) * Vg].to(acc)     # (K, Vg, Vg)
        nxt = ring_permute(cur, ax.group)
        y = y + torch.einsum("...vkc,kvw->...wc", cur.to(acc), rows)
        cur = nxt.wait()
    return y.to(x_shard.dtype)


def jp_unit_gcn_forward(x: torch.Tensor, A: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor,
                        axis_name: str = GRAPH_AXIS) -> torch.Tensor:
    """Joint-partitioned unit_gcn 'pre' spatial conv: ``x`` (N, T, Vg,
    C_in) source-joint shard, the pre 1x1 as ``F.linear``'s (K C_out, C_in)
    ``weight`` and ``bias``; returns the (N, T, Vg, C_out) output-joint
    shard."""
    K = A.shape[0]
    h = F.linear(x, weight, bias)
    n, t, vg, _ = h.shape
    return ring_spatial_aggregate(h.reshape(n, t, vg, K, -1), A, axis_name)


def edges_per_second(V: int, K: int, batch: int, T: int,
                     seconds: float) -> float:
    """Edges/s: every (k, v, w) pair processed per (batch, frame)."""
    return batch * T * K * V * V / seconds


def jp_comm_volume(n: int, t: int, V: int, K: int, mid: int, G: int,
                   itemsize: int = 4) -> Dict[str, int]:
    """What one process sends in one joint-partitioned DG block's forward
    (the ring of ``DGGCN._jp_aggregate``):

    * ``allgather_bytes``: its share of the (N, K, mid, V) queries x1,
      gathered once ((G - 1) / G of the tensor);
    * ``ppermute_bytes``: the (N, T, V/G, K, mid) value block, sent at each
      of the G ring steps (the last brings it home unused; it is issued all
      the same, as JAX issues it);
    * ``overlap_flops_per_hop``: the chunk contraction each transfer
      overlaps, 2 N T K mid (V/G)^2.

    The per-hop intensity is (V/G)/2 FLOP per byte whatever N, T, K and
    mid: the graph axis buys per-process activation memory (1/G) and a
    second scaling axis, not hidden communication."""
    vl = V // G
    return dict(allgather_bytes=n * K * mid * (V - vl) * itemsize,
                ppermute_bytes=n * t * vl * K * mid * G * itemsize,
                overlap_flops_per_hop=2 * n * t * K * mid * vl * vl)
