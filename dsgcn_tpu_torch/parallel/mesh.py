"""Process groups and the (data x graph) mesh (port of
``dsgcn_tpu/parallel/mesh.py``).

The JAX package drives every chip of a host from one process and names its
mesh axes; here each process drives one device, as ``torch.distributed.run``
launches it (one process a GPU), and the axes are process groups of a
``DeviceMesh`` of shape (n_data, n_graph).  Ranks are laid out row-major, so
a graph group is consecutive ranks: the processes of one host under
``torchrun``, with hosts contiguous along the data axis (JAX's
``make_multihost_mesh`` layout).

:func:`make_mesh` makes its mesh the current one, and a unit built with
``graph_axis='graph'`` resolves that name to the current mesh's process
group when it runs (:func:`axis`), as a JAX module's named axis resolves
inside ``shard_map``.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

DATA_AXIS = "data"
GRAPH_AXIS = "graph"


def local_rank() -> int:
    """The launcher's ``LOCAL_RANK`` (0 without one)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(backend: Optional[str] = None, device=None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group the launcher describes and return this
    process's device.

    ``torch.distributed.run`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
    and ``MASTER_ADDR``/``MASTER_PORT``; ``init_method``, ``rank`` and
    ``world_size`` override them (a ``file://`` store needs no port).  The
    device is ``cuda:LOCAL_RANK`` unless ``device`` names another; the
    backend is ``backend``, else ``nccl`` for a CUDA device and ``gloo`` for
    the CPU.  NCCL is refused on a CPU device, and nothing falls back to
    another backend."""
    dev = (torch.device("cuda", local_rank()) if device is None
           else torch.device(device))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (with the gloo backend) to run "
                               "on the CPU")
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method,
        rank=int(os.environ.get("RANK", 0)) if rank is None else rank,
        world_size=(int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                    else world_size))
    return dev


class Axis(NamedTuple):
    """One mesh axis as this process sees it."""
    group: dist.ProcessGroup
    size: int
    index: int


class Mesh:
    """The (data x graph) ``DeviceMesh`` of the process group.

    ``shape`` maps the axis names to their sizes; :meth:`axis` gives this
    process's group, the axis size and its index along it; ``world`` is a
    group of every rank of its own, for DistributedDataParallel's gradient
    reduction, so the units' collectives never share a group with it."""

    def __init__(self, n_data: int, n_graph: int):
        world = dist.get_world_size()
        if n_data * n_graph != world:
            raise ValueError(f"a ({n_data}, {n_graph}) mesh needs "
                             f"{n_data * n_graph} processes; the group has "
                             f"{world}")
        # a mesh's device type is its backend's: NCCL meshes are CUDA
        # meshes; a gloo mesh is a CPU mesh, whatever tensors it carries
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(
            device_type, (n_data, n_graph),
            mesh_dim_names=(DATA_AXIS, GRAPH_AXIS))
        self.shape = {DATA_AXIS: n_data, GRAPH_AXIS: n_graph}
        self.world = dist.new_group(list(range(world)))
        self.world_size = world

    def axis(self, name: str) -> Axis:
        return Axis(self.device_mesh.get_group(name), self.shape[name],
                    self.device_mesh.get_local_rank(name))


_CURRENT: Optional[Mesh] = None


def make_mesh(n_data: Optional[int] = None, n_graph: int = 1) -> Mesh:
    """The (data, graph) mesh over the initialized process group, every
    process on the data axis by default; it becomes the current mesh."""
    global _CURRENT
    world = dist.get_world_size()
    if n_data is None:
        if world % n_graph:
            raise ValueError(f"n_graph={n_graph} does not divide the "
                             f"{world} processes")
        n_data = world // n_graph
    _CURRENT = Mesh(n_data, n_graph)
    return _CURRENT


def current_mesh() -> Mesh:
    if _CURRENT is None:
        raise RuntimeError("no mesh: call dsgcn_tpu_torch.parallel.mesh."
                           "make_mesh() after init_distributed()")
    return _CURRENT


def axis(name: str) -> Axis:
    """The current mesh's axis ``name`` (what a unit's ``graph_axis``
    names)."""
    return current_mesh().axis(name)


def release_mesh() -> None:
    """Forget the current mesh (before the process group is destroyed)."""
    global _CURRENT
    _CURRENT = None
