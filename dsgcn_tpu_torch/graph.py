"""Skeleton graph topology: layouts, partition modes, and semantic node/edge types.

The PyTorch port's own copy of ``dsgcn_tpu/graph.py`` (pure NumPy, so the port
imports nothing of the JAX package).  Behavioral parity with the reference's
``pyskl/utils/graph.py`` (Graph class at graph.py:58-187).  The graph is computed
once at model-construction time on the host; the model keeps what it produces
as parameters (``A``) or non-persistent buffers (node/edge types).

Outputs:
  * ``A``: (K, V, V) stack of adjacency subsets (float32).
  * ``node_type``: (V,) int array of body-part ids (5 parts), layouts nturgb+d/coco
    (reference graph.py:116, 135).
  * ``edge_type``: (V, V) int array with 15 distinct unordered-part-pair classes
    (reference graph.py:119-126 signed outer-product trick).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Graph", "GraphConfig", "k_adjacency", "edge2mat", "normalize_digraph",
           "get_hop_distance"]


def edge2mat(links: Sequence[Tuple[int, int]], num_node: int) -> np.ndarray:
    """Directed edge list -> adjacency with A[j, i] = 1 for each (i, j).

    Matches reference graph.py:19-23 (note the transposed convention: an entry
    (i, j) in the list sets column i, row j).
    """
    A = np.zeros((num_node, num_node))
    for i, j in links:
        A[j, i] = 1
    return A


def normalize_digraph(A: np.ndarray, dim: int = 0) -> np.ndarray:
    """Right-multiply by inverse column-degree: A @ D^-1 (reference graph.py:26-37)."""
    Dl = np.sum(A, dim)
    w = A.shape[1]
    Dn = np.zeros((w, w))
    for i in range(w):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** (-1)
    return np.dot(A, Dn)


def get_hop_distance(num_node: int, edges: Sequence[Tuple[int, int]],
                     max_hop: int = 1) -> np.ndarray:
    """BFS hop distance via boolean matrix powers (reference graph.py:40-55)."""
    A = np.eye(num_node)
    for i, j in edges:
        A[i, j] = 1
        A[j, i] = 1
    hop_dis = np.full((num_node, num_node), np.inf)
    transfer_mat = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive_mat = np.stack(transfer_mat) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive_mat[d]] = d
    return hop_dis


def k_adjacency(A: np.ndarray, k: int, with_self: bool = False,
                self_factor: float = 1) -> np.ndarray:
    """k-hop ring adjacency used by MS-G3D style multi-scale GCNs (reference graph.py:5-16)."""
    assert isinstance(A, np.ndarray)
    Iden = np.eye(len(A), dtype=A.dtype)
    if k == 0:
        return Iden
    Ak = (np.minimum(np.linalg.matrix_power(A + Iden, k), 1)
          - np.minimum(np.linalg.matrix_power(A + Iden, k - 1), 1))
    if with_self:
        Ak += self_factor * Iden
    return Ak


_LAYOUTS = {
    "openpose": dict(
        num_node=18,
        inward=[(4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11), (10, 9),
                (9, 8), (11, 5), (8, 2), (5, 1), (2, 1), (0, 1), (15, 0),
                (14, 0), (17, 15), (16, 14)],
        center=1,
        node_type=None,
    ),
    "nturgb+d": dict(
        num_node=25,
        # 1-indexed (child, parent) pairs from the NTU RGB+D kinematic tree
        # (reference graph.py:108-114), converted to 0-indexed below.
        inward=[(i - 1, j - 1) for (i, j) in
                [(1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
                 (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1),
                 (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
                 (20, 19), (22, 8), (23, 8), (24, 12), (25, 12)]],
        center=20,
        # 5 body parts: trunk / left arm / right arm / left leg / right leg
        # (reference graph.py:116).
        node_type=[0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
                   0, 1, 1, 2, 2],
    ),
    "coco": dict(
        num_node=17,
        inward=[(15, 13), (13, 11), (16, 14), (14, 12), (11, 5), (12, 6),
                (9, 7), (7, 5), (10, 8), (8, 6), (5, 0), (6, 0),
                (1, 0), (3, 1), (2, 0), (4, 2)],
        center=0,
        node_type=[0, 0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 3, 4, 3, 4, 3, 4],
    ),
    # MediaPipe 21-landmark hand: wrist 0, then 4 joints per finger
    # (thumb 1-4, index 5-8, middle 9-12, ring 13-16, pinky 17-20).
    # The gesture demo config (reference demo/stgcnpp_gesture.py:1) requires
    # layout 'handmp', which the reference fork's own Graph never defines
    # (graph.py:97-147 raises ValueError) — the demo is unusable as
    # committed; this is the upstream-pyskl hand tree it intends.
    "handmp": dict(
        num_node=21,
        inward=[(1, 0), (2, 1), (3, 2), (4, 3), (5, 0), (6, 5), (7, 6),
                (8, 7), (9, 0), (10, 9), (11, 10), (12, 11), (13, 0),
                (14, 13), (15, 14), (16, 15), (17, 0), (18, 17), (19, 18),
                (20, 19)],
        center=0,
        # 5 parts: thumb(+wrist) / index / middle / ring / pinky
        node_type=[0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                   4, 4, 4, 4],
    ),
}


def _semantic_edge_types(node_type: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Map each (source-part, target-part) pair to one of 15 edge classes.

    Reproduces the reference's signed outer-product trick (graph.py:119-126):
    index = (part+1) * (-1)^(part+1); the product index_i * index_j is unique per
    unordered part pair, and classes are assigned by ascending product value.
    """
    v = len(node_type)
    index = (np.array(node_type).reshape(v, 1) + 1).astype(np.int64)
    index = index * np.power(-1, index)
    prod = index @ index.T
    unique = np.unique(prod)
    edge_type = np.zeros((v, v))
    for i, u in enumerate(unique):
        edge_type[prod == u] = i
    return edge_type, unique


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Typed config for :class:`Graph` (mirrors reference graph_cfg dicts)."""
    layout: str = "coco"
    mode: str = "spatial"
    max_hop: int = 1
    nx_node: int = 1
    num_filter: int = 3
    init_std: float = 0.02
    init_off: float = 0.04
    seed: Optional[int] = None  # RNG seed for mode='random' (reference uses global RNG)


class Graph:
    """Skeleton graph with partitioned adjacency subsets and semantic typing.

    Modes (reference graph.py:151-187):
      * ``stgcn_spatial``: per-hop close/further partition w.r.t. the center joint.
      * ``spatial``: K=3 (identity, normalized inward, normalized outward).
      * ``binary_adj``: K=1 symmetric binary adjacency.
      * ``random``: K=num_filter matrices ~ N(init_off, init_std^2) — the trained-
        from-scratch initialization used by DG-STGCN / DS-GCN.
    """

    def __init__(self, layout: str = "coco", mode: str = "spatial", max_hop: int = 1,
                 nx_node: int = 1, num_filter: int = 3, init_std: float = 0.02,
                 init_off: float = 0.04, seed: Optional[int] = None):
        assert layout in _LAYOUTS, f"unknown layout {layout!r}"
        assert nx_node == 1 or mode == "random", "nx_node > 1 requires mode='random'"
        self.layout = layout
        self.mode = mode
        self.max_hop = max_hop
        self.nx_node = nx_node
        self.num_filter = num_filter
        self.init_std = init_std
        self.init_off = init_off
        self.seed = seed

        spec = _LAYOUTS[layout]
        self.num_node: int = spec["num_node"]
        self.inward: List[Tuple[int, int]] = list(spec["inward"])
        self.center: int = spec["center"]
        self.self_link = [(i, i) for i in range(self.num_node)]
        self.outward = [(j, i) for (i, j) in self.inward]
        self.neighbor = self.inward + self.outward

        if spec["node_type"] is not None:
            self.node_type = list(spec["node_type"])
            self.edge_type, self.edge_type_num = _semantic_edge_types(self.node_type)
        else:
            self.node_type = None
            self.edge_type = None
            self.edge_type_num = None

        self.hop_dis = get_hop_distance(self.num_node, self.inward, max_hop)

        builder = getattr(self, mode, None)
        if builder is None:
            raise ValueError(f"unknown mode {mode!r}")
        self.A = builder()

    @classmethod
    def from_config(cls, cfg: GraphConfig) -> "Graph":
        return cls(**dataclasses.asdict(cfg))

    # -- partition modes ---------------------------------------------------

    def stgcn_spatial(self) -> np.ndarray:
        adj = np.zeros((self.num_node, self.num_node))
        adj[self.hop_dis <= self.max_hop] = 1
        normalize_adj = normalize_digraph(adj)
        hop_dis = self.hop_dis
        center = self.center

        A = []
        for hop in range(self.max_hop + 1):
            a_close = np.zeros((self.num_node, self.num_node))
            a_further = np.zeros((self.num_node, self.num_node))
            for i in range(self.num_node):
                for j in range(self.num_node):
                    if hop_dis[j, i] == hop:
                        if hop_dis[j, center] >= hop_dis[i, center]:
                            a_close[j, i] = normalize_adj[j, i]
                        else:
                            a_further[j, i] = normalize_adj[j, i]
            A.append(a_close)
            if hop > 0:
                A.append(a_further)
        return np.stack(A)

    def spatial(self) -> np.ndarray:
        Iden = edge2mat(self.self_link, self.num_node)
        In = normalize_digraph(edge2mat(self.inward, self.num_node))
        Out = normalize_digraph(edge2mat(self.outward, self.num_node))
        return np.stack((Iden, In, Out))

    def binary_adj(self) -> np.ndarray:
        A = edge2mat(self.inward + self.outward, self.num_node)
        return A[None]

    def random(self) -> np.ndarray:
        num_node = self.num_node * self.nx_node
        rng = np.random.default_rng(self.seed) if self.seed is not None else np.random
        return (rng.standard_normal((self.num_filter, num_node, num_node))
                * self.init_std + self.init_off)
