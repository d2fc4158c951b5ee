"""The block planner of K1 and K3 (``dsgcn_tpu_torch/ops/kernels/
dyn_graph.py:agg_plan``): host logic only, no JAX, no model, no card.

The kernels' grid (``csrc/graph_agg_tiled.cuh``) is (ceil(T / rows),
K * Cm / CG, N): block (x, y) takes rows [x * rows, min(T, (x + 1) * rows))
of subset y // (Cm / CG), channels (y % (Cm / CG)) * CG onward.  Every
(row, subset channel) must fall in exactly one block, no block may be
empty, and the block must fit the card's threads and shared memory.
"""
import re

import numpy as np
import pytest

from dsgcn_tpu_torch.ops.kernels import _build
from dsgcn_tpu_torch.ops.kernels.dyn_graph import (agg_block,
                                                   agg_joint_bound, agg_plan)

BLOCK_SMEM = 227 * 1024
# (N, K, Cm, T): DS-GCN serving (K3, N = 128) and training (K1, N = 256),
# DG-STGCN serving and training (K1, K = 8)
DSGCN = [(128, 3, c, t) for c, t in
         [(8, 100), (16, 100), (16, 50), (32, 50), (32, 25)]] + \
        [(256, 3, c, t) for c, t in
         [(8, 60), (16, 60), (16, 30), (32, 30), (32, 15)]]
DGSTGCN = [(128, 8, c, t) for c, t in [(16, 100), (32, 100), (32, 50),
                                      (64, 50), (64, 25)]] + \
          [(256, 8, c, t) for c, t in
           [(16, 60), (32, 60), (32, 30), (64, 30), (64, 15)]]


def _coverage(T, K, Cm, CG, rows):
    """How often each (row, subset channel) is taken, over the grid."""
    seen = np.zeros((T, K * Cm), np.int64)
    ncg = Cm // CG
    for x in range(-(-T // rows)):
        t0, t1 = x * rows, min(T, (x + 1) * rows)
        assert t1 > t0, f"block {x} has no rows"
        for y in range(K * ncg):
            k, c0 = y // ncg, (y % ncg) * CG
            seen[t0:t1, k * Cm + c0:k * Cm + c0 + CG] += 1
    return seen


def _fits(V, Cm, CG, esize):
    threads, smem = agg_block(V, Cm, CG, esize)
    return threads <= _build.AGG_MAX_THREADS and smem <= BLOCK_SMEM


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("V", [25, 32])
@pytest.mark.parametrize("N,K,Cm,T", DSGCN + DGSTGCN)
def test_plan_covers_each_row_and_channel_once(N, K, Cm, T, V, esize):
    CG, rows = agg_plan(N, T, V, K, Cm, esize)
    assert Cm % CG == 0 and 1 <= rows <= T
    assert _fits(V, Cm, CG, esize)
    assert (_coverage(T, K, Cm, CG, rows) == 1).all()


@pytest.mark.parametrize("Cm,esize", [(8, 4), (32, 2), (64, 4), (12, 4),
                                      (6, 2), (1, 4)])
def test_plan_covers_every_length(Cm, esize):
    """T from 1 up (a clip shorter than a ring stage included), at widths
    that do and do not give 16-byte channel runs."""
    for T in list(range(1, 18)) + [25, 31, 60, 99, 100, 257]:
        for N in (1, 128):
            CG, rows = agg_plan(N, T, 25, 3, Cm, esize)
            assert _fits(25, Cm, CG, esize)
            assert (_coverage(T, 3, Cm, CG, rows) == 1).all(), (T, N)


@pytest.mark.parametrize("V", [1, 16, 17, 25, 26, 32])
def test_joint_bound_holds_every_joint(V):
    """The kernel's compile-time joint bound is at least V, and a block's
    threads (CG channels x ceil(V / WN) joint groups) hold every
    destination joint."""
    VB, WN = agg_joint_bound(V)
    assert V <= VB <= 32 and VB * WN <= 100
    CG, _ = agg_plan(4, 10, V, 3, 16, 4)
    assert -(-V // WN) * WN >= V
    assert _fits(V, 16, CG, 4)


def test_block_geometry_has_one_source():
    """The tiled kernels take their block geometry from the build's -D
    flags, which the planner's constants make: every geometry macro the
    header reads is defined by the flags, and no other."""
    header = (_build.CSRC / "graph_agg_tiled.cuh").read_text()
    read = set(re.findall(r"\bDSGCN_AGG_\w+", header))
    defined = {f[2:].split("=")[0] for f in _build.NVCC_FLAGS
               if f.startswith("-DDSGCN_AGG_")}
    assert read == defined
    flags = dict(f[2:].split("=") for f in _build.NVCC_FLAGS
                 if f.startswith("-DDSGCN_AGG_"))
    assert int(flags["DSGCN_AGG_ROWS"]) == _build.AGG_ROWS
    for VB, WN in _build.AGG_JOINTS_PER_THREAD.items():
        assert agg_joint_bound(VB) == (VB, WN)
        assert int(flags[f"DSGCN_AGG_WN{VB}"]) == WN
