"""The block planner of K2, the dynamic-graph backward
(``dsgcn_tpu_torch/ops/kernels/dyn_graph.py:bwd_plan``): host logic only,
no JAX, no model, no card.

The contraction kernel's grid (``csrc/dyn_graph_bwd.cu``) is (ceil(T /
rows), K * Cm / CG, N): block (x, y) takes rows [x * rows, min(T, (x + 1) *
rows)) of subset y // (Cm / CG), channels (y % (Cm / CG)) * CG onward, and
writes its partial sums to slice x * (Cm / CG) + y % (Cm / CG) of its
subset.  Every (row, subset channel) must fall in exactly one block, no
block may be empty, every slice must be written once, and the block must
fit the card's threads and shared memory.
"""
import re

import numpy as np
import pytest

from dsgcn_tpu_torch.ops.kernels import _build
from dsgcn_tpu_torch.ops.kernels.dyn_graph import (bwd_block,
                                                   bwd_joint_bound, bwd_plan)

BLOCK_SMEM = 227 * 1024
E = 15
# (N, K, Cm, T, E): DS-GCN training (K = 3, the edge subset's E classes, and
# without it) and DG-STGCN training (K = 8, no edge subset)
DSGCN = [(256, 3, c, t, e) for c, t in
         [(8, 60), (16, 60), (16, 30), (32, 30), (32, 15)] for e in (E, 0)]
DGSTGCN = [(256, 8, c, t, 0) for c, t in
           [(16, 60), (32, 60), (32, 30), (64, 30), (64, 15)]]


def _coverage(T, K, Cm, CG, rows):
    """How often each (row, subset channel) is taken, and each partial-sum
    slice written, over the grid."""
    seen = np.zeros((T, K * Cm), np.int64)
    ncg = Cm // CG
    nrr = -(-T // rows)
    slices = np.zeros((K, nrr * ncg), np.int64)
    for x in range(nrr):
        t0, t1 = x * rows, min(T, (x + 1) * rows)
        assert t1 > t0, f"block {x} has no rows"
        for y in range(K * ncg):
            k, cg = y // ncg, y % ncg
            seen[t0:t1, k * Cm + cg * CG:k * Cm + (cg + 1) * CG] += 1
            slices[k, x * ncg + cg] += 1
    return seen, slices


def _fits(V, CG, esize, E_):
    threads, smem = bwd_block(V, CG, esize, E_)
    return threads <= _build.BWD_MAX_THREADS and smem <= BLOCK_SMEM


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("V", [25, 32])
@pytest.mark.parametrize("N,K,Cm,T,E_", DSGCN + DGSTGCN)
def test_plan_covers_each_row_and_channel_once(N, K, Cm, T, E_, V, esize):
    CG, rows = bwd_plan(N, T, V, K, Cm, esize, E_)
    assert Cm % CG == 0 and 1 <= rows <= T
    assert _fits(V, CG, esize, E_)
    seen, slices = _coverage(T, K, Cm, CG, rows)
    assert (seen == 1).all() and (slices == 1).all()


@pytest.mark.parametrize("Cm,esize,E_", [(8, 4, E), (32, 2, E), (64, 4, 0),
                                         (12, 4, 0), (6, 2, E), (1, 4, 0),
                                         (48, 4, E)])
def test_plan_covers_every_length(Cm, esize, E_):
    """T from 1 up (a clip shorter than a ring stage included), at small
    and full batches, which split T, and widths that do and do not give
    16-byte channel runs."""
    for T in list(range(1, 18)) + [25, 31, 60, 99, 100]:
        for N in (1, 256):
            CG, rows = bwd_plan(N, T, 25, 3, Cm, esize, E_)
            assert _fits(25, CG, esize, E_)
            seen, slices = _coverage(T, 3, Cm, CG, rows)
            assert (seen == 1).all() and (slices == 1).all(), (T, N)


def test_plan_splits_rows_where_the_grid_is_short():
    """A full DS-GCN batch takes all of T in one block; one sample splits
    T, so the card's SMs get blocks."""
    for Cm, T in [(8, 60), (16, 30), (32, 15)]:
        assert bwd_plan(256, T, 25, 3, Cm, 4, E)[1] == T
    CG, rows = bwd_plan(1, 60, 25, 3, 16, 4, E)
    assert rows < 60


def test_plan_is_the_same_for_the_same_inputs():
    """The plan is a function of the shapes alone (cached, and the same
    when recomputed)."""
    args = (256, 30, 25, 3, 32, 4, E)
    first = bwd_plan(*args)
    bwd_plan.cache_clear()
    assert bwd_plan(*args) == first == bwd_plan(*args)


@pytest.mark.parametrize("V", [1, 16, 17, 25, 26, 32])
def test_joint_bound_holds_every_joint(V):
    """The kernel's compile-time joint bound is at least V, a thread's two
    rows of VB floats (G's and dG's) a joint stay within the register
    budget, and a block's threads hold every source joint."""
    VB, WN = bwd_joint_bound(V)
    assert V <= VB <= 32 and 2 * VB * WN <= 100
    CG, _ = bwd_plan(4, 10, V, 3, 16, 4, E)
    assert -(-V // WN) * WN >= V
    assert _fits(V, CG, 4, E)


def test_block_geometry_has_one_source():
    """K2 takes its block geometry from the build's -D flags, which the
    planner's constants make: every geometry macro the source reads is
    defined by the flags, and no other."""
    source = (_build.CSRC / "dyn_graph_bwd.cu").read_text()
    read = set(re.findall(r"\bDSGCN_BWD_\w+", source))
    defined = {f[2:].split("=")[0] for f in _build.NVCC_FLAGS
               if f.startswith("-DDSGCN_BWD_")}
    assert read == defined
    flags = dict(f[2:].split("=") for f in _build.NVCC_FLAGS
                 if f.startswith("-DDSGCN_BWD_"))
    assert int(flags["DSGCN_BWD_MAX_THREADS"]) == _build.BWD_MAX_THREADS
    assert int(flags["DSGCN_BWD_ROWS"]) == _build.BWD_ROWS
    assert int(flags["DSGCN_BWD_STAGES"]) == _build.BWD_STAGES
    assert int(flags["DSGCN_BWD_MIN_BLOCKS"]) == _build.BWD_MIN_BLOCKS
    assert int(flags["DSGCN_BWD_DX_PARTS"]) == _build.BWD_DX_PARTS
    for VB, WN in _build.BWD_JOINTS_PER_THREAD.items():
        assert bwd_joint_bound(VB) == (VB, WN)
        assert int(flags[f"DSGCN_BWD_WN{VB}"]) == WN
