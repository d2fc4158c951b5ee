"""The block planners of K5 and K6 (``dsgcn_tpu_torch/ops/kernels/
dyn_graph.py:eval_plan``, ``dggcn_block.py:block_plan``): host logic only,
no JAX, no model, no card.

A K5 or K6 block takes a tile of TT whole frames of one sample: R joint
rows, TT*V padded to the warps' 32-row tiles (two of the MMA's 16-row
tiles), with the 16 warps in a grid of R / 32 row groups.  It walks K*Cm
in chunks of CH channels that lie inside one subset or cover whole
subsets.  K6's grid is (ceil(T / TT), N), K5's (K*Cm / CH, ceil(T / TT),
N).  Every (frame, channel) must fall in exactly one (tile, chunk), no
tile may be empty, and the block must fit the card's shared memory, its
threads and the accumulator tiles a warp holds in registers.
"""
import pytest

from chip_smoke import DG_BLOCKS, DG_K, DS_BLOCKS, K, N_BLOCK, V, distinct
from dsgcn_tpu_torch.ops.kernels import _build
from dsgcn_tpu_torch.ops.kernels.dggcn_block import block_plan, block_smem
from dsgcn_tpu_torch.ops.kernels.dyn_graph import (eval_block, eval_plan,
                                                   pw_tiles)

BLOCK_SMEM = 232448
MAX_THREADS = 1024
# (C in, C out, K, mid, T at the GCN): every distinct serving block of
# DG-STGCN (K = 8) and DS-GCN (K = 3) at b64 x M2 x T100
K6_SHAPES = ([(C, Co, DG_K, Cm, T) for (C, Co, Cm, T), _ in distinct(DG_BLOCKS)]
             + [(C, Co, K, Cm, T) for (C, Co, Cm, T), _ in distinct(DS_BLOCKS)])
K5_SHAPES = [(C, Cm, T) for (C, _, Cm, T), _ in distinct(DG_BLOCKS)]


def _check_tiles(T, Vj, TT, R):
    """Whole frames a tile, rows padded to the warps' tiles, every frame in
    exactly one tile and no tile empty."""
    assert 1 <= TT <= T and TT * Vj <= R
    assert R % _build.PW_WARP_ROWS == 0 and R % 16 == 0
    assert (_build.PW_THREADS // 32) % (R // _build.PW_WARP_ROWS) == 0
    # the smallest row count that holds the tile's frames
    assert R == _build.PW_WARP_ROWS or R // 2 < TT * Vj
    seen = [0] * T
    for x in range(-(-T // TT)):
        t0, t1 = x * TT, min(T, (x + 1) * TT)
        assert t1 > t0, f"tile {x} has no frames"
        for t in range(t0, t1):
            seen[t] += 1
    assert seen == [1] * T


def _check_chunks(Kk, Cm, CH):
    """Chunks inside one subset or over whole subsets, each channel once."""
    KC = Kk * Cm
    assert KC % CH == 0 and (Cm % CH == 0 or CH % Cm == 0)
    seen = [0] * KC
    for q0 in range(0, KC, CH):
        k0 = q0 // Cm
        subsets = {(q0 + c) // Cm for c in range(CH)}
        assert subsets == set(range(k0, k0 + max(1, CH // Cm)))
        for c in range(q0, q0 + CH):
            seen[c] += 1
    assert seen == [1] * KC


@pytest.mark.parametrize("xsize", [4, 2])
@pytest.mark.parametrize("C,Cout,Kk,Cm,T", K6_SHAPES)
def test_k6_plan_tiles_whole_frames_and_fits(C, Cout, Kk, Cm, T, xsize):
    TT, R, CH, share = block_plan(N_BLOCK, T, V, C, Kk, Cm, Cout, xsize,
                                  C != Cout)
    _check_tiles(T, V, TT, R)
    _check_chunks(Kk, Cm, CH)
    smem = block_smem(V, C, Kk, Cm, Cout, xsize, R, CH)
    assert 0 < smem <= BLOCK_SMEM
    assert _build.PW_THREADS <= MAX_THREADS
    assert pw_tiles(R, Cout) <= _build.K6_OUT_TILES
    assert pw_tiles(R, CH) <= _build.K6_PRE_TILES
    # the graph entries a tile builds: a share of its clocks the planner
    # keeps below half
    assert 0 < share < 0.5


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("C,Cm,T", K5_SHAPES)
def test_k5_plan_tiles_whole_frames_and_fits(C, Cm, T, esize):
    TT, R, CH = eval_plan(N_BLOCK, T, V, C, DG_K, Cm, esize)
    _check_tiles(T, V, TT, R)
    _check_chunks(DG_K, Cm, CH)
    smem = eval_block(V, C, DG_K, Cm, esize, R, CH)
    assert 0 < smem <= BLOCK_SMEM
    assert pw_tiles(R, CH) <= _build.K5_PRE_TILES


@pytest.mark.parametrize("Vj", [1, 18, 25, 32])
@pytest.mark.parametrize("T", [1, 7, 12, 25])
def test_plans_for_ragged_lengths_and_other_joint_counts(T, Vj):
    """Lengths the tiles do not divide, one frame, and other joint counts
    (K6 with the down path, K5)."""
    TT, R, CH, _ = block_plan(3, T, Vj, 64, 8, 16, 128, 4, True)
    _check_tiles(T, Vj, TT, R)
    _check_chunks(8, 16, CH)
    assert 0 < block_smem(Vj, 64, 8, 16, 128, 4, R, CH) <= BLOCK_SMEM
    TT, R, CH = eval_plan(3, T, Vj, 64, 8, 16, 2)
    _check_tiles(T, Vj, TT, R)
    _check_chunks(8, 16, CH)
    assert 0 < eval_block(Vj, 64, 8, 16, 2, R, CH) <= BLOCK_SMEM


def test_k6_refuses_naming_the_limit():
    """An x tile over shared memory at the fewest rows, and an out
    accumulator over the registers a block has, raise before any launch."""
    with pytest.raises(ValueError, match="shared memory"):
        block_plan(1, 2, V, 2048, 3, 8, 64, 4, True)
    with pytest.raises(ValueError, match="output channels"):
        block_plan(1, 2, V, 64, 3, 8, 2048, 4, True)


def test_k5_refuses_naming_the_limit():
    with pytest.raises(ValueError, match="input channels.*shared memory"):
        eval_plan(1, 2, V, 4096, 3, 8, 4)
