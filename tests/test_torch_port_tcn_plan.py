"""K7's block planner (``dsgcn_tpu_torch/ops/kernels/ms_tcn.py:tile_plan``
and its ranking ``tile_plans``): host logic only, no JAX, no model, no
card.

A K7 block takes one sample, a tile of TO output frames and a group of JR
joints, rows ordered (frame, joint); the pseudo-joint's blocks (``mean``)
take one row a frame.  Its products run over the block's rows padded to
the warps' 32-row tiles, at most PW_THREADS / 32 of them; its input frames
are the tile's frames times the stride and a halo of pad frames on each
side, those inside [0, T) staged.  The grid is (ceil(Tp / TO), ceil(V /
JR), N): every output frame and joint must fall in exactly one block, no
block may be empty, and the block, laid out by ``_build.py``'s geometry,
must fit the card's shared memory.
"""
import pytest

from chip_smoke import N_BLOCK, TCN_SHAPES, V
from dsgcn_tpu_torch.ops.kernels import _build
from dsgcn_tpu_torch.ops.kernels.ms_tcn import (MAX_ROWS, conv_out_len,
                                                tile_layout, tile_plan,
                                                tile_plans, tile_smem)

PAD = 4                      # max(DEFAULT_MS_CFG's dilations)
BLOCK_SMEM = 232448          # a block's shared memory on the H100


def _widths(C):
    mid = C // 6
    return C - 5 * mid, mid


def _check(N, T, Vj, C, rem, mid, stride, xsize, mean):
    Tp, Cp = conv_out_len(T, stride), rem + 5 * mid
    TO, JR = tile_plan(N, T, Vj, C, rem, mid, stride, PAD, xsize, mean=mean)
    if mean:
        assert JR == 1
    assert 1 <= TO <= Tp and 1 <= JR <= Vj
    # the block's shared memory from _build.py's geometry, and its
    # products within the block's warps
    smem = tile_smem(T, Cp, rem, mid, stride, PAD, TO, JR,
                     4 if mean else xsize)
    nbytes, RI, RO = tile_layout(T, Cp, rem, mid, stride, PAD, TO, JR,
                                 4 if mean else xsize)
    assert 0 < smem == nbytes <= BLOCK_SMEM
    assert RI % _build.PW_WARP_ROWS == 0 and RO % _build.PW_WARP_ROWS == 0
    assert MAX_ROWS == _build.PW_WARP_ROWS * _build.PW_THREADS // 32
    assert max(RI, RO) <= MAX_ROWS
    # every output frame and joint in exactly one block, none empty
    seen = [[0] * Vj for _ in range(Tp)]
    for bx in range(-(-Tp // TO)):
        t0, t1 = bx * TO, min(Tp, (bx + 1) * TO)
        assert t1 > t0
        for by in range(1 if mean else -(-Vj // JR)):
            v0, v1 = (0, Vj) if mean else (by * JR, min(Vj, (by + 1) * JR))
            assert v1 > v0
            # the staged input frames: inside [0, T), and every frame a
            # tap, the maxpool or the strided 1x1 reads
            a = max(t0 * stride - PAD, 0)
            b = min((t1 - 1) * stride + PAD, T - 1)
            assert b >= a and (b - a + 1) * (1 if mean else v1 - v0) <= RI
            for t in range(t0, t1):
                for d in (1, 2, 3, 4):
                    for q in (-1, 0, 1):
                        f = t * stride + q * d
                        assert f < 0 or f >= T or a <= f <= b
                for v in range(v0, v1):
                    seen[t][v] += 1
    if mean:
        assert all(row == [1] * Vj for row in seen)
    else:
        assert seen == [[1] * Vj for _ in range(Tp)]
    return TO, JR


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("xsize", [4, 2])
@pytest.mark.parametrize("C,T,stride", [s[:3] for s in TCN_SHAPES])
def test_plan_fits_and_covers_the_serving_shapes(C, T, stride, xsize, mean):
    """Every temporal unit of STGCN++ and DG-STGCN serving (N = 128): the
    joints' blocks in f32 and bf16, the pseudo-joint's blocks (f32)."""
    _check(N_BLOCK, T, V, C, *_widths(C), stride, xsize, mean)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("T", [1, 2, 7, 23, 37, 101])
def test_plan_odd_lengths_and_stride_two(T, stride):
    """Lengths the tiles do not divide, one frame, a halo past both ends of
    the sequence, stride 2 with odd T."""
    for mean in (False, True):
        _check(3, T, V, 64, *_widths(64), stride, 4, mean)


@pytest.mark.parametrize("Vj", [1, 18, 32])
def test_plan_other_joint_counts(Vj):
    """Joint groups that do not divide the joints."""
    _check(5, 30, Vj, 128, *_widths(128), 2, 2, False)


@pytest.mark.parametrize("C,rem,mid", [(30, 5, 5), (45, 10, 7), (93, 18, 15)])
def test_plan_odd_widths(C, rem, mid):
    """Branch widths and C' that are no multiple of 8."""
    _check(2, 17, V, C, rem, mid, 1, 4, False)
    _check(2, 17, V, C, rem, mid, 2, 2, True)


@pytest.mark.parametrize("C,T,stride", [s[:3] for s in TCN_SHAPES])
def test_ranked_plans_all_fit_and_start_with_the_plan(C, T, stride):
    """``tile_plans`` (what ``chip_smoke.py --sweep-blocks`` times) ranks
    distinct plans that all fit the card, the planner's own first."""
    rem, mid = _widths(C)
    plans = tile_plans(N_BLOCK, T, V, C, rem, mid, stride, PAD, 4)
    assert plans[0] == tile_plan(N_BLOCK, T, V, C, rem, mid, stride, PAD, 4)
    assert len(set(plans)) == len(plans) > 1
    assert _build.BLOCK_SMEM == BLOCK_SMEM
    for TO, JR in plans:
        assert 0 < tile_smem(T, C, rem, mid, stride, PAD, TO, JR,
                             4) <= BLOCK_SMEM


def test_plan_prefers_fewer_halo_frames():
    """Where a whole sample's frames fit a block, the planner does not cut
    them into short tiles that recompute the halo's pre (C = 64, T = 100:
    at least half of the frames a tile)."""
    TO, _ = tile_plan(N_BLOCK, 100, V, 64, *_widths(64), 1, PAD, 4)
    assert TO >= 50


def test_refuses_naming_the_limit():
    """A width no block holds at the fewest rows raises before any launch,
    naming shared memory; the smallest plan's bytes are in the message."""
    with pytest.raises(ValueError, match="shared memory"):
        tile_plan(1, 4, V, 8, 1500, 300, 1, PAD, 4)
    assert tile_smem(4, 3000, 1500, 300, 1, PAD, 1, 1, 4) > BLOCK_SMEM


def test_layout_counts_rows_over_the_limit_as_refused():
    """A plan over MAX_ROWS rows a product is refused (0), as the kernel's
    ``dsgcn_ms_tcn_geometry`` refuses it."""
    assert tile_smem(100, 64, 14, 10, 1, PAD, 100, 25, 4) == 0
