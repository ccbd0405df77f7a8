"""K1's tiled route (ops/cuda/mac_sweep.py::sweep_tiling), pure Python on
the CPU.

The z-marching kernel of csrc/mac_sweep.cu takes its grid from the
wrapper: the xy tile's height and the output planes a block. Here that
tiling is checked at the shapes the port runs (128^3 with the 132 SMs of
an H100 SXM and the 114 of a PCIe card, the 6x64^3 training batch) and at
ragged ones, for windows 1 and 2, both tile heights and a few counts of
resident blocks an SM: every output cell is written by exactly one
(block, thread, plane) of the kernel's loop, whose ring of planes (mirrored
below) holds planes k - W .. k + W, landed, whenever it computes plane k;
no block's shared memory exceeds the card's limit; 128^3 and 6x64^3 fill
one wave. Last, the window guarantee the tiles rest on: the corners the
plain version's backtrace and BUILD_INDEX reach lie within W cells of
their cell on each axis, for velocities up to 1e6 and at the borders, up
to the longest axis the tiled route takes (MAX_TILED_EXTENT); past it
the float32 positions break the guarantee and the global route takes the
shape.
"""

import numpy as np
import pytest
import torch

from fluidnet_tpu_torch.ops.cuda.mac_sweep import (
    AHEAD, MAX_TILED_EXTENT, MIN_PLANES, TILE_X, TILE_YS, TILED_WINDOWS,
    _backtrace, _build_index, smem_bytes, sweep_route, sweep_tiling)

SMEM = 232448          # H100: the most shared memory a block may take

SHAPES = [((1, 3, 128, 128, 128), 132), ((1, 3, 128, 128, 128), 114),
          ((6, 3, 64, 64, 64), 132), ((6, 3, 64, 64, 64), 114),
          ((2, 3, 9, 13, 17), 132), ((2, 3, 37, 45, 61), 132),
          ((1, 3, 37, 45, 61), 114), ((1, 3, 33, 17, 70), 132)]
# Resident blocks an SM by tile height (the card reports its own).
RESIDENT = [{8: 1, 16: 1}, {8: 3, 16: 1}, {8: 4, 16: 2}]


def kernel_walk(shape, tiling, W):
    """The kernel's loop: how many times each output cell (b, z, y, x) is
    written. Block (bx, by, bz) takes batch item bz // ranges and planes
    [zs, ze); its thread (lx, ly) owns column (bx * TILE_X + lx,
    by * tile_y + ly) and writes it inside the domain. Planes
    zs - W .. ze + W - 1 load in order, one commit group each: R - 1
    before the loop (R = 2W + 1 + AHEAD ring slots), then at step k, after
    waiting until at most AHEAD - 1 groups are pending and the barrier,
    plane k + W + AHEAD into the slot of plane k - W - 1; step k reads
    planes k - W .. k + W."""
    B, _, Z, Y, X = shape
    ty, zc = tiling.tile_y, tiling.planes
    R = 2 * W + 1 + AHEAD
    ranges = -(-Z // zc)
    grid = (-(-X // TILE_X), -(-Y // ty), ranges * B)
    assert grid[0] * grid[1] * grid[2] == tiling.blocks
    assert tiling.threads == TILE_X * ty
    owners = np.zeros((B, Z, Y, X), np.int64)
    for bz in range(grid[2]):
        b, zs = bz // ranges, (bz % ranges) * zc
        ze = min(zs + zc, Z)
        p0, n_loads = zs - W, ze - zs + 2 * W
        assert n_loads == tiling.loads or ze - zs < zc
        ring = [None] * R      # the plane each slot holds
        groups = []            # the plane of each commit group, in order
        for r in range(R - 1):
            if r < n_loads:
                ring[r] = p0 + r
            groups.append(p0 + r if r < n_loads else None)
        s0 = 0
        for k in range(zs, ze):
            landed = {p for p in groups[:len(groups) - (AHEAD - 1)]}
            for e in range(2 * W + 1):
                q = (s0 + e) % R
                assert ring[q] == k - W + e and ring[q] in landed
            if k - zs + R - 1 < n_loads:
                q = (s0 - 1) % R
                assert ring[q] is None or ring[q] < k - W
                ring[q] = k + W + AHEAD
                groups.append(k + W + AHEAD)
            else:
                groups.append(None)
            for by in range(grid[1]):
                for bx in range(grid[0]):
                    owners[b, k, by * ty:min((by + 1) * ty, Y),
                           bx * TILE_X:min((bx + 1) * TILE_X, X)] += 1
            s0 = (s0 + 1) % R
    return owners


@pytest.mark.parametrize("W", TILED_WINDOWS)
@pytest.mark.parametrize("tile_y", TILE_YS)
@pytest.mark.parametrize("shape,n_sm", SHAPES)
def test_tiling_writes_every_cell_once(shape, n_sm, tile_y, W):
    for resident in RESIDENT:
        tiling = sweep_tiling(shape, W, n_sm, resident, True, True, tile_y)
        assert tiling.planes >= min(MIN_PLANES, shape[2])
        owners = kernel_walk(shape, tiling, W)
        assert owners.min() == 1 and owners.max() == 1


@pytest.mark.parametrize("W", TILED_WINDOWS)
def test_shared_memory_fits(W):
    """Every form's ring fits a block's shared memory; csrc/mac_sweep.cu's
    Ring<W, TY, IS_BWD, SCALAR> sizes: forward with the scalar 5 staged
    channels, backward 8, velocity-only 3 or 6."""
    for ty in TILE_YS:
        for is_bwd in (False, True):
            for scalar in (False, True):
                nc = 3 + 3 * is_bwd + 2 * scalar
                plane = (TILE_X + 2 * W) * (ty + 2 * W)
                assert smem_bytes(W, ty, is_bwd, scalar) == \
                    4 * (2 * W + 1 + AHEAD) * nc * plane <= SMEM
    assert smem_bytes(2, 16, True, True) == 138240


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("W", TILED_WINDOWS)
@pytest.mark.parametrize("shape,n_sm", SHAPES[:4])
def test_tiling_is_one_wave(shape, n_sm, W, resident):
    """128^3 and the 6x64^3 batch run in one wave of the resident blocks
    that fills at least 70% of it."""
    tiling = sweep_tiling(shape, W, n_sm, resident, False, True)
    slots = n_sm * resident[tiling.tile_y]
    assert 0.7 * min(slots, n_sm) <= tiling.blocks <= slots
    assert tiling.planes >= MIN_PLANES


def test_tiling_rejects_other_tile_heights_and_routes():
    with pytest.raises(ValueError):
        sweep_tiling((1, 3, 128, 128, 128), 1, 132, {12: 1}, True, True, 12)
    shape = (1, 3, 128, 128, 128)
    assert [sweep_route(w, shape) for w in (1, 2, 3, 5)] == \
        ["tiled", "tiled", "global", "global"]


def _grid(Z, Y, X):
    """The kernel's index-offset cell positions, (x, y, z)."""
    return (torch.arange(X, dtype=torch.float32).view(1, 1, 1, X),
            torch.arange(Y, dtype=torch.float32).view(1, 1, Y, 1),
            torch.arange(Z, dtype=torch.float32).view(1, Z, 1, 1))


@pytest.mark.parametrize("extent", [(7, 9, 11), (2, 2, MAX_TILED_EXTENT),
                                    (MAX_TILED_EXTENT, 2, 2)])
@pytest.mark.parametrize("ours", [False, True])
@pytest.mark.parametrize("W", TILED_WINDOWS)
def test_corners_lie_within_the_window(W, ours, extent):
    """Every corner the plain version reaches for cell i lies in
    [i - W, i + W] (and in the domain) on each axis: positions from
    _backtrace (index-offset, as the kernel's) on velocities up to +-1e6,
    cells on every border included, then _build_index's two corners; at a
    small shape and with an axis as long as the tiled route takes."""
    rng = np.random.default_rng(4)
    Z, Y, X = extent
    assert sweep_route(W, (1, 3, Z, Y, X)) == "tiled"
    base = _grid(Z, Y, X)
    for scale in (1e-3, 1.0, 30.0, 1e6):
        vel = torch.tensor(rng.standard_normal((4, 3, Z, Y, X)) * scale,
                           dtype=torch.float32)
        vel[0] = scale          # every cell at the clip, +1 and -1
        vel[1] = -scale
        allowed = torch.tensor(rng.random((4, Z, Y, X)) * 3.0,
                               dtype=torch.float32) if ours else None
        for dcoef in (-0.1, 0.1, 1.0):
            pos = _backtrace(vel, base, dcoef, W, allowed)
            for p, b, n in zip(pos, base, (X, Y, Z)):
                i, _, _ = _build_index(p, n)
                cell = b.long()
                for corner in (i, i + 1):
                    assert (corner >= cell - W).all()
                    assert (corner <= cell + W).all()
                    assert (corner >= 0).all() and (corner <= n - 1).all()


@pytest.mark.parametrize("W", TILED_WINDOWS)
def test_longer_axes_take_the_global_route(W):
    """One cell past MAX_TILED_EXTENT on an axis (a few more, so no clamp
    hides it), a position at the clip rounds to i + W and its upper
    corner leaves the window: such shapes take the global route."""
    n = MAX_TILED_EXTENT + 8
    for extent in ((2, 3, n), (2, n, 3), (n, 3, 2)):
        assert sweep_route(W, (1, 3) + extent) == "global"
    base = _grid(2, 3, n)
    vel = torch.full((1, 3, 2, 3, n), 10.0)
    p = _backtrace(vel, base, 1.0, W, None)[0]
    i, _, _ = _build_index(p, n)
    assert (i + 1 > base[0].long() + W).any()


@pytest.mark.parametrize("shape", [s for s, n in SHAPES[:4] if n == 132])
@pytest.mark.parametrize("W,is_bwd,resident,tile_y", [
    (1, False, {8: 4, 16: 2}, 8), (1, True, {8: 4, 16: 2}, 8),
    (2, False, {8: 4, 16: 2}, 16), (2, True, {8: 2, 16: 1}, 8)])
def test_tiling_takes_the_faster_height(shape, W, is_bwd, resident, tile_y):
    """With the resident blocks an H100 reports for the fused forms, the
    table takes the tile height that ran faster at 128^3 and 6x64^3: the
    tie-breaks (more than 28 KB of L1 left an SM, two or more blocks an
    SM, the lower tile) decide it."""
    tiling = sweep_tiling(shape, W, 132, resident, is_bwd, True)
    assert tiling.tile_y == tile_y
    per_sm = -(-tiling.blocks // 132)
    assert per_sm * (tiling.smem + 1024) <= 200704
