"""K2's and K4's tiling (ops/cuda/forces_kernel.py::prologue_tiling), pure
Python on the CPU.

The z-marching kernel of csrc/prologue.cu takes its grid from the wrapper:
the xy tile's height and the output planes a block. Here that tiling is
checked at the shapes the port runs (128^3 with the 132 SMs of an H100
SXM and the 114 of a PCIe card, the 6x64^3 training batch) and at ragged
ones, for both of the kernel's forms (the prologue, whose step z writes
plane z - 5, and the forces block and K4, whose step z writes plane z - 4)
and both tile heights: every output cell is written by exactly one
(block, thread, plane) of the kernel's loop (mirrored below), every
block's z-walk loads its range and the 4 planes on each side that its
outputs read, no block's shared memory exceeds the card's limit, and 128^3
and 6x64^3 run in one wave that keeps most SMs busy.
"""

import numpy as np
import pytest

from fluidnet_tpu_torch.ops.cuda.forces_kernel import (
    HALO, MIN_PLANES, TILE_X, TILE_YS, prologue_tiling, smem_bytes)

SMEM = 232448          # H100: the most shared memory a block may take

SHAPES = [((1, 3, 128, 128, 128), 132), ((1, 3, 128, 128, 128), 114),
          ((6, 3, 64, 64, 64), 132), ((6, 3, 64, 64, 64), 114),
          ((2, 3, 9, 13, 17), 132), ((2, 3, 37, 45, 61), 132),
          ((1, 3, 37, 45, 61), 114), ((1, 3, 33, 17, 70), 132)]


def kernel_walk(shape, tiling, epi):
    """The kernel's loop: (how many times each output cell (b, z, y, x) is
    written, the input planes each block loads). Block (bx, by, bz) takes
    batch item bz // ranges and planes [zs, ze); its thread (lx, ly) owns
    column (bx * TILE_X - HALO + lx, by * tile_y - HALO + ly) and writes
    it on the tile (lx, ly in [HALO, TILE_X + HALO) x [HALO, tile_y +
    HALO)) inside the domain; step z, from zs - HALO on, computes on plane
    z and writes plane z - 5 (the prologue) or z - 4, and the planes
    before ze + 4 (the prologue) or ze + 3 are loaded."""
    B, _, Z, Y, X = shape
    ty, zc = tiling.tile_y, tiling.planes
    rows = ty + 2 * HALO
    ranges = -(-Z // zc)
    grid = (-(-X // TILE_X), -(-Y // ty), ranges * B)
    assert grid[0] * grid[1] * grid[2] == tiling.blocks
    assert tiling.threads == (TILE_X + 2 * HALO) * rows
    lag = 5 if epi else 4
    lx, ly = np.meshgrid(np.arange(TILE_X + 2 * HALO), np.arange(rows))
    tile = (lx >= HALO) & (lx < TILE_X + HALO) & (ly >= HALO) & \
        (ly < ty + HALO)
    owners = np.zeros((B, Z, Y, X), np.int64)
    walks = []
    for bz in range(grid[2]):
        b, zs = bz // ranges, (bz % ranges) * zc
        ze = min(zs + zc, Z)
        steps = range(zs - HALO, ze + lag)
        for by in range(grid[1]):
            for bx in range(grid[0]):
                gx = bx * TILE_X - HALO + lx
                gy = by * ty - HALO + ly
                out = tile & (gx >= 0) & (gx < X) & (gy >= 0) & (gy < Y)
                for z in steps:
                    p = z - lag
                    if zs <= p < ze:
                        owners[b, p, gy[out], gx[out]] += 1
                walks.append((zs, ze, steps.start, ze + lag - 1))
    return owners, walks


@pytest.mark.parametrize("tile_y", TILE_YS)
@pytest.mark.parametrize("shape,n_sm", SHAPES)
def test_tiling_writes_every_cell_once(shape, n_sm, tile_y):
    Z = shape[2]
    for epi in (True, False):
        tiling = prologue_tiling(shape, n_sm, tile_y, epi)
        assert tiling.smem == smem_bytes(tile_y, epi) <= SMEM
        assert tiling.threads <= 1024
        assert tiling.planes >= min(MIN_PLANES, Z)
        owners, walks = kernel_walk(shape, tiling, epi)
        assert owners.min() == 1 and owners.max() == 1
        for zs, ze, first, stop in walks:
            # The outputs on [zs, ze) read input planes zs - 4 .. ze + 3
            # (the forces block ze + 2): the walk loads exactly those.
            assert ze > zs and first == zs - HALO
            assert stop == ze + (HALO if epi else HALO - 1)
            assert ze - zs + 2 * HALO + epi <= tiling.steps


@pytest.mark.parametrize("shape,n_sm", SHAPES[:4])
def test_tiling_is_one_wave(shape, n_sm):
    """128^3 and the 6x64^3 batch run in one wave (the kernel's registers
    leave one block an SM) that keeps at least 70% of the SMs busy."""
    for epi in (True, False):
        tiling = prologue_tiling(shape, n_sm, epi=epi)
        assert 0.7 * n_sm <= tiling.blocks <= n_sm
        assert tiling.planes >= MIN_PLANES


def test_tiling_rejects_other_tile_heights():
    with pytest.raises(ValueError):
        prologue_tiling((1, 3, 128, 128, 128), 132, 12)
