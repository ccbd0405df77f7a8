"""K3's route and partition (solvers/cuda_jacobi.py::jacobi_route), pure
Python on the CPU.

The resident kernel of csrc/jacobi.cu takes its partition from the
wrapper: rows per block, blocks, halo rows and shared-memory bytes. Here
that partition is checked at the shapes the port runs (128^3 with the 132
SMs of an H100 SXM and the 114 of a PCIe card, the 6x64^3 training
targets, the 2-D server's 128^2, 256^3) and at ragged ones: every cell is
computed by exactly one (block, thread) of the kernel's loop (mirrored
below), and no block's bytes exceed the limit. A mirror of the
kernel's data flow (each block's shared p, the two global copies of p,
which rows each sweep publishes, sweep parity) is held to jacobi_plain to
the bit, with the global copies NaN until written, so a read of a row no
sweep published shows.
"""

import numpy as np
import pytest
import torch

from fluidnet_tpu_torch.solvers.cuda_jacobi import (
    jacobi_masks, jacobi_plain, jacobi_route)

from tests.torch_port_util import random_flags

SMEM = 232448          # H100: the most shared memory a block may take
THREADS = 1024         # csrc/jacobi.cu kResThreads: jacobi_sweeps' block

ROUTES = [
    ((1, 1, 128, 128, 128), 132, SMEM, "persistent"),
    ((1, 1, 128, 128, 128), 114, SMEM, "persistent"),
    ((6, 1, 64, 64, 64), 132, SMEM, "persistent"),
    ((6, 1, 64, 64, 64), 114, SMEM, "persistent"),
    ((1, 1, 1, 128, 128), 132, SMEM, "persistent"),
    ((2, 1, 1, 45, 61), 132, SMEM, "persistent"),
    ((1, 1, 1, 384, 384), 132, SMEM, "persistent"),
    ((3, 1, 9, 13, 17), 132, SMEM, "persistent"),
    ((2, 1, 19, 37, 61), 114, SMEM, "persistent"),
    ((1, 1, 256, 256, 256), 132, SMEM, "sweep"),
    ((2, 1, 128, 128, 128), 132, SMEM, "sweep"),
]


def kernel_owners(shape, part):
    """How many times the resident kernel computes each cell of the
    flattened (rows, x) grid: its loop for every block (thread t takes the
    groups of V cells t, t + THREADS, ... of the block's range, V = 4
    when x % 4 == 0, else 1)."""
    B, _, Z, Y, X = shape
    rows = B * Z * Y
    V = 4 if X % 4 == 0 else 1
    owners = np.zeros(rows * X, np.int64)
    for b in range(part.blocks):
        r0 = b * part.rows_per_block
        ncell = min(part.rows_per_block, rows - r0) * X
        assert ncell > 0, f"block {b} owns no row"
        # Thread t's k-th group is group t + k * THREADS of the range.
        groups = np.arange(-(-ncell // V)).reshape(-1, 1)
        t, k = groups % THREADS, groups // THREADS
        c = V * (t + k * THREADS) + np.arange(V)[None, :]
        assert c.max() < ncell
        np.add.at(owners, r0 * X + c.ravel(), 1)
    return owners


@pytest.mark.parametrize("shape,resident,limit,route", ROUTES)
def test_partition_owns_every_cell_once(shape, resident, limit, route):
    part = jacobi_route(shape, resident, limit)
    assert part.route == route
    if route == "sweep":
        return
    B, _, Z, Y, X = shape
    rows = B * Z * Y
    assert part.smem <= limit
    assert part.smem == 9 * part.rows_per_block * X
    assert part.blocks <= resident
    assert part.halo == (Y if Z > 1 else 1)
    assert (part.blocks - 1) * part.rows_per_block < rows <= \
        part.blocks * part.rows_per_block
    owners = kernel_owners(shape, part)
    assert owners.min() == 1 and owners.max() == 1


def kernel_dataflow(flags, div, n, part):
    """The resident kernel's data flow in float32 torch ops, in its
    order of operations: each block's p, the global copies g (NaN until
    written), a neighbour row outside the block's range read from
    g[s & 1] (0 in sweep 0), the first and last `halo` rows of a range
    published to g[(s + 1) & 1] each sweep, the whole range in the last.
    Returns g[n & 1]."""
    B, _, Z, Y, X = div.shape
    rows = B * Z * Y
    is_3d = Z > 1
    zero, obs, denom = jacobi_masks(flags, is_3d)
    zero = zero.expand(div.shape).reshape(rows, X)
    obs = [o.reshape(rows, X) for o in obs]
    d = div.reshape(rows, X)
    g = [torch.full((rows, X), float("nan")) for _ in range(2)]
    p = torch.zeros(rows, X)
    drows = (-1, 1) + ((-Y, Y) if is_3d else ())
    for s in range(n):
        src, dst = g[s & 1], g[(s + 1) & 1]
        new = torch.empty(rows, X)
        for b in range(part.blocks):
            r0 = b * part.rows_per_block
            r1 = min(r0 + part.rows_per_block, rows)
            r = torch.arange(r0, r1)
            pc = p[r0:r1]
            left = torch.cat([pc[:, :1], pc[:, :-1]], 1)
            right = torch.cat([pc[:, 1:], pc[:, -1:]], 1)
            nbs = [left, right]
            for dr in drows:
                rn = (r + dr).clamp(0, rows - 1)
                inside = ((r + dr >= r0) & (r + dr < r1))[:, None]
                outside = src[rn] if s else torch.zeros(r1 - r0, X)
                nbs.append(torch.where(inside, p[rn], outside))
            nbs = [torch.where(o[r0:r1], pc, v) for o, v in zip(obs, nbs)]
            tot = nbs[0] + nbs[1]
            for v in nbs[2:]:
                tot = tot + v
            new[r0:r1] = torch.where(zero[r0:r1], 0.0,
                                     (tot + d[r0:r1]) / denom)
            if s + 1 == n:
                dst[r0:r1] = new[r0:r1]
            else:
                h = min(part.halo, r1 - r0)
                dst[r0:r0 + h] = new[r0:r0 + h]
                dst[r1 - h:r1] = new[r1 - h:r1]
        p = new
    return g[n & 1].reshape(div.shape)


@pytest.mark.parametrize("shape,resident,limit", [
    ((3, 1, 9, 13, 17), 8, SMEM),      # ranges of 44 rows span batch items
    ((3, 1, 9, 13, 17), 40, SMEM),     # 9 rows: every z neighbour outside
    ((2, 1, 1, 45, 61), 7, SMEM),      # 2-D: 13 rows, across batch items
])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_kernel_dataflow_matches_plain(shape, resident, limit, n):
    part = jacobi_route(shape, resident, limit)
    assert part.route == "persistent"
    rng = np.random.default_rng(17)
    flags = torch.from_numpy(random_flags(rng, shape))
    div = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    out = kernel_dataflow(flags, div, n, part)
    assert torch.equal(out, jacobi_plain(flags, div, n))
