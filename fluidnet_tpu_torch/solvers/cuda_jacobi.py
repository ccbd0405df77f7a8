"""K3: the fixed-sweep Jacobi pressure solve.

Replaces fluidnet_tpu/solvers/pallas_jacobi.py::_kernel (jacobi_pallas):
n sweeps from p = 0 with obstacle neighbours reflecting the centre value
and p forced to 0 on the 1-cell border and on obstacles. Both versions
also start from a given p0 (`p0=`): n sweeps from p0 then equal n more
sweeps of a solve that reached p0, to the bit, which is what the rounds
of the z-sharded solve rest on (parallel/halo.py::slab_jacobi_solve). The
CUDA kernel is csrc/jacobi.cu; its source note gives the bound, the design
and the rules it rests on. In short: one launch per solve with p kept in
shared memory between sweeps. Each block owns a contiguous range of x-rows
(flattened over b, z, y) and holds its p (twice: the sweep's input and
output) and cell codes. A neighbour row outside the range is read, through
L2 only (never the non-coherent read-only path: the copy is written during
the kernel), from the previous sweep's global copy of p. Every sweep
publishes the first and last `halo` rows of each range to that copy, which
alternates between two buffers by sweep parity, with one grid barrier after
the write. Border planes and rows read no neighbour, so a range spanning
two batch items never reads across them.

`jacobi_route` chooses from the shape alone (and the card's limits):
  - "persistent": one cooperative launch of at most the co-resident
    blocks, ranges of ceil(rows / resident) rows, a grid barrier a sweep,
    in 2-D as in 3-D;
  - "sweep": a range too large for a block's shared memory (256^3): one
    launch per sweep, one thread per cell.
No route is chosen by a failure: a launch CUDA refuses raises.

`jacobi_cuda` launches the kernel on CUDA tensors and takes the plain
PyTorch version `jacobi_plain` on CPU tensors; nothing else chooses.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from fluidnet_tpu_torch.core.celltype import is_obstacle
from fluidnet_tpu_torch.core.grids import border_mask
from fluidnet_tpu_torch.ops import stencil as st
from fluidnet_tpu_torch.ops.cuda import _build


def jacobi_masks(flags, is_3d):
    """(zero mask, obstacle-neighbour masks in sweep order, denominator):
    what every sweep of one solve reuses. The denominator is a 0-d tensor
    on the flags' device: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds differently from the true
    division of the kernel and of the TPU kernel."""
    ob = is_obstacle(flags)
    zero = border_mask(flags.shape, is_3d, 1, flags.device) | ob
    shifts = (st.xm, st.xp, st.ym, st.yp) + ((st.zm, st.zp) if is_3d
                                             else ())
    denom = torch.tensor(6.0 if is_3d else 4.0, device=flags.device)
    return zero, [sh(ob, False) for sh in shifts], denom


def jacobi_sweep(p, div, masks, is_3d):
    """One sweep (kernel_jacobiIteration): neighbours summed x-, x+, y-,
    y+, z-, z+, an obstacle neighbour replaced by the centre value, then
    (sum + div) / (6 | 4), zero where the mask says so."""
    shifts = (st.xm, st.xp, st.ym, st.yp) + ((st.zm, st.zp) if is_3d
                                             else ())
    return jacobi_update(p, div, [sh(p) for sh in shifts], masks)


def jacobi_update(p, div, shifted, masks):
    """The combine of one sweep from the neighbour fields `shifted` (p
    read at x-, x+, y-, y+[, z-, z+]; parallel/halo.py passes z-planes
    from its neighbours): the summation order of the kernel."""
    zero, obs_nb, denom = masks
    nbs = [torch.where(o, p, s) for s, o in zip(shifted, obs_nb)]
    tot = nbs[0] + nbs[1]
    for nb in nbs[2:]:
        tot = tot + nb
    return torch.where(zero, 0.0, (tot + div) / denom)


def jacobi_plain(flags, div, n_sweeps: int, p0=None):
    """Plain PyTorch version of K3 (runs on any device): `n_sweeps`
    sweeps from p0 (None: p = 0). flags (b,1,z,y,x) int32, div and p0
    (b,1,z,y,x) f32; 3-D when z > 1. Returns p (b,1,z,y,x)."""
    is_3d = div.shape[2] > 1
    masks = jacobi_masks(flags, is_3d)
    p = torch.zeros_like(div) if p0 is None else p0
    for _ in range(n_sweeps):
        p = jacobi_sweep(p, div, masks, is_3d)
    return p


ROUTES = ("sweep", "persistent")   # the C entry point's codes


class JacobiRoute(NamedTuple):
    """K3's partition of one shape: the route, rows per block, blocks,
    halo rows (the rows at each end of a range that its block publishes
    every sweep: those its neighbours read) and dynamic shared-memory
    bytes a block."""
    route: str
    rows_per_block: int
    blocks: int
    halo: int
    smem: int


def smem_bytes(rows_per_block, x):
    """Two float32 copies of p and a 1-byte code per cell of the range."""
    return 9 * rows_per_block * x


def jacobi_route(shape, resident: int, smem_limit: int) -> JacobiRoute:
    """K3's route and partition for div/flags of `shape` (b, 1, z, y, x)
    on a card with `resident` co-resident blocks of the resident kernel
    and `smem_limit` bytes of shared memory a block (device_limits)."""
    B, _, Z, Y, X = (int(v) for v in shape)
    rows = B * Z * Y
    rpb = -(-rows // resident)
    if smem_bytes(rpb, X) <= smem_limit:
        return JacobiRoute("persistent", rpb, -(-rows // rpb),
                           Y if Z > 1 else 1, smem_bytes(rpb, X))
    return JacobiRoute("sweep", 0, 0, 0, 0)


@functools.lru_cache(maxsize=None)
def device_limits(index: int):
    """(co-resident blocks of the resident kernel at the most shared memory
    a block may take, that most in bytes) on CUDA device `index`, from the
    occupancy API and the SM count."""
    lib = _build.library()
    resident, limit = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.fluidnet_jacobi_limits(ctypes.byref(resident),
                                         ctypes.byref(limit))
    _build.check(err, "fluidnet_jacobi_limits")
    return resident.value, limit.value


def _jacobi_launch(flags, div, n_sweeps, p0):
    if div.dim() != 5 or div.shape[1] != 1:
        raise ValueError(f"jacobi: div must be (b, 1, z, y, x), got "
                         f"{tuple(div.shape)}")
    for name, t in (("flags", flags), ("p0", p0)):
        if t is not None and t.shape != div.shape:
            raise ValueError(f"jacobi: {name} {tuple(t.shape)} do not "
                             f"match div {tuple(div.shape)}")
    dev = _build.require_cuda(
        "jacobi", div, flags, *([] if p0 is None else [p0]),
        dtypes=[torch.float32, torch.int32, torch.float32])
    B, _, Z, Y, X = div.shape
    if B * Z * Y * X >= 2 ** 31:
        raise ValueError(f"jacobi: unsupported shape {tuple(div.shape)}")
    if n_sweeps == 0:
        return torch.zeros_like(div) if p0 is None else p0.clone()
    out = torch.empty_like(div)
    part = jacobi_route(div.shape, *device_limits(dev.index))
    scratch = torch.empty_like(div)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fluidnet_jacobi(
            div.data_ptr(), flags.data_ptr(),
            None if p0 is None else p0.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, Z, Y, X, int(n_sweeps),
            ROUTES.index(part.route), part.rows_per_block, part.halo,
            part.smem, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fluidnet_jacobi")
    _build.launches["jacobi"] += 1
    return out


def jacobi_cuda(flags, div, n_sweeps: int, p0=None):
    """Fixed-sweep Jacobi solve: the same arguments and result as
    jacobi_plain. CPU tensors run jacobi_plain; CUDA tensors launch K3
    (counted once per solve in _build.launches["jacobi"]; 0 sweeps launch
    nothing and return zeros, or a copy of p0)."""
    if n_sweeps < 0:
        raise ValueError(f"jacobi: n_sweeps must be >= 0, got {n_sweeps}")
    if div.device.type == "cpu":
        return jacobi_plain(flags, div, n_sweeps, p0)
    return _jacobi_launch(flags, div, n_sweeps, p0)
