"""Frozen copy of the plain PyTorch ops of fluidnet_tpu_torch at commit
a3725f6 (ops/stencil.py, core/celltype.py, core/grids.py), kept here so
that the benchmark's reference does not move with the program. Edits:
the kernel dispatch is gone (every op runs its plain version, on any
device), and the grid masks are built on the device they are asked for.
"""

import enum
import functools

import torch

AX_Z, AX_Y, AX_X = -3, -2, -1


def shift(a, off: int, axis: int, fill=0):
    """out[..., i, ...] = a[..., i + off, ...], `fill` out of range.

    E.g. shift(a, -1, AX_X) reads the -x neighbor: out(i,j,k) = a(i-1,j,k).
    """
    if off == 0:
        return a
    axis = axis % a.dim()
    n = a.shape[axis]
    k = min(abs(off), n)
    pad_shape = list(a.shape)
    pad_shape[axis] = k
    pad = torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)
    if off > 0:
        return torch.cat([a.narrow(axis, k, n - k), pad], dim=axis)
    return torch.cat([pad, a.narrow(axis, 0, n - k)], dim=axis)


def xm(a, fill=0):
    """a(i-1, j, k); fill at i == 0."""
    return shift(a, -1, AX_X, fill)


def xp(a, fill=0):
    """a(i+1, j, k); fill at i == X-1."""
    return shift(a, 1, AX_X, fill)


def ym(a, fill=0):
    return shift(a, -1, AX_Y, fill)


def yp(a, fill=0):
    return shift(a, 1, AX_Y, fill)


def zm(a, fill=0):
    return shift(a, -1, AX_Z, fill)


def zp(a, fill=0):
    return shift(a, 1, AX_Z, fill)


class CellType(enum.IntEnum):
    TypeNone = 0
    TypeFluid = 1
    TypeObstacle = 2
    TypeEmpty = 4
    TypeInflow = 8
    TypeOutflow = 16
    TypeOpen = 32
    TypeStick = 128
    TypeReserved = 256
    TypeZeroPressure = 1 << 15


def _bit(flags, bit):
    # Float flags are cast like the reference's static_cast<int>.
    return (flags.to(torch.int32) & int(bit)) > 0


def is_fluid(flags):
    return _bit(flags, CellType.TypeFluid)


def is_obstacle(flags):
    return _bit(flags, CellType.TypeObstacle)


def is_empty(flags):
    return _bit(flags, CellType.TypeEmpty)


def is_outflow(flags):
    return _bit(flags, CellType.TypeOutflow)


def is_stick(flags):
    return _bit(flags, CellType.TypeStick)


def check_shapes(u, flags, *others) -> bool:
    """Validates the always-5-D convention; returns is_3d."""
    if u.dim() != 5 or flags.dim() != 5:
        raise ValueError("tensors must be 5-D (b, c, z, y, x)")
    if flags.shape[1] != 1:
        raise ValueError("flags must have one channel")
    is_3d = u.shape[1] == 3
    if not is_3d and (u.shape[1] != 2 or u.shape[2] != 1):
        raise ValueError("2-D velocity needs 2 channels and z == 1")
    if u.shape[0] != flags.shape[0] or u.shape[2:] != flags.shape[2:]:
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, "
                         f"flags {tuple(flags.shape)}")
    for o in others:
        if o is not None and (o.dim() != 5 or o.shape[2:] != flags.shape[2:]):
            raise ValueError(f"shape mismatch: {tuple(o.shape)} vs flags "
                             f"{tuple(flags.shape)}")
    return is_3d


def get_dx(flags_or_shape) -> float:
    """Manta's Simulator::getDx: 1 / max grid dimension."""
    shape = getattr(flags_or_shape, "shape", flags_or_shape)
    z, y, x = shape[-3], shape[-2], shape[-1]
    return 1.0 / float(max(x, max(y, z)))


def border_mask(shape, is_3d: bool, bnd: int = 1,
                device=None) -> torch.Tensor:
    """Boolean (1, 1, z, y, x) mask, True on the `bnd`-wide domain border
    (the z border only in 3-D). Built on `device`, once per
    shape and device: the mask is a read-only expanded view, so each step
    reuses it instead of issuing its ops again."""
    return _border_mask(int(shape[-3]), int(shape[-2]), int(shape[-1]),
                        bool(is_3d), int(bnd), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=64)
def _border_mask(z, y, x, is_3d, bnd, device):
    xi = torch.arange(x, device=device).view(1, 1, 1, 1, x)
    yi = torch.arange(y, device=device).view(1, 1, 1, y, 1)
    m = (xi < bnd) | (xi > x - 1 - bnd) | (yi < bnd) | (yi > y - 1 - bnd)
    if is_3d:
        zi = torch.arange(z, device=device).view(1, 1, z, 1, 1)
        m = m | (zi < bnd) | (zi > z - 1 - bnd)
    return m.expand(1, 1, z, y, x)
