"""Grid state and basic grid utilities.

Port of fluidnet_tpu.core.grids. Every field is a tensor of shape
(batch, channel, z, y, x); MAC velocity has 2 (2-D) or 3 (3-D) channels and
2-D domains use z == 1. Index (i, j, k) maps to tensor axes (-1, -2, -3);
cell centers sit at integer + 0.5.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from fluidnet_tpu_torch.core.celltype import CellType, is_obstacle


@dataclasses.dataclass(frozen=True)
class FluidState:
    """Simulation state; every field is (batch, c, z, y, x)."""

    u: torch.Tensor                          # MAC velocity, c in {2, 3}.
    p: torch.Tensor                          # pressure, c == 1.
    flags: torch.Tensor                      # int32 cell-type flags, c == 1.
    density: Optional[torch.Tensor] = None   # advected scalar(s), c >= 1.

    @property
    def is_3d(self) -> bool:
        return self.u.shape[1] == 3

    def replace(self, **kw) -> "FluidState":
        return dataclasses.replace(self, **kw)


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


def resolve_device(device=None) -> torch.device:
    """The device a constructor builds on: `device` if given, else the
    CUDA device. Without a CUDA device that raises RuntimeError: the port
    runs on the card unless the caller asks for the CPU (device="cpu")."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds on the GPU by "
                           "default; pass device='cpu' to build on the CPU")
    return device


def border_mask(shape, is_3d: bool, bnd: int = 1,
                device=None) -> torch.Tensor:
    """Boolean (1, 1, z, y, x) mask, True on the `bnd`-wide domain border
    (the z border only in 3-D). Built on resolve_device(device), once per
    shape and device: the mask is a read-only expanded view, so each step
    reuses it instead of issuing its ops again."""
    return _border_mask(int(shape[-3]), int(shape[-2]), int(shape[-1]),
                        bool(is_3d), int(bnd), resolve_device(device))


@functools.lru_cache(maxsize=64)
def _border_mask(z, y, x, is_3d, bnd, device):
    xi = torch.arange(x, device=device).view(1, 1, 1, 1, x)
    yi = torch.arange(y, device=device).view(1, 1, 1, y, 1)
    m = (xi < bnd) | (xi > x - 1 - bnd) | (yi < bnd) | (yi > y - 1 - bnd)
    if is_3d:
        zi = torch.arange(z, device=device).view(1, 1, z, 1, 1)
        m = m | (zi < bnd) | (zi > z - 1 - bnd)
    return m.expand(1, 1, z, y, x)


def empty_domain(shape, is_3d: bool, bnd: int = 1, device=None,
                 dtype=torch.int32) -> torch.Tensor:
    """Flags grid: TypeFluid inside, TypeObstacle on a bnd-wide border.
    `shape` is (batch, 1, z, y, x). Built on resolve_device(device)."""
    if len(shape) != 5 or shape[1] != 1:
        raise ValueError(f"flags shape must be (b, 1, z, y, x), got {shape}")
    m = border_mask(shape, is_3d, bnd, device)
    flags = torch.where(m, int(CellType.TypeObstacle),
                        int(CellType.TypeFluid))
    return flags.expand(*shape).to(dtype).contiguous()


def flags_to_occupancy(flags) -> torch.Tensor:
    """Flags -> {0, 1} float obstacle occupancy."""
    return is_obstacle(flags).to(torch.float32)


def zero_state(batch, size_xyz, is_3d: bool, n_density: int = 1,
               dtype=torch.float32, device=None) -> FluidState:
    """An empty-domain state, mirroring fluid_net_3d_sim.lua:62-69: zero
    u, p and density, flags from empty_domain. size_xyz is (x, y, z); a
    2-D state needs z == 1. Built on resolve_device(device)."""
    x, y, z = size_xyz
    if not is_3d and z != 1:
        raise ValueError(f"zero_state: a 2-D state needs z == 1, got {z}")
    device = resolve_device(device)
    cu = 3 if is_3d else 2
    return FluidState(
        u=torch.zeros((batch, cu, z, y, x), dtype=dtype, device=device),
        p=torch.zeros((batch, 1, z, y, x), dtype=dtype, device=device),
        flags=empty_domain((batch, 1, z, y, x), is_3d, device=device),
        density=torch.zeros((batch, n_density, z, y, x), dtype=dtype,
                            device=device))
