"""MAC face-centered velocity reconstruction and cell-center positions.

Port of fluidnet_tpu.ops.interp.get_at_mac_x/y/z and
cell_center_positions (grid.cc:374-417): the transverse components are
averaged around a face; shifted reads fill 0 at the domain edge.
"""

import functools

import torch

from fluidnet_tpu_torch.core.grids import resolve_device
from fluidnet_tpu_torch.ops import stencil as st


def get_at_mac_x(u, is_3d):
    vx = u[:, 0]
    vy = 0.25 * (u[:, 1] + st.xm(u[:, 1]) + st.yp(u[:, 1]) +
                 st.xm(st.yp(u[:, 1])))
    if is_3d:
        vz = 0.25 * (u[:, 2] + st.xm(u[:, 2]) + st.zp(u[:, 2]) +
                     st.xm(st.zp(u[:, 2])))
    else:
        vz = torch.zeros_like(vx)
    return torch.stack([vx, vy, vz], dim=1)


def get_at_mac_y(u, is_3d):
    vx = 0.25 * (u[:, 0] + st.ym(u[:, 0]) + st.xp(u[:, 0]) +
                 st.ym(st.xp(u[:, 0])))
    vy = u[:, 1]
    if is_3d:
        vz = 0.25 * (u[:, 2] + st.ym(u[:, 2]) + st.zp(u[:, 2]) +
                     st.ym(st.zp(u[:, 2])))
    else:
        vz = torch.zeros_like(vx)
    return torch.stack([vx, vy, vz], dim=1)


def get_at_mac_z(u, is_3d):
    if not is_3d:
        raise ValueError("get_at_mac_z is 3-D only")
    vx = 0.25 * (u[:, 0] + st.zm(u[:, 0]) + st.xp(u[:, 0]) +
                 st.zm(st.xp(u[:, 0])))
    vy = 0.25 * (u[:, 1] + st.zm(u[:, 1]) + st.yp(u[:, 1]) +
                 st.zm(st.yp(u[:, 1])))
    vz = u[:, 2]
    return torch.stack([vx, vy, vz], dim=1)


def cell_center_positions(shape, dtype=torch.float32, device=None):
    """(px, py, pz) tensors of cell-center coordinates, each (1, z, y, x),
    on resolve_device(device); built once per shape, dtype and device (they
    are read-only expanded views)."""
    _, _, Z, Y, X = shape
    return _cell_centers(int(Z), int(Y), int(X), dtype,
                         resolve_device(device))


@functools.lru_cache(maxsize=64)
def _cell_centers(Z, Y, X, dtype, device):
    px = torch.arange(X, dtype=dtype, device=device).view(1, 1, 1, X) + 0.5
    py = torch.arange(Y, dtype=dtype, device=device).view(1, 1, Y, 1) + 0.5
    pz = torch.arange(Z, dtype=dtype, device=device).view(1, Z, 1, 1) + 0.5
    return (px.expand(1, Z, Y, X), py.expand(1, Z, Y, X),
            pz.expand(1, Z, Y, X))
