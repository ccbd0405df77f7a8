"""Signed distance field to the obstacles.

Port of fluidnet_tpu.ops.sdf.signed_distance_field (Main_signedDistanceField,
generic/tfluids.cc:766-826): the reference's brute-force local-window
minimum distance to obstacle cells, clamped at `search_rad`; a min over
shifted obstacle masks (123 of them in 3-D at the default radius 3). Used
for the border-weighted loss (fluid_criterion.lua:145-159). The JAX
module's rectangular_blur has no caller on a ported path and is not ported.
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_obstacle
from fluidnet_tpu_torch.ops import stencil as st


def signed_distance_field(flags, search_rad: int):
    """Distance (in cells, Euclidean) to the nearest obstacle within
    search_rad; clamped at search_rad; 0 inside obstacles."""
    is_3d = flags.shape[2] > 1
    ob = is_obstacle(flags)
    r = int(search_rad)
    dist_sq = torch.full(flags.shape, float(r * r), dtype=torch.float32,
                         device=flags.device)
    zr = range(-r, r + 1) if is_3d else [0]
    for dz in zr:
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                d2 = float(dz * dz + dy * dy + dx * dx)
                if d2 >= r * r and (dz, dy, dx) != (0, 0, 0):
                    continue
                m = ob
                if dz:
                    m = st.shift(m, dz, st.AX_Z, False)
                if dy:
                    m = st.shift(m, dy, st.AX_Y, False)
                if dx:
                    m = st.shift(m, dx, st.AX_X, False)
                dist_sq = torch.where(m, torch.clamp_max(dist_sq, d2),
                                      dist_sq)
    return torch.where(ob, 0.0, torch.sqrt(dist_sq))
