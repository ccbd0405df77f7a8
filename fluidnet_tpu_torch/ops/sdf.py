"""Signed distance field to the obstacles, and the rectangular blur.

Port of fluidnet_tpu.ops.sdf. signed_distance_field
(Main_signedDistanceField, generic/tfluids.cc:766-826): the reference's
brute-force local-window minimum distance to obstacle cells, clamped at
`search_rad`; a min over shifted obstacle masks (123 of them in 3-D at the
default radius 3). Used for the border-weighted loss
(fluid_criterion.lua:145-159). rectangular_blur (Main_rectangularBlur,
generic/tfluids.cc:670-765): a separable box filter in the JAX package's
cumulative-sum form; models.modules' window normalizations call it.
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


def _box_blur_axis(x, rad: int, axis: int):
    """Mean over the window [i - rad, i + rad] with edge-replicated samples
    and a constant 1 / (2r + 1), as DoRectangularBlurAlongAxis
    (generic/tfluids.cc:642-668): the difference of a cumulative sum over
    the edge-padded axis, as the JAX package computes it."""
    n = x.shape[axis]
    idx = torch.arange(-rad, n + rad, device=x.device).clamp(0, n - 1)
    c = torch.cumsum(x.index_select(axis, idx), dim=axis)
    cpad = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
    return (cpad.narrow(axis, 2 * rad + 1, n) - cpad.narrow(axis, 0, n)) / \
        float(2 * rad + 1)


def rectangular_blur(src, blur_rad: int, is_3d: bool):
    """Separable box blur: z (3-D only), then y, then x."""
    out = src
    if is_3d:
        out = _box_blur_axis(out, blur_rad, src.ndim - 3)
    out = _box_blur_axis(out, blur_rad, src.ndim - 2)
    return _box_blur_axis(out, blur_rad, src.ndim - 1)
