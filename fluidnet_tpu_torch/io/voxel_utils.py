"""Voxel-grid utilities for placing obstacle models in the flags grid.

NumPy equivalents of torch/lib/voxel_utils.lua: bounding box, padding to
domain dims, diagonal flips, blitting, center-of-mass shifts. These run
host-side at scene setup (the reference does too — per-sim one-shot work).
All grids are (d0, d1, d2) 3-D occupancy arrays.
"""

import numpy as np


def bounding_box(voxels):
    """(min, max) inclusive index triples of the nonzero region
    (voxel_utils.lua calculateBoundingBox)."""
    assert voxels.sum() > 0, "empty voxel volume"
    nz = np.nonzero(voxels)
    return ([int(a.min()) for a in nz], [int(a.max()) for a in nz])


def trim_to_bounding_box(voxels):
    mn, mx = bounding_box(voxels)
    return voxels[mn[0]:mx[0] + 1, mn[1]:mx[1] + 1, mn[2]:mx[2] + 1]


def pad_voxels_to_dims(width, height, depth, voxels,
                       offset_x=0, offset_y=0, offset_z=0):
    """Trims to the bounding box, then centers (plus offsets) in a
    (depth, height, width) volume (voxel_utils.lua padVoxelsToDims)."""
    v = trim_to_bounding_box(np.asarray(voxels))
    d, h, w = v.shape
    assert d <= depth and h <= height and w <= width, "voxels too large"
    pad_bck = max(int((depth - d) // 2 + offset_z), 1)
    pad_bot = max(int((height - h) // 2 + offset_y), 1)
    pad_lft = max(int((width - w) // 2 + offset_x), 1)
    out = np.zeros((depth, height, width), v.dtype)
    out[pad_bck:pad_bck + d, pad_bot:pad_bot + h, pad_lft:pad_lft + w] = v
    return out


def flip_diagonal(voxels, axis):
    """Transpose the two axes other than `axis`
    (voxel_utils.lua flipDiagonal)."""
    perms = {0: (0, 2, 1), 1: (2, 1, 0), 2: (1, 0, 2)}
    return np.ascontiguousarray(np.transpose(voxels, perms[axis]))


def blit_into_target(src, target, offset):
    """Pastes src into target at integer offset (voxel_utils.lua
    blitIntoTarget). Returns target (modified in place)."""
    s = src.shape
    o = [int(x) for x in offset]
    target[o[0]:o[0] + s[0], o[1]:o[1] + s[1], o[2]:o[2] + s[2]] = src
    return target


def place_voxels_in_flags(flags, voxels_zyx, fluid_val=1, obstacle_val=2):
    """Blits a voxel occupancy grid into a (b, 1, z, y, x) flags array:
    occupied -> obstacle (fluid_net_3d_sim.lua:90-132)."""
    f = np.asarray(flags).copy()
    z, y, x = voxels_zyx.shape
    assert f.shape[2:] == (z, y, x), "voxel grid must match domain dims"
    f[0, 0][voxels_zyx > 0.5] = obstacle_val
    return f
