"""Obstacle geometry export as a per-cell cube OBJ mesh.

Equivalent of tfluids.writeOutObstacles (torch/lib/obstacles_export.lua:17):
every obstacle cell becomes a unit cube; interior faces between two
obstacle cells are culled so renderers only see the surface.
"""

import numpy as np


def export_obstacles_obj(path, flags_or_occupancy):
    """flags_or_occupancy: (z, y, x) array; cells > 0.5 (occupancy) or with
    the obstacle bit are written as cubes."""
    vol = np.asarray(flags_or_occupancy)
    if vol.dtype.kind in "iu":
        occ = (vol.astype(np.int64) & 2) > 0
    else:
        occ = vol > 0.5
    Z, Y, X = occ.shape
    pad = np.pad(occ, 1)

    verts = {}
    vlist = []
    faces = []

    def vid(p):
        if p not in verts:
            verts[p] = len(vlist) + 1
            vlist.append(p)
        return verts[p]

    # For each axis and direction, emit faces where occ and the neighbor
    # along that direction is empty (surface extraction).
    offsets = {
        (0, -1): [(0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)],
        (0, +1): [(1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0)],
        (1, -1): [(0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0)],
        (1, +1): [(0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)],
        (2, -1): [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)],
        (2, +1): [(0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)],
    }
    for (axis, d), corner_offs in offsets.items():
        shift = [slice(1, -1)] * 3
        shift[axis] = slice(1 + d, Z + 1 + d if axis == 0 else
                            (Y + 1 + d if axis == 1 else X + 1 + d))
        nbr = pad[tuple(shift)]
        surf = occ & ~nbr
        zz, yy, xx = np.nonzero(surf)
        for z, y, x in zip(zz.tolist(), yy.tolist(), xx.tolist()):
            ids = [vid((z + oz, y + oy, x + ox))
                   for oz, oy, ox in corner_offs]
            faces.append(ids)

    with open(path, "w") as f:
        f.write("# fluidnet_tpu obstacle export\n")
        for z, y, x in vlist:
            # OBJ convention: x y z.
            f.write(f"v {x} {y} {z}\n")
        for ids in faces:
            f.write("f {} {} {} {}\n".format(*ids))
    return len(vlist), len(faces)
