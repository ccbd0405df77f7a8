"""Geometry-aware line trace for the "Ours" semi-Lagrangian backtraces.

Port of fluidnet_tpu.ops.line_trace (calcLineTrace,
torch/tfluids/generic/calc_line_trace.cc): march along the displacement
ray in unit-length steps; when a tentative step leaves the domain, back
off to the domain-border intersection (HIT_MARGIN inside); when it enters a
blocked (non-fluid) cell, back off to the ray-box intersection with that
cell (the box inflated by HIT_MARGIN) and stop. The returned position is
never inside geometry or outside the domain.

The reference marches each ray with a data-dependent loop; like the JAX
package this runs every one of `max_steps` (default 8) steps for every ray
and freezes finished rays with `where`, with a back-off spin of 4 (the
reference's max_count, calc_line_trace.cc:412). The operations follow the
JAX package's in order, so the discrete decisions (the inclusive domain
test, truncation to a cell, the margins of the ray-box test) fall the
same way.
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.ops.interp import gather3d

HIT_MARGIN = 1e-5   # calc_line_trace.cc:22
EPSILON = 1e-12     # calc_line_trace.cc:23
_ERR_TOL = 1e-6     # HitBoundingBox err_tol (calc_line_trace.cc:158)


def _is_out_of_domain(px, py, pz, Z, Y, X):
    """IsOutOfDomainReal (calc_line_trace.cc:44-52); boundary-inclusive."""
    return ((px <= 0.0) | (px >= X) | (py <= 0.0) | (py >= Y) |
            (pz <= 0.0) | (pz >= Z))


def _blocked_at(blocked, px, py, pz):
    """IsBlockedCellReal: the blocked flag of the cell holding the
    position (GetPixelCenter truncates, calc_line_trace.cc:30-38); indices
    clamped for the gather, callers pass in-domain positions."""
    Z, Y, X = blocked.shape[2:]
    xi = px.to(torch.int32).clamp(0, X - 1)
    yi = py.to(torch.int32).clamp(0, Y - 1)
    zi = pz.to(torch.int32).clamp(0, Z - 1)
    return gather3d(blocked, xi, yi, zi)[:, 0] > 0.5


def _ray_box_intersection(ox, oy, oz, dx, dy, dz, cx, cy, cz):
    """HitBoundingBox against the unit cube centred at c, inflated by
    HIT_MARGIN (calc_line_trace.cc:101-196). Returns (hit, ix, iy, iz)."""
    half = 0.5 + HIT_MARGIN
    axes = [(ox, dx, cx), (oy, dy, cy), (oz, dz, cz)]
    minb = [c - half for (_, _, c) in axes]
    maxb = [c + half for (_, _, c) in axes]
    left = [o < mn for (o, _, _), mn in zip(axes, minb)]
    right = [o > mx for (o, _, _), mx in zip(axes, maxb)]
    middle = [~lf & ~rt for lf, rt in zip(left, right)]
    inside = middle[0] & middle[1] & middle[2]
    cand = [torch.where(lf, mn, mx) for lf, mn, mx in zip(left, minb, maxb)]
    t = [torch.where(~m & (d.abs() > 0.0),
                     (cp - o) / torch.where(d == 0, 1.0, d), -1.0)
         for (o, d, _), m, cp in zip(axes, middle, cand)]
    # argmax over the three candidates, the first of equal maxima (as
    # jnp.argmax).
    which = torch.where(t[1] > t[0], 1, 0)
    tbest = torch.maximum(t[0], t[1])
    which = torch.where(t[2] > tbest, 2, which)
    tbest = torch.maximum(tbest, t[2])
    ok = tbest >= 0.0
    coords = []
    for i, ((o, d, _), cp) in enumerate(zip(axes, cand)):
        on = which == i
        ci = torch.where(on, cp, o + tbest * d)
        in_rng = (ci >= minb[i] - _ERR_TOL) & (ci <= maxb[i] + _ERR_TOL)
        ok = ok & (in_rng | on)
        coords.append(ci)
    # An origin inside the box hits at the origin (calc_line_trace.cc:
    # 128-133).
    coords = [torch.where(inside, o, c) for (o, _, _), c in zip(axes, coords)]
    return (ok & ~inside) | inside, coords[0], coords[1], coords[2]


def _border_intersection(ox, oy, oz, nx, ny, nz, Z, Y, X):
    """calcRayBorderIntersection (calc_line_trace.cc:205-286): step back to
    HIT_MARGIN inside the first exceeded face. Returns (hit, ix, iy, iz);
    without a hit the caller clamps instead."""
    big = torch.finfo(ox.dtype).max
    min_step = torch.full_like(ox, big)

    def face(min_step, n, o, hi_bound):
        d = n - o
        far = d.abs() >= EPSILON
        safe_d = torch.where(far, d, 1.0)
        step_lo = (HIT_MARGIN - o) / safe_d        # the face n <= HIT_MARGIN
        min_step = torch.where((n <= HIT_MARGIN) & far,
                               torch.minimum(min_step, step_lo), min_step)
        step_hi = (hi_bound - HIT_MARGIN - o) / safe_d
        return torch.where((n >= hi_bound - HIT_MARGIN) & far,
                           torch.minimum(min_step, step_hi), min_step)

    min_step = face(min_step, nx, ox, float(X))
    min_step = face(min_step, ny, oy, float(Y))
    min_step = face(min_step, nz, oz, float(Z))
    hit = (min_step >= 0.0) & (min_step < big)
    return (hit, min_step * (nx - ox) + ox, min_step * (ny - oy) + oy,
            min_step * (nz - oz) + oz)


def _clamp_to_domain(px, py, pz, Z, Y, X):
    """ClampToDomainReal (calc_line_trace.cc:72-81)."""
    return (px.clamp(HIT_MARGIN, X - HIT_MARGIN),
            py.clamp(HIT_MARGIN, Y - HIT_MARGIN),
            pz.clamp(HIT_MARGIN, Z - HIT_MARGIN))


def _step(state, ux, uy, uz, length, blocked, branches=None):
    """One masked march step of every ray (the body of JAX's fori_loop).
    With a `branches` list, appends the step's per-ray decisions."""
    cx, cy, cz, cur_len, done, hit = state
    Z, Y, X = blocked.shape[2:]
    active = ~done & (cur_len < length - HIT_MARGIN)
    step = torch.minimum(length - cur_len, torch.ones_like(length))
    nx = cx + ux * step
    ny = cy + uy * step
    nz = cz + uz * step

    # Case 1: the tentative step leaves the domain (calc_line_trace.cc:
    # 368-402).
    oob = _is_out_of_domain(nx, ny, nz, Z, Y, X)
    bhit, bx, by, bz = _border_intersection(cx, cy, cz, nx, ny, nz, Z, Y, X)
    fx, fy, fz = _clamp_to_domain(nx, ny, nz, Z, Y, X)
    nx = torch.where(oob, torch.where(bhit, bx, fx), nx)
    ny = torch.where(oob, torch.where(bhit, by, fy), ny)
    nz = torch.where(oob, torch.where(bhit, bz, fz), nz)

    # Case 2: it lands in a blocked cell: back off along the ray, at most
    # 4 times (calc_line_trace.cc:403-478).
    was_blocked = _blocked_at(blocked, nx, ny, nz)
    is_blk = was_blocked
    box_fail = torch.zeros_like(is_blk)
    sx, sy, sz = nx, ny, nz
    backoffs = 0
    for _ in range(4):
        h, rx, ry, rz = _ray_box_intersection(
            cx, cy, cz, ux, uy, uz, torch.floor(sx) + 0.5,
            torch.floor(sy) + 0.5, torch.floor(sz) + 0.5)
        upd = is_blk & ~box_fail
        box_fail = box_fail | (upd & ~h)
        moved = upd & h
        sx = torch.where(moved, rx, sx)
        sy = torch.where(moved, ry, sy)
        sz = torch.where(moved, rz, sz)
        is_blk = torch.where(moved, _blocked_at(blocked, sx, sy, sz), is_blk)
        if branches is not None:
            backoffs = backoffs + moved.to(torch.int32)
    # A failed box intersection stays at the current valid point
    # (calc_line_trace.cc:444-453).
    sx = torch.where(box_fail, cx, sx)
    sy = torch.where(box_fail, cy, sy)
    sz = torch.where(box_fail, cz, sz)

    # Stop with a hit: out of the domain and not blocked at the border
    # point, or blocked (at the backed-off point).
    stop = (oob & ~was_blocked) | was_blocked
    if branches is not None:
        branches.append({"out_of_domain": active & oob,
                         "border_hit": active & oob & bhit,
                         "blocked": active & was_blocked,
                         "box_fail": active & box_fail,
                         "backoffs": torch.where(active, backoffs, 0)})
    return (torch.where(active, torch.where(was_blocked, sx, nx), cx),
            torch.where(active, torch.where(was_blocked, sy, ny), cy),
            torch.where(active, torch.where(was_blocked, sz, nz), cz),
            torch.where(active, cur_len + step, cur_len),
            done | (active & stop), hit | (active & stop))


def line_trace(px, py, pz, dx, dy, dz, flags, max_steps: int = 8,
               branches=None):
    """Traces from (px, py, pz) along the displacement (dx, dy, dz), all
    (b, z, y, x). Returns (hit, nx, ny, nz): whether geometry or the
    domain border stopped the ray, and where it ended. Rays that start out
    of the domain or in a non-fluid cell, and zero-length rays, stay at
    their start with hit False (advection copies src for non-fluid cells
    anyway; the reference hard-errors). `branches`, a list, receives one
    dict a step of per-ray decisions (out_of_domain, border_hit, blocked,
    box_fail: bool; backoffs: int32), to compare two runs of a trace."""
    Z, Y, X = flags.shape[2:]
    blocked = (~is_fluid(flags)).to(torch.float32)
    length = torch.sqrt(dx * dx + dy * dy + dz * dz)
    live0 = length > EPSILON
    inv_len = torch.where(live0, 1.0 / torch.where(live0, length, 1.0), 0.0)
    ux, uy, uz = dx * inv_len, dy * inv_len, dz * inv_len
    start_bad = _is_out_of_domain(px, py, pz, Z, Y, X) | \
        _blocked_at(blocked, px, py, pz)
    done = start_bad | ~live0
    state = (px, py, pz, torch.zeros_like(length), done,
             torch.zeros_like(done))
    for _ in range(max_steps):
        state = _step(state, ux, uy, uz, length, blocked, branches)
    cx, cy, cz, _, _, hit = state
    return hit, cx, cy, cz
