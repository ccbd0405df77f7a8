"""Semi-Lagrangian / MacCormack advection of scalar fields and MAC velocity.

Port of fluidnet_tpu.ops.advect (Main_advectScalar, third_party/
tfluids.cc:415-588, and Main_advectVel, :776-920; the public API of
tfluids.advectScalar / advectVel, torch/tfluids/init.lua:89-220), all six
reference methods (generic/advect_type.h:21-28):

  "euler" / "maccormack"          Manta-parity semantics.
  "eulerOurs" / "maccormackOurs"  line-traced backtrace (ops/line_trace.py),
                                  fluid-aware interpolation, the 3^d-window
                                  clamp.
  "rk2Ours" / "rk3Ours"           scalar only; the velocity falls back to
                                  maccormackOurs, as the reference does
                                  (tfluids.cc:799-802).

`window` chooses the path: an integer W >= 1 runs the windowed fast path
(ops/advect_fast.py, kernel K5) with displacements clamped to +-W cells;
None or 0 runs the exact gather path here, the reference-parity semantics
(fluidnet_tpu/core/config.py:47-49). The exact path is plain PyTorch: the
JAX package computes it with XLA gathers outside any Pallas kernel. Its
MacCormackOurs clamp-bound search is a separable masked min/max filter and
one gather, as in the JAX package.

Both paths take a z origin `z0`, the global index of the array's first z
plane (a slab of a z-sharded grid, parallel/simulate_sharded.py): the
positions are global, z0 + k + 0.5 in z, and every z clamp, domain test
and gather index sits at the array's ends expressed globally (z0 and
z0 + Z). float32 holds z0 + k + 0.5 exactly below 2^23, so a slab's
positions carry the whole grid's bits, and every operation on them (the
line trace's steps, floor and truncation to a cell, the weights) rounds
as the whole grid's; only the integer gather indices move by z0. On a
one-sided extended slab the array's ends are the grid's wherever they
reach its ends, so the domain tests fall there as on the whole grid.
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_fluid, is_obstacle
from fluidnet_tpu_torch.core.grids import border_mask, check_shapes
from fluidnet_tpu_torch.ops import stencil as st
from fluidnet_tpu_torch.ops.advect_fast import (_iota, _positions,
                                                advect_scalar_fast,
                                                advect_vel_fast)
from fluidnet_tpu_torch.ops.forces import get_centered
from fluidnet_tpu_torch.ops.interp import (cell_center_positions, gather3d,
                                           get_at_mac_x, get_at_mac_y,
                                           get_at_mac_z, interpol,
                                           interpol_component,
                                           interpol_with_fluid)
from fluidnet_tpu_torch.ops.line_trace import line_trace

METHODS = ("euler", "maccormack", "eulerOurs", "rk2Ours", "rk3Ours",
           "maccormackOurs")


def _check(method):
    if method not in METHODS:
        raise ValueError(f"bad advection method {method!r}")


def advect_scalar(dt, s, u, flags, method="maccormackOurs",
                  sample_outside_fluid=False, maccormack_strength=0.75,
                  boundary_width=1, max_trace_steps=8, window=None,
                  free_space=None, plain=False, z0=0):
    """Advects the scalar field s (b, 1, z, y, x) by the MAC velocity u.
    `window` W >= 1 runs the windowed fast path, None or 0 the exact path
    (`max_trace_steps`: the line trace's fixed step count). `plain=True`
    runs K5's plain version on any device (the exact path has no kernel).
    `z0`: the global index of the first z plane of a slab (the module's
    note).
    `boundary_width` is 1 at every reference call site."""
    del boundary_width
    _check(method)
    if window:
        return advect_scalar_fast(dt, s, u, flags, method,
                                  sample_outside_fluid, maccormack_strength,
                                  window, free=free_space, plain=plain, z0=z0)
    return _advect_scalar_exact(dt, s, u, flags, method,
                                sample_outside_fluid, maccormack_strength,
                                max_trace_steps, int(z0))


def advect_vel(dt, u, flags, method="maccormackOurs",
               maccormack_strength=0.75, boundary_width=1, max_trace_steps=8,
               window=None, free_space=None, plain=False, z0=0):
    """Self-advects the MAC velocity u; `window`, `plain` and `z0` as in
    advect_scalar (3-D with one density channel runs the combined
    advect_fast.advect_vel_scalar_fast instead)."""
    del boundary_width
    _check(method)
    if window:
        return advect_vel_fast(dt, u, flags, method, maccormack_strength,
                               window, free=free_space, plain=plain, z0=z0)
    return _advect_vel_exact(dt, u, flags, method, maccormack_strength,
                             max_trace_steps, int(z0))


def _maccormack_correct_mac(old, fwd, bwd, flags, strength, is_3d):
    """MacCormackCorrectMAC (tfluids.cc:660-699): per component, skip where
    the cell or its -axis neighbour is non-fluid; the neighbour counts as
    fluid at the low edge (the reference tests it only for i > 0)."""
    fl = is_fluid(flags)[:, 0]
    skip_all = ~fl
    skips = [skip_all | ~st.xm(fl, True), skip_all | ~st.ym(fl, True)]
    if is_3d:
        skips.append(skip_all | ~st.zm(fl, True))
    comps = []
    for c, skip in enumerate(skips):
        corr = fwd[:, c] + strength * 0.5 * (old[:, c] - bwd[:, c])
        comps.append(torch.where(skip, fwd[:, c], corr))
    return torch.stack(comps, dim=1)


# --- the exact path: scalars ------------------------------------------------


def _trunc(x):
    """C's float-to-int cast (truncation toward zero), as toInt3."""
    return torch.trunc(x).to(torch.int32)


def _local(k, z0):
    """A global z index as the array's own."""
    return k - z0 if z0 else k


def _semi_lagrange_scalar(s, u, dt, is_3d, z0=0):
    """Manta's SemiLagrange (tfluids.cc:211-220): plain backtrace and
    interpolation."""
    px, py, pz = cell_center_positions(s.shape, s.dtype, s.device, z0)
    cent = get_centered(u, is_3d)
    return interpol(s, px - cent[:, 0] * dt, py - cent[:, 1] * dt,
                    pz - cent[:, 2] * dt, is_3d, z0)


def _trace_backtrace(u, flags, disp_x, disp_y, disp_z, shape, max_steps,
                     z0=0):
    """The line-traced backtrace from every cell centre along the given
    displacement (z0 passed on only when set: a recorded call at origin 0
    is the JAX line trace's, ops/trace_diff.py)."""
    return line_trace(*_positions(shape, u.shape[0], u.dtype, u.device, z0),
                      disp_x, disp_y, disp_z, flags, max_steps=max_steps,
                      **({"z0": z0} if z0 else {}))


def _sample_scalar(s, flags, bx, by, bz, sample_outside_fluid, is_3d, z0=0):
    if sample_outside_fluid:
        return interpol(s, bx, by, bz, is_3d, z0)
    return interpol_with_fluid(s, flags, bx, by, bz, is_3d, z0)


def _euler_ours_scalar(s, u, flags, dt, is_3d, sample_outside_fluid,
                       max_steps, save_pos=False, z0=0):
    """SemiLagrangeEulerOurs[SavePos] (tfluids.cc:152-209)."""
    cent = get_centered(u, is_3d)
    _, bx, by, bz = _trace_backtrace(
        u, flags, -dt * cent[:, 0], -dt * cent[:, 1], -dt * cent[:, 2],
        s.shape, max_steps, z0)
    val = _sample_scalar(s, flags, bx, by, bz, sample_outside_fluid, is_3d,
                         z0)
    fl = is_fluid(flags)
    out = torch.where(fl, val, s)       # non-fluid cells are not advected
    if not save_pos:
        return out
    # Non-fluid cells record their own centre (tfluids.cc:157-160).
    px, py, pz = cell_center_positions(s.shape, s.dtype, s.device, z0)
    return out, (torch.where(fl[:, 0], bx, px), torch.where(fl[:, 0], by, py),
                 torch.where(fl[:, 0], bz, pz))


def _velocity_at(u, hx, hy, hz, is_3d, z0=0):
    """The MAC velocity interpolated at traced positions, per component
    (z zero in 2-D)."""
    vx = interpol_component(u, 0, hx, hy, hz, is_3d, z0)
    vy = interpol_component(u, 1, hx, hy, hz, is_3d, z0)
    vz = interpol_component(u, 2, hx, hy, hz, is_3d, z0) if is_3d \
        else torch.zeros_like(vx)
    return vx, vy, vz


def _rk2_ours_scalar(s, u, flags, dt, is_3d, sample_outside_fluid,
                     max_steps, z0=0):
    """SemiLagrangeRK2Ours (tfluids.cc:23-76)."""
    cent = get_centered(u, is_3d)
    hit1, hx, hy, hz = _trace_backtrace(
        u, flags, -dt * 0.5 * cent[:, 0], -dt * 0.5 * cent[:, 1],
        -dt * 0.5 * cent[:, 2], s.shape, max_steps, z0)
    vx, vy, vz = _velocity_at(u, hx, hy, hz, is_3d, z0)
    _, fx, fy, fz = _trace_backtrace(u, flags, -dt * vx, -dt * vy, -dt * vz,
                                     s.shape, max_steps, z0)
    # A half-step trace that hit a boundary stops at the half position
    # (tfluids.cc:44-53).
    bx = torch.where(hit1, hx, fx)
    by = torch.where(hit1, hy, fy)
    bz = torch.where(hit1, hz, fz)
    val = _sample_scalar(s, flags, bx, by, bz, sample_outside_fluid, is_3d,
                         z0)
    return torch.where(is_fluid(flags), val, s)


def _rk3_ours_scalar(s, u, flags, dt, is_3d, sample_outside_fluid,
                     max_steps, z0=0):
    """SemiLagrangeRK3Ours (tfluids.cc:78-147): Bridson p. 242's RK3."""
    cent = get_centered(u, is_3d)
    k1x, k1y, k1z = cent[:, 0], cent[:, 1], cent[:, 2]
    hit1, p2x, p2y, p2z = _trace_backtrace(
        u, flags, -dt * 0.5 * k1x, -dt * 0.5 * k1y, -dt * 0.5 * k1z,
        s.shape, max_steps, z0)
    k2x, k2y, k2z = _velocity_at(u, p2x, p2y, p2z, is_3d, z0)
    hit2, p3x, p3y, p3z = _trace_backtrace(
        u, flags, -dt * 0.75 * k2x, -dt * 0.75 * k2y, -dt * 0.75 * k2z,
        s.shape, max_steps, z0)
    k3x, k3y, k3z = _velocity_at(u, p3x, p3y, p3z, is_3d, z0)

    def disp(k1, k2, k3):
        return (-dt * (2.0 / 9.0) * k1 - dt * (3.0 / 9.0) * k2 -
                dt * (4.0 / 9.0) * k3)
    _, fx, fy, fz = _trace_backtrace(u, flags, disp(k1x, k2x, k3x),
                                     disp(k1y, k2y, k3y),
                                     disp(k1z, k2z, k3z), s.shape, max_steps,
                                     z0)
    # Truncate to the earlier positions where an intermediate trace hit.
    bx = torch.where(hit1, p2x, torch.where(hit2, p3x, fx))
    by = torch.where(hit1, p2y, torch.where(hit2, p3y, fy))
    bz = torch.where(hit1, p2z, torch.where(hit2, p3z, fz))
    val = _sample_scalar(s, flags, bx, by, bz, sample_outside_fluid, is_3d,
                         z0)
    return torch.where(is_fluid(flags), val, s)


def _corner_minmax(field, pxf, pyf, pzf, is_3d, z0=0):
    """min/max of field (b, 1, Z, Y, X) over the 8 (4) cells around
    trunc(p), clamped as doClampComponent (tfluids.cc:263-287)."""
    Z, Y, X = field.shape[2:]
    i0 = _trunc(pxf).clamp(0, X - 2)
    j0 = _trunc(pyf).clamp(0, Y - 2)
    k0 = _local(_trunc(pzf).clamp(z0, z0 + Z - 2), z0) if is_3d \
        else _trunc(pzf).clamp(0, 1)
    k1 = k0 + 1 if is_3d else k0
    corners = [(i0, j0, k0), (i0 + 1, j0, k0), (i0, j0 + 1, k0),
               (i0 + 1, j0 + 1, k0)]
    if is_3d:
        corners += [(i0, j0, k1), (i0 + 1, j0, k1), (i0, j0 + 1, k1),
                    (i0 + 1, j0 + 1, k1)]
    vals = torch.stack([gather3d(field, *c)[:, 0] for c in corners])
    return vals.amin(0), vals.amax(0)


def _clip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _cells(shape, dtype, device, z0):
    """Integer cell coordinates (pos = vec3(i, j, k), not + 0.5), k from
    the z origin z0."""
    Z, Y, X = shape[2:]
    iz = _iota(Z, 1, dtype, device)
    return (_iota(X, 3, dtype, device), _iota(Y, 2, dtype, device),
            iz + z0 if z0 else iz)


def _maccormack_clamp_manta_scalar(dst, src, fwd, u, flags, dt, is_3d,
                                   z0=0):
    """MacCormackClamp and doClampComponent (tfluids.cc:249-325)."""
    shape = flags.shape
    Z, Y, X = shape[2:]
    cent = get_centered(u, is_3d)
    vx, vy, vz = cent[:, 0] * dt, cent[:, 1] * dt, cent[:, 2] * dt
    ix, iy, iz = _cells(shape, src.dtype, src.device, z0)
    mn_f, mx_f = _corner_minmax(src, ix - vx, iy - vy, iz - vz, is_3d, z0)
    mn_b, mx_b = _corner_minmax(src, ix + vx, iy + vy, iz + vz, is_3d, z0)
    clamped = _clip(dst[:, 0], torch.minimum(mn_f, mn_b),
                    torch.maximum(mx_f, mx_b))

    # Revert to fwd where a (centre-based) lookup leaves the grid or lands
    # in an obstacle (tfluids.cc:304-322).
    ob = is_obstacle(flags).to(src.dtype)

    def lookup_bad(px_i, py_i, pz_i):
        oob = (px_i < 0) | (py_i < 0) | (px_i > X - 1) | (py_i > Y - 1)
        if is_3d:
            oob = oob | (pz_i < z0) | (pz_i > z0 + Z - 1)
        obs = gather3d(ob, px_i.clamp(0, X - 1), py_i.clamp(0, Y - 1),
                       _local(pz_i.clamp(z0, z0 + Z - 1), z0))[:, 0] > 0.5
        return oob | (~oob & obs)

    bad = lookup_bad(_trunc(ix + 0.5 - vx), _trunc(iy + 0.5 - vy),
                     _trunc(iz + 0.5 - vz)) | \
        lookup_bad(_trunc(ix + 0.5 + vx), _trunc(iy + 0.5 + vy),
                   _trunc(iz + 0.5 + vz))
    clamped = torch.where(bad, fwd[:, 0], clamped)
    interior = ~border_mask(shape, is_3d, 1, flags.device)[:, 0]
    return torch.where(interior, clamped, dst[:, 0])[:, None]


def _window_minmax_count(src, flags, sample_outside_fluid, is_3d):
    """Separable 3^d masked min/max/count filters for getClampBounds
    (tfluids.cc:331-374): full-grid fields of the windowed min, max and
    valid-cell count, to be gathered at the traced positions."""
    big = torch.finfo(src.dtype).max
    v = src[:, 0]
    m = torch.ones_like(v, dtype=torch.bool) if sample_outside_fluid \
        else is_fluid(flags)[:, 0]
    mn = torch.where(m, v, big)
    mx = torch.where(m, v, -big)
    cnt = m.to(src.dtype)

    def filt(a, op, fill):
        for ax in ((1, 2, 3) if is_3d else (2, 3)):   # (b, z, y, x) axes
            a = op(op(a, st.shift(a, -1, ax, fill)), st.shift(a, 1, ax, fill))
        return a
    return (filt(mn, torch.minimum, big), filt(mx, torch.maximum, -big),
            filt(cnt, torch.add, 0.0))


def _maccormack_clamp_ours_scalar(dst, src, fwd, flags, fwd_pos,
                                  sample_outside_fluid, is_3d, z0=0):
    """MacCormackClampOurs (tfluids.cc:377-413): clamp the corrected value
    to the min/max of the valid cells in the 3^d window around the forward
    traced position; revert to fwd where the window has no valid cell."""
    Z, Y, X = flags.shape[2:]
    bx, by, bz = fwd_pos
    packed = torch.stack(_window_minmax_count(src, flags,
                                              sample_outside_fluid, is_3d),
                         dim=1)
    i0 = bx.to(torch.int32).clamp(0, X - 1)
    j0 = by.to(torch.int32).clamp(0, Y - 1)
    k0 = _local(bz.to(torch.int32).clamp(z0, z0 + Z - 1), z0) if is_3d \
        else torch.zeros_like(i0)
    g = gather3d(packed, i0, j0, k0)
    clamped = torch.where(g[:, 2] >= 1.0, _clip(dst[:, 0], g[:, 0], g[:, 1]),
                          fwd[:, 0])
    interior = ~border_mask(flags.shape, is_3d, 1, flags.device)[:, 0]
    return torch.where(interior, clamped, dst[:, 0])[:, None]


def _advect_scalar_exact(dt, s, u, flags, method, sample_outside_fluid,
                         strength, max_steps, z0=0):
    is_3d = check_shapes(u, flags, s)
    border = border_mask(flags.shape, is_3d, 1, flags.device)

    def apply_border(x):
        return torch.where(border, 0.0, x)

    args = (s, u, flags, dt, is_3d, sample_outside_fluid, max_steps)
    if method == "euler":
        return apply_border(_semi_lagrange_scalar(s, u, dt, is_3d, z0))
    if method == "eulerOurs":
        return apply_border(_euler_ours_scalar(*args, z0=z0))
    if method == "rk2Ours":
        return apply_border(_rk2_ours_scalar(*args, z0=z0))
    if method == "rk3Ours":
        return apply_border(_rk3_ours_scalar(*args, z0=z0))

    # The MacCormack variants (tfluids.cc:519-584).
    fl = is_fluid(flags)
    if method == "maccormack":
        fwd = apply_border(_semi_lagrange_scalar(s, u, dt, is_3d, z0))
        bwd = apply_border(_semi_lagrange_scalar(fwd, u, -dt, is_3d, z0))
        # MacCormackCorrect runs on every cell (no border skip,
        # tfluids.cc:551).
        dst = fwd + torch.where(fl, strength * 0.5 * (s - bwd), 0.0)
        return _maccormack_clamp_manta_scalar(dst, s, fwd, u, flags, dt,
                                              is_3d, z0)
    fwd_full, fwd_pos = _euler_ours_scalar(*args, save_pos=True, z0=z0)
    fwd = apply_border(fwd_full)
    # Border cells record their own centres (tfluids.cc:482).
    b2 = border[:, 0]
    fwd_pos = tuple(torch.where(b2, c, p) for c, p in zip(
        cell_center_positions(s.shape, s.dtype, s.device, z0), fwd_pos))
    bwd_full, _ = _euler_ours_scalar(fwd, u, flags, -dt, is_3d,
                                     sample_outside_fluid, max_steps,
                                     save_pos=True, z0=z0)
    bwd = apply_border(bwd_full)
    dst = fwd + torch.where(fl, strength * 0.5 * (s - bwd), 0.0)
    return _maccormack_clamp_ours_scalar(dst, s, fwd, flags, fwd_pos,
                                         sample_outside_fluid, is_3d, z0)


# --- the exact path: the MAC velocity ---------------------------------------


def _macs(u, is_3d):
    macs = [get_at_mac_x(u, is_3d), get_at_mac_y(u, is_3d)]
    if is_3d:
        macs.append(get_at_mac_z(u, is_3d))
    return macs


def _semi_lagrange_mac(src, u, dt, is_3d, z0=0):
    """SemiLagrangeMAC (tfluids.cc:634-658): a per-component backtrace from
    the face-centred velocity."""
    px, py, pz = cell_center_positions(src.shape, src.dtype, src.device, z0)
    return torch.stack([
        interpol_component(src, c, px - mac[:, 0] * dt, py - mac[:, 1] * dt,
                           pz - mac[:, 2] * dt, is_3d, z0)
        for c, mac in enumerate(_macs(u, is_3d))], dim=1)


def _euler_ours_mac(src, u, flags, dt, is_3d, max_steps, z0=0):
    """SemiLagrangeEulerOursMAC (tfluids.cc:594-632): a line-traced
    per-component backtrace; non-fluid cells copy src."""
    comps = []
    for c, mac in enumerate(_macs(u, is_3d)):
        _, bx, by, bz = _trace_backtrace(
            u, flags, -dt * mac[:, 0], -dt * mac[:, 1], -dt * mac[:, 2],
            src.shape, max_steps, z0)
        comps.append(interpol_component(src, c, bx, by, bz, is_3d, z0))
    return torch.where(is_fluid(flags), torch.stack(comps, dim=1), src)


def _maccormack_clamp_mac(dst, orig, u, flags, dt, is_3d, z0=0):
    """MacCormackClampMAC (tfluids.cc:701-774): per component,
    doClampComponent against orig around pos -/+ (face velocity * dt)."""
    ix, iy, iz = _cells(flags.shape, orig.dtype, orig.device, z0)
    comps = []
    for c, mac in enumerate(_macs(u, is_3d)):
        vx, vy, vz = mac[:, 0] * dt, mac[:, 1] * dt, mac[:, 2] * dt
        field = orig[:, c:c + 1]
        mn_f, mx_f = _corner_minmax(field, ix - vx, iy - vy, iz - vz, is_3d,
                                    z0)
        mn_b, mx_b = _corner_minmax(field, ix + vx, iy + vy, iz + vz, is_3d,
                                    z0)
        comps.append(_clip(dst[:, c], torch.minimum(mn_f, mn_b),
                           torch.maximum(mx_f, mx_b)))
    interior = ~border_mask(flags.shape, is_3d, 1, flags.device)
    return torch.where(interior, torch.stack(comps, dim=1), dst)


def _advect_vel_exact(dt, u, flags, method, strength, max_steps, z0=0):
    # rk2Ours and rk3Ours fall back to maccormackOurs (tfluids.cc:799-802).
    if method in ("rk2Ours", "rk3Ours"):
        method = "maccormackOurs"
    is_3d = check_shapes(u, flags)
    border = border_mask(flags.shape, is_3d, 1, flags.device)

    def apply_border(x):
        return torch.where(border, 0.0, x)

    if method == "euler":
        return apply_border(_semi_lagrange_mac(u, u, dt, is_3d, z0))
    if method == "eulerOurs":
        return apply_border(_euler_ours_mac(u, u, flags, dt, is_3d,
                                            max_steps, z0))
    if method == "maccormack":
        fwd = apply_border(_semi_lagrange_mac(u, u, dt, is_3d, z0))
        bwd = apply_border(_semi_lagrange_mac(fwd, u, -dt, is_3d, z0))
    else:
        fwd = apply_border(_euler_ours_mac(u, u, flags, dt, is_3d,
                                           max_steps, z0))
        bwd = apply_border(_euler_ours_mac(fwd, u, flags, -dt, is_3d,
                                           max_steps, z0))
    dst = _maccormack_correct_mac(u, fwd, bwd, flags, strength, is_3d)
    return _maccormack_clamp_mac(dst, u, u, flags, dt, is_3d, z0)
