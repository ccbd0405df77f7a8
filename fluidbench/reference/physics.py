"""Frozen copy of the plain PyTorch ops of fluidnet_tpu_torch at commit
a3725f6 (ops/interp.py, ops/forces.py, ops/boundary.py,
ops/divergence.py, ops/velocity_update.py, ops/cuda/forces_kernel.py),
kept here so that the benchmark's reference does not move with the
program. Edits: the kernel dispatch is gone (every op runs its plain
version, on any device), and the grid masks are built on the device they
are asked for.
"""

import functools

import torch

from fluidbench.reference import grid as st
from fluidbench.reference.grid import (border_mask, check_shapes, get_dx,
                                       is_empty, is_fluid, is_obstacle,
                                       is_outflow, is_stick)

_VEC3_EPS = 1e-6  # vec3 kEpsilon (generic/vec3.cu.h:21).


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


def cell_center_positions(shape, dtype=torch.float32, device=None, z0=0):
    """(px, py, pz) tensors of cell-center coordinates, each (1, z, y, x),
    on `device`; built once per shape, dtype, device and z
    origin (they are read-only expanded views). z0 is the global index of
    the first z plane (a slab of a z-sharded grid): pz = z0 + k + 0.5."""
    _, _, Z, Y, X = shape
    return _cell_centers(int(Z), int(Y), int(X), dtype,
                         torch.device(device or "cpu"), int(z0))


@functools.lru_cache(maxsize=64)
def _cell_centers(Z, Y, X, dtype, device, z0):
    px = torch.arange(X, dtype=dtype, device=device).view(1, 1, 1, X) + 0.5
    py = torch.arange(Y, dtype=dtype, device=device).view(1, 1, Y, 1) + 0.5
    pz = torch.arange(z0, z0 + Z, dtype=dtype,
                      device=device).view(1, Z, 1, 1) + 0.5
    return (px.expand(1, Z, Y, X), py.expand(1, Z, Y, X),
            pz.expand(1, Z, Y, X))


def _gcomp(gravity, c):
    """Component c of a (3,) or (B, 3) gravity vector, shaped to broadcast
    against (B, z, y, x) fields."""
    if gravity.dim() == 1:
        return gravity[c]
    return gravity[:, c].reshape(-1, 1, 1, 1)


def _samp(strength, like):
    """A scalar or (B,) confinement strength, shaped to broadcast against
    (B, z, y, x) fields."""
    s = torch.as_tensor(strength, dtype=like.dtype, device=like.device)
    if s.dim() == 0:
        return s
    return s.reshape(s.shape + (1, 1, 1))


def add_buoyancy(u, flags, density, gravity, dt, dx=None):
    """U += 0.5 * strength * (rho(i) + rho(i-1)) on fluid-fluid faces,
    strength = -gravity * dt / dx (tfluids.cc:1190-1191)."""
    is_3d = check_shapes(u, flags, density)
    gravity = torch.as_tensor(gravity, dtype=u.dtype, device=u.device)
    strength = -gravity * (dt / (get_dx(flags) if dx is None else dx))

    fl = is_fluid(flags)[:, 0]
    interior = ~border_mask(flags.shape, is_3d, 1, u.device)[:, 0]
    rho = density[:, 0]

    def face(uc, s, fl_m, rho_m):
        add = 0.5 * s * (rho + rho_m)
        return torch.where(fl & fl_m & interior, uc + add, uc)

    ux = face(u[:, 0], _gcomp(strength, 0), st.xm(fl, False), st.xm(rho))
    uy = face(u[:, 1], _gcomp(strength, 1), st.ym(fl, False), st.ym(rho))
    if is_3d:
        uz = face(u[:, 2], _gcomp(strength, 2), st.zm(fl, False),
                  st.zm(rho))
        return torch.stack([ux, uy, uz], dim=1)
    return torch.stack([ux, uy], dim=1)


def add_gravity(u, flags, gravity, dt, dx=None):
    """U += gravity * dt / dx on faces between fluid/empty cells
    (tfluids.cc:1280-1300): the current cell is fluid or empty; add
    force.x if fluid(i-1) or (cur fluid and empty(i-1))."""
    is_3d = check_shapes(u, flags)
    gravity = torch.as_tensor(gravity, dtype=u.dtype, device=u.device)
    force = gravity * (dt / (get_dx(flags) if dx is None else dx))

    fl = is_fluid(flags)[:, 0]
    em = is_empty(flags)[:, 0]
    cur = (fl | em) & ~border_mask(flags.shape, is_3d, 1, u.device)[:, 0]

    def face(uc, f, fl_m, em_m):
        return torch.where(cur & (fl_m | (fl & em_m)), uc + f, uc)

    ux = face(u[:, 0], _gcomp(force, 0), st.xm(fl, False), st.xm(em, False))
    uy = face(u[:, 1], _gcomp(force, 1), st.ym(fl, False), st.ym(em, False))
    if is_3d:
        uz = face(u[:, 2], _gcomp(force, 2), st.zm(fl, False),
                  st.zm(em, False))
        return torch.stack([ux, uy, uz], dim=1)
    return torch.stack([ux, uy], dim=1)


def get_centered(u, is_3d):
    """Cell-centered velocity from MAC faces (grid.cc:346-356), zero on the
    1-cell border. Returns (b, 3, z, y, x)."""
    cx = 0.5 * (u[:, 0] + st.xp(u[:, 0]))
    cy = 0.5 * (u[:, 1] + st.yp(u[:, 1]))
    if is_3d:
        cz = 0.5 * (u[:, 2] + st.zp(u[:, 2]))
    else:
        cz = torch.zeros_like(cx)
    c = torch.stack([cx, cy, cz], dim=1)
    interior = ~border_mask(u.shape, is_3d, 1, u.device)
    return torch.where(interior, c, 0.0)


def _curl(cent, is_3d):
    """Central-difference curl of a centered vector field
    (grid.cc:497-515). 2-D returns the scalar curl in the z component."""
    x, y, z = cent[:, 0], cent[:, 1], cent[:, 2]
    cz = 0.5 * ((st.xp(y) - st.xm(y)) - (st.yp(x) - st.ym(x)))
    if is_3d:
        cx = 0.5 * ((st.yp(z) - st.ym(z)) - (st.zp(y) - st.zm(y)))
        cy = 0.5 * ((st.zp(x) - st.zm(x)) - (st.xp(z) - st.xm(z)))
    else:
        cx = torch.zeros_like(cz)
        cy = torch.zeros_like(cz)
    return torch.stack([cx, cy, cz], dim=1)


def _norm3(sq):
    """vec3::norm: 0 at or below kEpsilon (vec3.cu.h:119-127)."""
    nz = sq > _VEC3_EPS
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)


def vorticity_confinement_xla(u, flags, strength):
    """Vorticity confinement in 4 passes like the reference: centered vel
    -> curl + |curl| -> force = strength * (grad_hat|w| x w) -> face-wise
    AddForceField apply (tfluids.cc:1312-1458). Keeps the JAX name."""
    is_3d = check_shapes(u, flags)
    interior5 = ~border_mask(flags.shape, is_3d, 1, u.device)
    interior = interior5[:, 0]

    curl = torch.where(interior5, _curl(get_centered(u, is_3d), is_3d), 0.0)
    norm_sq = curl[:, 0] * curl[:, 0] + curl[:, 1] * curl[:, 1] + \
        curl[:, 2] * curl[:, 2]
    curl_norm = torch.where(interior, _norm3(norm_sq), 0.0)

    gx = 0.5 * (st.xp(curl_norm) - st.xm(curl_norm))
    gy = 0.5 * (st.yp(curl_norm) - st.ym(curl_norm))
    if is_3d:
        gz = 0.5 * (st.zp(curl_norm) - st.zm(curl_norm))
    else:
        gz = torch.zeros_like(gx)
    g_norm = _norm3(gx * gx + gy * gy + gz * gz)
    safe = g_norm > _VEC3_EPS
    inv = torch.where(safe, 1.0 / torch.where(safe, g_norm, 1.0), 0.0)
    gx, gy, gz = gx * inv, gy * inv, gz * inv

    s = _samp(strength, u)
    fx = (gy * curl[:, 2] - gz * curl[:, 1]) * s
    fy = (gz * curl[:, 0] - gx * curl[:, 2]) * s
    fz = (gx * curl[:, 1] - gy * curl[:, 0]) * s
    force = torch.where(interior5, torch.stack([fx, fy, fz], dim=1), 0.0)
    return _add_force_field(u, flags, force, is_3d)


def forces_block_xla(u, flags, density, buoy_g, grav_g, amp, dt, dx=None):
    """The simulate() forces block as one composition: buoyancy -> gravity
    -> vorticity confinement (simulate.lua:216-239 ordering). Zero scales
    are exact no-ops. Keeps the JAX name; K2's forces-block form is
    checked against it."""
    u = add_buoyancy(u, flags, density, buoy_g, dt, dx)
    u = add_gravity(u, flags, grav_g, dt, dx)
    return vorticity_confinement_xla(u, flags, amp)


def _add_force_field(u, flags, force, is_3d):
    """AddForceField (tfluids.cc:1312-1339): face-averaged force apply with
    the same fluid/empty gating as add_gravity, interior only."""
    fl = is_fluid(flags)[:, 0]
    em = is_empty(flags)[:, 0]
    cur = (fl | em) & ~border_mask(flags.shape, is_3d, 1, u.device)[:, 0]

    def face(uc, fc, fl_m, em_m, f_m):
        m = cur & (fl_m | (fl & em_m))
        return torch.where(m, uc + 0.5 * (f_m + fc), uc)

    ux = face(u[:, 0], force[:, 0], st.xm(fl, False), st.xm(em, False),
              st.xm(force[:, 0]))
    uy = face(u[:, 1], force[:, 1], st.ym(fl, False), st.ym(em, False),
              st.ym(force[:, 1]))
    if is_3d:
        uz = face(u[:, 2], force[:, 2], st.zm(fl, False), st.zm(em, False),
                  st.zm(force[:, 2]))
        return torch.stack([ux, uy, uz], dim=1)
    return torch.stack([ux, uy], dim=1)


def set_wall_bcs(u, flags):
    """Returns U with wall boundary conditions applied.

    For every cell that is fluid or obstacle (others untouched):
      - u.x(i) = 0 if i > 0 and obstacle(i-1)
      - u.x(i) = 0 if i > 0 and cur is obstacle and fluid(i-1)
      (same for y with j, z with k)
    For fluid cells next to TypeStick cells, tangential components zero.
    """
    is_3d = check_shapes(u, flags)

    fl = is_fluid(flags)
    ob = is_obstacle(flags)
    stick = is_stick(flags)
    cur = fl | ob

    # "i > 0" is implicit: shifted masks fill False at the low edge.
    zero_x = cur & (st.xm(ob, False) | (ob & st.xm(fl, False)))
    zero_y = cur & (st.ym(ob, False) | (ob & st.ym(fl, False)))
    stick_xpm = st.xm(stick, False) | st.xp(stick, False)
    stick_ypm = st.ym(stick, False) | st.yp(stick, False)

    ux = torch.where(zero_x[:, 0], 0.0, u[:, 0])
    uy = torch.where(zero_y[:, 0], 0.0, u[:, 1])
    ux = torch.where((fl & stick_ypm)[:, 0], 0.0, ux)
    uy = torch.where((fl & stick_xpm)[:, 0], 0.0, uy)

    if is_3d:
        zero_z = cur & (st.zm(ob, False) | (ob & st.zm(fl, False)))
        stick_zpm = st.zm(stick, False) | st.zp(stick, False)
        uz = torch.where(zero_z[:, 0], 0.0, u[:, 2])
        uz = torch.where((fl & (stick_xpm | stick_ypm))[:, 0], 0.0, uz)
        ux = torch.where((fl & stick_zpm)[:, 0], 0.0, ux)
        uy = torch.where((fl & stick_zpm)[:, 0], 0.0, uy)
        return torch.stack([ux, uy, uz], dim=1)
    return torch.stack([ux, uy], dim=1)


def velocity_divergence(u, flags):
    """Returns div of shape (b, 1, z, y, x)."""
    is_3d = check_shapes(u, flags)

    ux, uy = u[:, 0:1], u[:, 1:2]
    div = (ux - st.xp(ux)) + (uy - st.yp(uy))
    if is_3d:
        uz = u[:, 2:3]
        div = div + (uz - st.zp(uz))

    keep = is_fluid(flags) & ~border_mask(flags.shape, is_3d, 1, u.device)
    return torch.where(keep, div, 0.0)


def velocity_update(u, flags, p):
    """Returns the updated MAC velocity U' = U - grad(p) with BC handling."""
    is_3d = check_shapes(u, flags, p)

    fl = is_fluid(flags)[:, 0]
    em = is_empty(flags)[:, 0]
    out = is_outflow(flags)[:, 0]
    interior = ~border_mask(flags.shape, is_3d, 1, u.device)[:, 0]

    pc = p[:, 0]
    cur_empty_upd = em & ~out & interior

    def face(uc, fl_m, em_m, p_m):
        upd = torch.where(fl & fl_m & interior, uc - (pc - p_m), uc)
        upd = torch.where(fl & em_m & interior, upd - pc, upd)
        upd = torch.where(cur_empty_upd & fl_m, upd + p_m, upd)
        return torch.where(cur_empty_upd & ~fl_m, 0.0, upd)

    ux = face(u[:, 0], st.xm(fl, False), st.xm(em, False), st.xm(pc))
    uy = face(u[:, 1], st.ym(fl, False), st.ym(em, False), st.ym(pc))
    if is_3d:
        uz = face(u[:, 2], st.zm(fl, False), st.zm(em, False), st.zm(pc))
        return torch.stack([ux, uy, uz], dim=1)
    return torch.stack([ux, uy], dim=1)


def slab(field, bc, inv):
    """The frozen slab BC of sim.simulate.apply_boundaries: value * inv +
    bc on the leading bc.shape[3] y-rows, the rest untouched."""
    yb = bc.shape[3]
    if yb == field.shape[3]:
        return field * inv + bc
    return torch.cat([field[:, :, :, :yb] * inv + bc, field[:, :, :, yb:]],
                     dim=3)


def prologue_plain(u, flags, density, buoy_g, grav_g, amp, dt, u_bc=None,
                   u_inv=None, dx=None):
    """Plain PyTorch version of K2 (runs on any device): the unfused
    composition the kernel replaces, in simulate()'s order; `dx` as
    ops.forces'. Returns (u'', div)."""
    if u_bc is not None:
        u = slab(u, u_bc, u_inv)
    u = forces_block_xla(u, flags, density, buoy_g, grav_g, amp, dt, dx)
    if u_bc is not None:
        u = slab(u, u_bc, u_inv)
    u = set_wall_bcs(u, flags)
    return u, velocity_divergence(u, flags)
