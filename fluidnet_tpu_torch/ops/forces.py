"""Body forces: buoyancy, gravity, vorticity confinement.

Port of fluidnet_tpu.ops.forces (Main_addBuoyancy tfluids.cc:1162-1233,
Main_addGravity :1239-1306, Main_vorticityConfinement :1312-1458) in plain
PyTorch, and `forces_block`, the dispatch of the fused forces block onto
kernel K2 (ops/cuda/forces_kernel.py). A gravity vector is (3,) or, for
per-sample force scales, (B, 3); a confinement strength is a scalar or
(B,).
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_empty, is_fluid
from fluidnet_tpu_torch.core.grids import border_mask, check_shapes, get_dx
from fluidnet_tpu_torch.ops import stencil as st

_VEC3_EPS = 1e-6  # vec3 kEpsilon (generic/vec3.cu.h:21).


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


def add_buoyancy(u, flags, density, gravity, dt):
    """U += 0.5 * strength * (rho(i) + rho(i-1)) on fluid-fluid faces,
    strength = -gravity * dt / dx (tfluids.cc:1190-1191)."""
    is_3d = check_shapes(u, flags, density)
    gravity = torch.as_tensor(gravity, dtype=u.dtype, device=u.device)
    strength = -gravity * (dt / get_dx(flags))

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


def add_gravity(u, flags, gravity, dt):
    """U += gravity * dt / dx on faces between fluid/empty cells
    (tfluids.cc:1280-1300): the current cell is fluid or empty; add
    force.x if fluid(i-1) or (cur fluid and empty(i-1))."""
    is_3d = check_shapes(u, flags)
    gravity = torch.as_tensor(gravity, dtype=u.dtype, device=u.device)
    force = gravity * (dt / get_dx(flags))

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


def vorticity_confinement(u, flags, strength):
    """Adds the vorticity-confinement force (tfluids.cc:1312-1458). The 3-D
    form with a scalar strength is kernel K4 on CUDA tensors
    (ops/cuda/forces_kernel.vorticity_cuda), whose gradient replays
    vorticity_confinement_xla as the JAX custom VJP does (forces_kernel.py
    :670-676); 2-D, per-sample (B,) strengths and CPU tensors run
    vorticity_confinement_xla."""
    if check_shapes(u, flags) and torch.as_tensor(strength).dim() == 0 and \
            u.device.type != "cpu":
        from fluidnet_tpu_torch.ops.cuda.forces_kernel import vorticity_cuda
        from fluidnet_tpu_torch.ops.replay import replay
        return replay(lambda x: vorticity_cuda(x, flags, strength),
                      lambda x: vorticity_confinement_xla(x, flags, strength),
                      u)
    return vorticity_confinement_xla(u, flags, strength)


def forces_block_xla(u, flags, density, buoy_g, grav_g, amp, dt):
    """The simulate() forces block as one composition: buoyancy -> gravity
    -> vorticity confinement (simulate.lua:216-239 ordering). Zero scales
    are exact no-ops. Keeps the JAX name; K2's forces-block form is
    checked against it."""
    u = add_buoyancy(u, flags, density, buoy_g, dt)
    u = add_gravity(u, flags, grav_g, dt)
    return vorticity_confinement_xla(u, flags, amp)


def forces_block(u, flags, density, buoy_g, grav_g, amp, dt):
    """The fused forces block (JAX ops/forces.py:202-214). 3-D with one
    (3,) gravity vector per force and a scalar amp runs K2's forces-block
    form (ops/cuda/forces_kernel.forces_block_cuda) on CUDA tensors, its
    gradient replaying forces_block_xla (forces_kernel.py:645-653); CPU
    tensors, 2-D and per-sample scales ((B, 3) vectors, an amp of ndim > 0)
    run forces_block_xla."""
    batched = (torch.as_tensor(buoy_g).dim() > 1 or
               torch.as_tensor(grav_g).dim() > 1 or
               torch.as_tensor(amp).dim() > 0)
    if check_shapes(u, flags, density) and not batched and \
            u.device.type != "cpu":
        from fluidnet_tpu_torch.ops.cuda.forces_kernel import \
            forces_block_cuda
        from fluidnet_tpu_torch.ops.replay import replay
        return replay(
            lambda x, r: forces_block_cuda(x, flags, r, buoy_g, grav_g, amp,
                                           dt),
            lambda x, r: forces_block_xla(x, flags, r, buoy_g, grav_g, amp,
                                          dt), u, density)
    return forces_block_xla(u, flags, density, buoy_g, grav_g, amp, dt)


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
