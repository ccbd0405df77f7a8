"""K2: the fused projection prologue and the fused forces block.

Replaces fluidnet_tpu/ops/pallas/forces_kernel.py::_fb_kernel in both its
forms, one CUDA kernel template (csrc/prologue.cu):

  - prologue_cuda: the prologue form (epi=True, has_ubc), as launched by
    _pro_pallas_impl: one launch per ConvNet step. Slab BC -> buoyancy ->
    gravity -> vorticity confinement -> slab BC -> setWallBcs ->
    divergence. Counted in _build.launches["prologue"].
  - forces_block_cuda: the forces-block form (epi=False), as launched by
    _fb_pallas_impl: one launch per jacobi or PCG step. Buoyancy ->
    gravity -> vorticity confinement only. Counted in
    _build.launches["forces_block"].

The source note of csrc/prologue.cu gives what bounds it on the H100
(reuse across dependent stencils: 32 / 36 B/cell compulsory, ~40 field
passes as separate ops) and the design (8^3 output tile over a 16^3
shared-memory tile with a halo of 4, stages separated by barriers).

ops.prologue.projection_prologue and ops.forces.forces_block take the
plain PyTorch versions (prologue_plain, ops.forces.forces_block_xla) for
CPU tensors and launch the kernel for CUDA tensors; nothing else chooses.
"""

import torch

from fluidnet_tpu_torch.core.grids import get_dx
from fluidnet_tpu_torch.ops.boundary import set_wall_bcs
from fluidnet_tpu_torch.ops.cuda import _build
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.forces import forces_block_xla


def slab(field, bc, inv):
    """The frozen slab BC of sim.simulate.apply_boundaries: value * inv +
    bc on the leading bc.shape[3] y-rows, the rest untouched."""
    yb = bc.shape[3]
    if yb == field.shape[3]:
        return field * inv + bc
    return torch.cat([field[:, :, :, :yb] * inv + bc, field[:, :, :, yb:]],
                     dim=3)


def prologue_plain(u, flags, density, buoy_g, grav_g, amp, dt, u_bc=None,
                   u_inv=None):
    """Plain PyTorch version of K2 (runs on any device): the unfused
    composition the kernel replaces, in simulate()'s order. Returns
    (u'', div)."""
    if u_bc is not None:
        u = slab(u, u_bc, u_inv)
    u = forces_block_xla(u, flags, density, buoy_g, grav_g, amp, dt)
    if u_bc is not None:
        u = slab(u, u_bc, u_inv)
    u = set_wall_bcs(u, flags)
    return u, velocity_divergence(u, flags)


def scal7(buoy_g, grav_g, amp, dt, flags):
    """The kernel's 7 scalars [bx, by, bz, gx, gy, gz, amp]: add_buoyancy's
    per-face strength -buoy_g * dt / dx, add_gravity's force
    grav_g * dt / dx, and the confinement strength (prologue.py:62-68)."""
    dx = get_dx(flags)
    f32 = torch.float32
    buoy_g = torch.as_tensor(buoy_g, dtype=f32).cpu().expand(3)
    grav_g = torch.as_tensor(grav_g, dtype=f32).cpu().expand(3)
    amp = torch.as_tensor(amp, dtype=f32).cpu().reshape(1)
    return torch.cat([-buoy_g * (dt / dx), grav_g * (dt / dx), amp]).tolist()


def _check_args(name, u, flags, density):
    if u.dim() != 5 or u.shape[1] != 3:
        raise ValueError(f"{name}: u must be (b, 3, z, y, x), got "
                         f"{tuple(u.shape)}")
    B, _, Z, Y, X = u.shape
    if tuple(flags.shape) != (B, 1, Z, Y, X) or \
            tuple(density.shape) != (B, 1, Z, Y, X):
        raise ValueError(f"{name}: flags/density must be (b, 1, z, y, x)")
    if min(Z, Y, X) < 2 or B * 4 * Z * Y * X >= 2 ** 31:
        raise ValueError(f"{name}: unsupported shape {tuple(u.shape)}")
    return B, Z, Y, X


def _launch(u, flags, density, u_bc, u_inv, out, YB, epi, sc):
    B, _, Z, Y, X = u.shape
    dev = u.device
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fluidnet_prologue(
            u.data_ptr(), flags.data_ptr(), density.data_ptr(),
            u_bc.data_ptr() if u_bc is not None else None,
            u_inv.data_ptr() if u_inv is not None else None, out.data_ptr(),
            B, Z, Y, X, YB, int(epi), *sc,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fluidnet_prologue")


def prologue_cuda(u, flags, density, buoy_g, grav_g, amp, dt, u_bc=None,
                  u_inv=None):
    """Launches K2's prologue form on CUDA tensors: same arguments and
    result as prologue_plain. u (b,3,Z,Y,X) f32, flags (b,1,Z,Y,X) int32,
    density (b,1,Z,Y,X) f32; u_bc/u_inv: frozen slab masks (b,3,Z,YB,X)
    or None."""
    B, Z, Y, X = _check_args("prologue", u, flags, density)
    f32 = torch.float32
    has_ubc = u_bc is not None
    args = [u, flags, density] + ([u_bc, u_inv] if has_ubc else [])
    dev = _build.require_cuda("prologue", *args,
                              dtypes=[f32, torch.int32, f32, f32, f32])
    YB = u_bc.shape[3] if has_ubc else 0
    if has_ubc and (tuple(u_bc.shape) != (B, 3, Z, YB, X) or
                    u_inv.shape != u_bc.shape or YB > Y):
        raise ValueError(f"prologue: slab masks of shape "
                         f"{tuple(u_bc.shape)} do not fit u {tuple(u.shape)}")
    sc = scal7(buoy_g, grav_g, amp, dt, flags)
    out = torch.empty((B, 4, Z, Y, X), device=dev, dtype=f32)
    _launch(u, flags, density, u_bc, u_inv, out, YB, True, sc)
    _build.launches["prologue"] += 1
    return out[:, 0:3], out[:, 3:4]


def forces_block_cuda(u, flags, density, buoy_g, grav_g, amp, dt):
    """Launches K2's forces-block form on CUDA tensors: same arguments and
    result as ops.forces.forces_block_xla with (3,) gravity vectors and a
    scalar amp. u (b,3,Z,Y,X) f32, flags (b,1,Z,Y,X) int32, density
    (b,1,Z,Y,X) f32. Returns u' (b,3,Z,Y,X)."""
    B, Z, Y, X = _check_args("forces_block", u, flags, density)
    f32 = torch.float32
    dev = _build.require_cuda("forces_block", u, flags, density,
                              dtypes=[f32, torch.int32, f32])
    sc = scal7(buoy_g, grav_g, amp, dt, flags)
    out = torch.empty((B, 3, Z, Y, X), device=dev, dtype=f32)
    _launch(u, flags, density, None, None, out, 0, False, sc)
    _build.launches["forces_block"] += 1
    return out
