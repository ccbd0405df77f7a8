"""The time-integration loop: advect -> forces -> project.

Port of fluidnet_tpu.sim.simulate, mirroring simulate.lua:175-327.

3-D, with both fused knobs on (FLUIDNET_FUSED_EPILOGUE /
FLUIDNET_FUSED_PROLOGUE default ON in the JAX package), one step is:

  1. Chebyshev free space (constant flags: computed once per rollout)
  2. forward + backward MacCormack sweep (K1, 2 launches), final clamp
  3. ConvNet: slab BCs on p and density; the projection prologue (K2):
     u slab BC, buoyancy, gravity, vorticity confinement, u slab BC,
     setWallBcs, divergence; the ConvNet on that divergence; with
     polish_iters > 0, that many Jacobi sweeps (K3) on its residual
     divergence, the velocity update and p += dp.
     Jacobi / PCG: slab BCs on u, p and density; the forces block (K2
     forces-block form); setWallBcs; the slab BCs again; the divergence;
     the solve (K3 fixed sweeps, or matrix-free PCG in PyTorch); the
     velocity update.
  4. slab BCs again, velocity clipped to +-1e6

2-D (the interactive demo's step, any number of density channels):

  1. the window: with adaptive_window, W = 1 when max|u| dt <= 1 - 1e-3,
     else advection_window (one host read per step)
  2. each density channel advected on its own, then the velocity, every
     interpolation through the windowed warp (K5)
  3. BCs; buoyancy, gravity and vorticity confinement unfused, in PyTorch
  4. the projection: setWallBcs (solvers), BCs, then the ConvNet (plus
     polish_iters Jacobi sweeps, K3), or jacobi (K3) / PCG with the
     velocity update; BCs again, velocity clipped to +-1e6

Inference only (torch.no_grad). The other branches of the JAX simulate()
raise NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState, get_dx
from fluidnet_tpu_torch.ops.advect import advect_scalar, advect_vel
from fluidnet_tpu_torch.ops.advect_fast import (advect_vel_scalar_fast,
                                                chebyshev_free_space)
from fluidnet_tpu_torch.ops.boundary import set_wall_bcs
from fluidnet_tpu_torch.ops.cuda.forces_kernel import slab
from fluidnet_tpu_torch.ops.cuda.mac_sweep import (advect_sweep_fused_ep,
                                                   sweep_fused_ep_plain)
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.forces import (add_buoyancy, add_gravity,
                                           forces_block, forces_block_xla,
                                           vorticity_confinement)
from fluidnet_tpu_torch.ops.prologue import (projection_prologue,
                                             prologue_ref)
from fluidnet_tpu_torch.ops.velocity_update import velocity_update
from fluidnet_tpu_torch.solvers.cg import solve_pcg
from fluidnet_tpu_torch.solvers.components import connected_components
from fluidnet_tpu_torch.solvers.cuda_jacobi import jacobi_plain
from fluidnet_tpu_torch.solvers.jacobi import solve_jacobi

U_CLAMP = 1e6  # blow-up containment (simulate.lua:323-326)


@dataclasses.dataclass(frozen=True)
class Boundaries:
    """Frozen boundary-condition masks (simulate.lua:125-160 setConstVals):
    value' = value * inv_mask + bc. All fields optional. A pair whose
    y-extent is smaller than the field's applies to the leading y-rows
    only (the plume inflow touches 4 rows)."""
    u_bc: Optional[torch.Tensor] = None
    u_bc_inv_mask: Optional[torch.Tensor] = None
    p_bc: Optional[torch.Tensor] = None
    p_bc_inv_mask: Optional[torch.Tensor] = None
    density_bc: Optional[torch.Tensor] = None
    density_bc_inv_mask: Optional[torch.Tensor] = None


def apply_boundaries(state: FluidState, bcs: Optional[Boundaries]):
    if bcs is None:
        return state
    u, p, density = state.u, state.p, state.density
    if bcs.u_bc is not None:
        u = slab(u, bcs.u_bc, bcs.u_bc_inv_mask)
    if bcs.p_bc is not None:
        p = slab(p, bcs.p_bc, bcs.p_bc_inv_mask)
    if bcs.density_bc is not None and density is not None:
        density = slab(density, bcs.density_bc, bcs.density_bc_inv_mask)
    return state.replace(u=u, p=p, density=density)


def create_plume_bcs(state: FluidState, density_val, u_scale: float,
                     rad: float) -> Boundaries:
    """Plume inflow at the domain bottom (simulate.lua:47-123).

    U = (0, u_scale, 0) and density = density_val inside a circle of radius
    `rad * xdim` in the bottom 4 rows; velocity frozen to 0 outside the
    circle in those rows. Masks are slab-sized: (b, c, z, min(4, y), x).
    """
    u, density = state.u, state.density
    if density is None:
        raise ValueError("plume BCs require a density field")
    b, cu, Z, Y, X = u.shape
    dev = u.device
    if not isinstance(density_val, (list, tuple)):
        density_val = [density_val]
    if len(density_val) != density.shape[1]:
        raise ValueError("one plume density value per density channel")

    center_x = X // 2
    center_z = max(Z // 2, 1)
    plume_rad = int(X * rad)
    YB = min(4, Y)
    xi = torch.arange(X, device=dev).view(1, 1, 1, 1, X)
    zi = torch.arange(Z, device=dev).view(1, 1, Z, 1, 1)
    dx_ = (center_x - 1) - xi   # the reference's 1-based centerX - x
    dz_ = (center_z - 1) - zi
    in_circle = ((dx_ * dx_ + dz_ * dz_) <= plume_rad * plume_rad).expand(
        1, 1, Z, YB, X)

    vec = [0.0, float(u_scale)] + ([0.0] if cu == 3 else [])
    u_bc = torch.cat([torch.where(in_circle, v, 0.0).to(u.dtype)
                      for v in vec], dim=1)
    u_bc = u_bc.expand(b, cu, Z, YB, X).contiguous()
    u_inv = torch.zeros((b, cu, Z, YB, X), dtype=u.dtype, device=dev)
    d_bc = torch.cat([torch.where(in_circle, float(v), 0.0).to(density.dtype)
                      for v in density_val], dim=1)
    d_bc = d_bc.expand(b, density.shape[1], Z, YB, X).contiguous()
    d_inv = torch.where(in_circle, 0.0, 1.0).to(density.dtype).expand(
        b, density.shape[1], Z, YB, X).contiguous()
    return Boundaries(u_bc=u_bc, u_bc_inv_mask=u_inv,
                      density_bc=d_bc, density_bc_inv_mask=d_inv)


@dataclasses.dataclass(frozen=True)
class _Forces:
    """dt and the force scales of one step: simulate()'s overrides, else
    mconf's, with the JAX has_* logic (simulate.py:170-181): a force runs
    when its override is given (a zero one is an exact no-op) or when
    mconf's scale is positive."""
    dt: object
    b_scale: object
    g_scale: object
    v_amp: object
    has_buoy: bool
    has_grav: bool
    has_vc: bool


def _resolve_forces(state, mconf, dt, buoyancy_scale, gravity_scale,
                    vorticity_amp):
    return _Forces(
        dt=mconf.dt if dt is None else dt,
        b_scale=mconf.buoyancy_scale if buoyancy_scale is None
        else buoyancy_scale,
        g_scale=mconf.gravity_scale if gravity_scale is None
        else gravity_scale,
        v_amp=mconf.vorticity_confinement_amp if vorticity_amp is None
        else vorticity_amp,
        has_buoy=state.density is not None and (
            buoyancy_scale is not None or mconf.buoyancy_scale > 0),
        has_grav=gravity_scale is not None or mconf.gravity_scale > 0,
        has_vc=vorticity_amp is not None or
        mconf.vorticity_confinement_amp > 0)


def _check_slice(state: FluidState, mconf: ModelConfig, model, forces):
    """Raises NotImplementedError for the simulate() branches not ported."""
    if mconf.sim_method not in ("convnet", "jacobi", "pcg"):
        raise ValueError(f"bad sim_method {mconf.sim_method}")
    if mconf.sim_method == "convnet" and model is None:
        raise ValueError("the convnet sim method needs a model")
    if not mconf.advection_window:
        raise NotImplementedError("the exact gather advection (window 0) is "
                                  "not ported (ROADMAP queue 1, ops off the "
                                  "main path)")
    if not state.is_3d:
        return
    if mconf.adaptive_window and mconf.advection_window > 1:
        raise NotImplementedError("the adaptive advection window in 3-D is "
                                  "not ported yet (ROADMAP queue 1, ops off "
                                  "the main path); set adaptive_window="
                                  "False")
    if state.density is None and forces.has_vc:
        raise NotImplementedError("a 3-D step without density runs the "
                                  "standalone vorticity confinement (K4), "
                                  "not ported yet (ROADMAP queue 1, "
                                  "training slice)")
    if state.density is None or state.density.shape[1] != 1 or \
            mconf.advection_method == "maccormack":
        raise NotImplementedError("3-D advection is ported on the fused "
                                  "sweep only: one density channel, "
                                  "maccormackOurs / euler / eulerOurs "
                                  "(ROADMAP queue 1, K1 unfused)")


def simulate(state: FluidState, mconf: ModelConfig, model=None,
             bcs: Optional[Boundaries] = None,
             use_kernels: bool = True, dt=None, buoyancy_scale=None,
             gravity_scale=None, vorticity_amp=None,
             consts: Optional["FlagConsts"] = None) -> FluidState:
    """One simulation step with the projection mconf.sim_method: "convnet"
    (the ConvNet `model`, a models.fluidnet.FluidNet, plus mconf.
    polish_iters Jacobi sweeps), "jacobi" (mconf.max_iter fixed sweeps)
    or "pcg" (mconf.max_iter, mconf.pcg_tol); `model` may be None for the
    last two. `use_kernels=False` runs every kernel's plain PyTorch
    version instead, on whatever device the state lives: the reference
    the kernels are checked against.

    `dt`, `buoyancy_scale`, `gravity_scale` and `vorticity_amp` override
    mconf's (floats or 0-d tensors); a given force runs even at zero, as
    in JAX. `consts`: a FlagConsts reused across steps while the flags
    stay the same (the interactive server keeps one); None computes the
    flag-derived fields anew."""
    forces = _resolve_forces(state, mconf, dt, buoyancy_scale,
                             gravity_scale, vorticity_amp)
    _check_slice(state, mconf, model, forces)
    with torch.no_grad():
        return _step(state, mconf, model, bcs,
                     FlagConsts() if consts is None else consts,
                     use_kernels, forces)


@dataclasses.dataclass
class FlagConsts:
    """Fields that depend on the flags alone, which do not change within
    a rollout: computed at the first step that needs them. free_space maps
    the free-space cap (window + 1) to its field; labels are PCG's
    connected components."""
    free_space: dict = dataclasses.field(default_factory=dict)
    labels: Optional[torch.Tensor] = None

    def free(self, flags, max_d: int):
        if max_d not in self.free_space:
            self.free_space[max_d] = chebyshev_free_space(flags, max_d)
        return self.free_space[max_d]


def _forces_config(mconf, dx, forces):
    """(buoy_g, grav_g, amp) of simulate.lua:216-239, on the host: the 3-D
    kernels take them as launch arguments, the 2-D force ops as tensors."""
    g_vec = torch.tensor([0.0, 1.0, 0.0] if mconf.gravity is None
                         else list(mconf.gravity), dtype=torch.float32)
    zero3 = torch.zeros(3)
    buoy_g = g_vec * (-(dx / 4.0) * float(forces.b_scale)) \
        if forces.has_buoy else zero3
    grav_g = g_vec * (-(dx / 4.0) * float(forces.g_scale)) \
        if forces.has_grav else zero3
    amp = torch.tensor(float(forces.v_amp)) * dx if forces.has_vc \
        else torch.zeros(())
    return buoy_g, grav_g, amp


def _fixed_jacobi(flags, div, n_sweeps, use_kernels):
    """n fixed Jacobi sweeps from 0: K3 through solve_jacobi(p_tol=0), or
    K3's plain version."""
    if use_kernels:
        return solve_jacobi(flags, div, p_tol=0.0, max_iter=n_sweeps)[0]
    return jacobi_plain(flags, div, n_sweeps)


def _step(state, mconf, model, bcs, consts, use_kernels, forces):
    if not state.is_3d:
        return _step_2d(state, mconf, model, bcs, consts, use_kernels,
                        forces)
    dt = forces.dt
    u, flags, density = state.u, state.flags, state.density
    dx = get_dx(flags)
    W = mconf.advection_window
    free = consts.free(flags, W + 1) \
        if mconf.advection_method.endswith("Ours") else None

    # 1.+2. Advection: density and all three MAC components, fused.
    density, u = advect_vel_scalar_fast(
        dt, density, u, flags, mconf.advection_method, False,
        mconf.maccormack_strength, W, free=free,
        sweep=advect_sweep_fused_ep if use_kernels else sweep_fused_ep_plain)
    buoy_g, grav_g, amp = _forces_config(mconf, dx, forces)
    state = state.replace(u=u, density=density)
    if mconf.sim_method == "convnet":
        state = _convnet_projection(state, mconf, model, bcs, buoy_g,
                                    grav_g, amp, dt, use_kernels)
    else:
        has_forces = forces.has_buoy or forces.has_grav or forces.has_vc
        state = _solver_projection(state, mconf, bcs, consts, buoy_g, grav_g,
                                   amp, dt, use_kernels, has_forces)
    state = apply_boundaries(state, bcs)
    return state.replace(u=state.u.clamp(-U_CLAMP, U_CLAMP))


def _step_2d(state, mconf, model, bcs, consts, use_kernels, forces):
    """The 2-D step (simulate.py:117-290 with 2-D shapes): per-channel and
    velocity advection on K5, unfused forces, the projection."""
    dt = forces.dt
    u, flags, density = state.u, state.flags, state.density
    plain = not use_kernels
    W = mconf.advection_window
    if mconf.adaptive_window and W > 1:
        # The window only limits displacements: when the step's CFL
        # number fits one cell, W = 1 is exact (simulate.py:155-164).
        if bool(u.abs().max() * dt <= 1.0 - 1e-3):
            W = 1
    method = mconf.advection_method
    free = consts.free(flags, W + 1) if method.endswith("Ours") else None

    # 1.+2. Advection: each density channel, then the velocity (last,
    # simulate.lua:183-199).
    kw = dict(method=method, maccormack_strength=mconf.maccormack_strength,
              window=W, free_space=free, plain=plain)
    if density is not None:
        density = torch.cat([
            advect_scalar(dt, density[:, c:c + 1], u, flags,
                          sample_outside_fluid=False, **kw)
            for c in range(density.shape[1])], dim=1)
    u = advect_vel(dt, u, flags, **kw)

    # 3. External BCs; 4.-6. forces (simulate.py:233-241).
    state = apply_boundaries(state.replace(u=u, density=density), bcs)
    u, density = state.u, state.density
    buoy_g, grav_g, amp = _forces_config(mconf, get_dx(flags), forces)
    if forces.has_buoy:
        u = add_buoyancy(u, flags, density[:, 0:1], buoy_g, dt)
    if forces.has_grav:
        u = add_gravity(u, flags, grav_g, dt)
    if forces.has_vc:
        u = vorticity_confinement(u, flags, amp)

    # 7. Projection (simulate.py:248-290).
    if mconf.sim_method != "convnet":
        u = set_wall_bcs(u, flags)
    state = apply_boundaries(state.replace(u=u), bcs)
    u, p = state.u, state.p
    if mconf.sim_method == "convnet":
        p, u = model(p, u, flags)
        if mconf.polish_iters > 0:
            res_div = velocity_divergence(u, flags)
            dp = _fixed_jacobi(flags, res_div, mconf.polish_iters,
                               use_kernels)
            u = velocity_update(u, flags, dp)
            p = p + dp
    else:
        div = velocity_divergence(u, flags)
        if mconf.sim_method == "pcg":
            if consts.labels is None:
                consts.labels = connected_components(flags)
            p, _ = solve_pcg(flags, div, tol=mconf.pcg_tol,
                             max_iter=mconf.max_iter, labels=consts.labels)
        else:
            p = _fixed_jacobi(flags, div, mconf.max_iter, use_kernels)
        u = velocity_update(u, flags, p)
    state = apply_boundaries(state.replace(u=u, p=p), bcs)
    return state.replace(u=state.u.clamp(-U_CLAMP, U_CLAMP))


def _convnet_projection(state, mconf, model, bcs, buoy_g, grav_g, amp, dt,
                        use_kernels):
    """The fused ConvNet path: p/density slab BCs, K2's prologue, the
    ConvNet, the optional Jacobi polish. Returns the state before the
    final BCs."""
    flags = state.flags
    # External BCs on p and density; the u slab runs in the prologue.
    bcs_nou = bcs
    if bcs is not None:
        bcs_nou = dataclasses.replace(bcs, u_bc=None, u_bc_inv_mask=None)
    state = apply_boundaries(state, bcs_nou)

    # The projection prologue: slab BC, forces, slab BC, setWallBcs,
    # divergence, in one K2 launch.
    u_bc = bcs.u_bc if bcs is not None else None
    u_inv = bcs.u_bc_inv_mask if bcs is not None else None
    prologue = projection_prologue if use_kernels else prologue_ref
    u, div = prologue(state.u, flags, state.density[:, 0:1], buoy_g, grav_g,
                      amp, float(dt), u_bc, u_inv)

    # The p/density slabs are idempotent masks, reapplied as the JAX step
    # does.
    state = apply_boundaries(state.replace(u=u), bcs_nou)
    p, u = model(state.p, u, flags, precomputed_div=div)
    if mconf.polish_iters > 0:
        # Hybrid projection: Jacobi sweeps on the ConvNet's residual.
        res_div = velocity_divergence(u, flags)
        dp = _fixed_jacobi(flags, res_div, mconf.polish_iters, use_kernels)
        u = velocity_update(u, flags, dp)
        p = p + dp
    return state.replace(u=u, p=p)


def _solver_projection(state, mconf, bcs, consts, buoy_g, grav_g, amp, dt,
                       use_kernels, has_forces):
    """The Jacobi / PCG path: full BCs, the forces block (K2's forces-block
    form), setWallBcs, BCs, divergence, solve, velocity update. Returns
    the state before the final BCs."""
    flags = state.flags
    state = apply_boundaries(state, bcs)
    u = state.u
    if has_forces:
        block = forces_block if use_kernels else forces_block_xla
        u = block(u, flags, state.density[:, 0:1], buoy_g, grav_g, amp,
                  float(dt))
    u = set_wall_bcs(u, flags)
    state = apply_boundaries(state.replace(u=u), bcs)
    u = state.u
    div = velocity_divergence(u, flags)
    if mconf.sim_method == "pcg":
        if consts.labels is None:
            consts.labels = connected_components(flags)
        p, _ = solve_pcg(flags, div, tol=mconf.pcg_tol,
                         max_iter=mconf.max_iter, labels=consts.labels)
    else:
        p = _fixed_jacobi(flags, div, mconf.max_iter, use_kernels)
    return state.replace(u=velocity_update(u, flags, p), p=p)


def rollout(state: FluidState, mconf: ModelConfig, n_steps: int,
            model=None, bcs: Optional[Boundaries] = None,
            save_every: int = 0, use_kernels: bool = True):
    """Runs `n_steps` simulate() steps as a Python loop (the JAX package
    scans on device; a CUDA graph of this loop is later work). What
    depends on the flags alone, which do not change, is computed once:
    the free space, and for PCG the connected-component labels.

    Returns the final state; with `save_every > 0` also the density every
    `save_every` steps, stacked (n_steps // save_every, b, c, z, y, x)."""
    if save_every > 1 and n_steps % save_every:
        raise ValueError(f"n_steps ({n_steps}) must be divisible by "
                         f"save_every ({save_every})")
    forces = _resolve_forces(state, mconf, None, None, None, None)
    _check_slice(state, mconf, model, forces)
    consts = FlagConsts()
    frames = []
    with torch.no_grad():
        for i in range(n_steps):
            state = _step(state, mconf, model, bcs, consts, use_kernels,
                          forces)
            if save_every and (i + 1) % save_every == 0:
                frames.append(state.density)
    if save_every:
        return state, torch.stack(frames)
    return state
