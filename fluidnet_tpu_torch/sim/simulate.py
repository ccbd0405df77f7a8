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

The other branches, 2-D and 3-D alike (the interactive demo's 2-D step,
data generation, training):

  1. the window: with adaptive_window, W = 1 when max|u| dt <= 1 - 1e-3,
     else advection_window (one host read per step)
  2. each density channel advected on its own, then the velocity: every
     interpolation through the windowed warp (K5) in 2-D and for the 3-D
     density, the 3-D velocity on K1's unfused velocity sweep
  3. BCs; forces: the forces block (K2's forces-block form) in 3-D with
     density, else buoyancy, gravity and vorticity confinement one by one
     (3-D confinement with a scalar strength on K4); per-sample (B,)
     scales run the plain compositions. With output_div the step ends
     here, returning the divergent state (training's last unroll step,
     data generation).
  4. the projection: setWallBcs (solvers), BCs, then the ConvNet (plus
     polish_iters Jacobi sweeps, K3), or jacobi (K3) / PCG with the
     velocity update; BCs again, velocity clipped to +-1e6

advection_window 0 replaces step 2 of either form by the exact gather
advection (ops/advect.py): each density channel, then the velocity, with
the line-traced backtrace and the fluid-aware interpolation, in plain
PyTorch (no kernel; K1 is not launched).

simulate(grad=True) records the step for autograd: every kernel on the way
has the gradient rule of its JAX custom VJP (not with advection_window 0,
which raises). rollout() and the default simulate() run under
torch.no_grad.
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
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.forces import (add_buoyancy, add_gravity,
                                           forces_block, forces_block_xla,
                                           vorticity_confinement,
                                           vorticity_confinement_xla)
from fluidnet_tpu_torch.ops.prologue import (projection_prologue,
                                             prologue_ref)
from fluidnet_tpu_torch.ops.velocity_update import velocity_update
from fluidnet_tpu_torch.solvers.cg import solve_pcg
from fluidnet_tpu_torch.solvers.components import (Segments,
                                                   component_segments,
                                                   connected_components)
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
    gravity: object
    b_scale: object
    g_scale: object
    v_amp: object
    has_buoy: bool
    has_grav: bool
    has_vc: bool

    @property
    def batched(self):
        """Per-sample scales (fault F1 fixed: any scale of ndim > 0, or a
        (B, 3) gravity, is batched)."""
        return (torch.as_tensor(self.b_scale).dim() > 0 or
                torch.as_tensor(self.g_scale).dim() > 0 or
                torch.as_tensor(self.v_amp).dim() > 0 or
                torch.as_tensor(self.gravity).dim() > 1)


def _resolve_forces(state, mconf, dt, buoyancy_scale, gravity_scale,
                    vorticity_amp, gravity=None):
    if gravity is None:
        gravity = (0.0, 1.0, 0.0) if mconf.gravity is None \
            else mconf.gravity   # simulate.lua:204-213
    return _Forces(
        dt=mconf.dt if dt is None else dt,
        gravity=gravity,
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


def _check_slice(state: FluidState, mconf: ModelConfig, model):
    """Validates the projection and its model."""
    if mconf.sim_method not in ("convnet", "jacobi", "pcg"):
        raise ValueError(f"bad sim_method {mconf.sim_method}")
    if mconf.sim_method == "convnet" and model is None:
        raise ValueError("the convnet sim method needs a model")


def simulate(state: FluidState, mconf: ModelConfig, model=None,
             bcs: Optional[Boundaries] = None,
             use_kernels: bool = True, dt=None, buoyancy_scale=None,
             gravity_scale=None, vorticity_amp=None,
             consts: Optional["FlagConsts"] = None, output_div: bool = False,
             gravity=None, grad: bool = False) -> FluidState:
    """One simulation step with the projection mconf.sim_method: "convnet"
    (the ConvNet `model`, a models.fluidnet.FluidNet, plus mconf.
    polish_iters Jacobi sweeps), "jacobi" (mconf.max_iter fixed sweeps)
    or "pcg" (mconf.max_iter, mconf.pcg_tol); `model` may be None for the
    last two. `use_kernels=False` runs every kernel's plain PyTorch
    version instead, on whatever device the state lives: the reference
    the kernels are checked against.

    `dt`, `buoyancy_scale`, `gravity_scale` and `vorticity_amp` override
    mconf's (floats, 0-d tensors, or per-sample (B,) tensors for the
    scales); a given force runs even at zero, as in JAX. `gravity`
    overrides mconf.gravity with a (3,) vector. Keep these on the host:
    the kernels take them as launch arguments. `output_div` returns the
    divergent state after the forces, before the projection (training and
    data generation). `consts`: a FlagConsts reused across steps while the
    flags stay the same (the interactive server keeps one); None computes
    the flag-derived fields anew. `grad=True` records the step for
    autograd (training); otherwise it runs under torch.no_grad."""
    forces = _resolve_forces(state, mconf, dt, buoyancy_scale,
                             gravity_scale, vorticity_amp, gravity)
    _check_slice(state, mconf, model)
    if grad and not mconf.advection_window:
        raise NotImplementedError("the gradient of the exact advection "
                                  "(advection_window 0) is not ported "
                                  "(ROADMAP queue 1, item 5: the exact "
                                  "path's training gradient)")
    with torch.set_grad_enabled(grad):
        return _step(state, mconf, model, bcs,
                     FlagConsts() if consts is None else consts,
                     use_kernels, forces, output_div)


@dataclasses.dataclass
class FlagConsts:
    """Fields that depend on the flags alone, which do not change within
    a rollout: computed at the first step that needs them. free_space maps
    the free-space cap (window + 1) to its field; labels are PCG's
    connected components, as solvers.components.component_segments."""
    free_space: dict = dataclasses.field(default_factory=dict)
    labels: Optional[Segments] = None

    def free(self, flags, max_d: int):
        if max_d not in self.free_space:
            self.free_space[max_d] = chebyshev_free_space(flags, max_d)
        return self.free_space[max_d]


def _scale(g_vec, scale):
    """g_vec * scale, scale a scalar or a per-sample (B,) vector (then a
    (B, 3) gravity), in float32 as the JAX _scale_gravity."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    if scale.dim() == 0:
        return g_vec * scale
    return g_vec[None, :] * scale[:, None]


def _forces_config(dx, forces):
    """(buoy_g, grav_g, amp) of simulate.lua:216-239 (simulate.py:
    211-218), float32 on the host: the 3-D kernels take them as launch
    arguments, the plain force ops as tensors."""
    f32 = torch.float32
    g_vec = torch.as_tensor(forces.gravity, dtype=f32).cpu()
    zero3 = torch.zeros(3)
    coef = -(dx / 4.0)
    buoy_g = _scale(g_vec, coef * torch.as_tensor(forces.b_scale, dtype=f32)
                    .cpu()) if forces.has_buoy else zero3
    grav_g = _scale(g_vec, coef * torch.as_tensor(forces.g_scale, dtype=f32)
                    .cpu()) if forces.has_grav else zero3
    amp = dx * torch.as_tensor(forces.v_amp, dtype=f32).cpu() \
        if forces.has_vc else torch.zeros(())
    return buoy_g, grav_g, amp


def _fixed_jacobi(flags, div, n_sweeps, use_kernels):
    """n fixed Jacobi sweeps from 0: K3 through solve_jacobi(p_tol=0), or
    K3's plain version."""
    if use_kernels:
        return solve_jacobi(flags, div, p_tol=0.0, max_iter=n_sweeps)[0]
    return jacobi_plain(flags, div, n_sweeps)


def _window(mconf, u, dt):
    """The advection window: with adaptive_window, W = 1 when the step's
    CFL number max|u| dt fits one cell (the window only limits
    displacements, so W = 1 is then exact; simulate.py:155-164), else
    advection_window. One host read per step."""
    W = mconf.advection_window
    if mconf.adaptive_window and W > 1 and \
            bool(u.detach().abs().max() * dt <= 1.0 - 1e-3):
        return 1
    return W


def _advect(state, mconf, consts, dt, plain):
    """Advection of the density channels and the velocity (the velocity
    last, simulate.lua:183-199). 3-D with one density channel and a method
    other than Manta's maccormack runs the fused combined path (K1, two
    launches); otherwise each density channel, then the velocity (K5 for
    every interpolation in 2-D and for the 3-D density, K1's unfused
    velocity sweep in 3-D). advection_window 0 takes the exact gather path
    (ops/advect.py, plain PyTorch) for each density channel, then the
    velocity, in 2-D and 3-D (simulate.py:115-166)."""
    u, flags, density = state.u, state.flags, state.density
    W = _window(mconf, u, dt)
    method = mconf.advection_method
    free = consts.free(flags, W + 1) if W and method.endswith("Ours") \
        else None
    if W and state.is_3d and density is not None and \
            density.shape[1] == 1 and method != "maccormack":
        return advect_vel_scalar_fast(
            dt, density, u, flags, method, False, mconf.maccormack_strength,
            W, free=free, plain=plain)[::-1]
    kw = dict(method=method, maccormack_strength=mconf.maccormack_strength,
              window=W, free_space=free, plain=plain)
    if density is not None:
        density = torch.cat([
            advect_scalar(dt, density[:, c:c + 1], u, flags,
                          sample_outside_fluid=False, **kw)
            for c in range(density.shape[1])], dim=1)
    return advect_vel(dt, u, flags, **kw), density


def _forces(state, buoy_g, grav_g, amp, dt, forces, use_kernels):
    """The unfused-projection forces (simulate.py:223-241): the fused
    block (K2's forces-block form) in 3-D with density, else each force on
    its own (3-D confinement with a scalar strength on K4)."""
    u, flags, density = state.u, state.flags, state.density
    if not (forces.has_buoy or forces.has_grav or forces.has_vc):
        return u
    if state.is_3d and density is not None:
        block = forces_block if use_kernels else forces_block_xla
        return block(u, flags, density[:, 0:1], buoy_g, grav_g, amp, dt)
    if forces.has_buoy:
        u = add_buoyancy(u, flags, density[:, 0:1], buoy_g, dt)
    if forces.has_grav:
        u = add_gravity(u, flags, grav_g, dt)
    if forces.has_vc:
        vc = vorticity_confinement if use_kernels \
            else vorticity_confinement_xla
        u = vc(u, flags, amp)
    return u


def _step(state, mconf, model, bcs, consts, use_kernels, forces,
          output_div=False):
    dt = forces.dt
    flags = state.flags
    u, density = _advect(state, mconf, consts, dt, not use_kernels)
    state = state.replace(u=u, density=density)
    buoy_g, grav_g, amp = _forces_config(get_dx(flags), forces)
    convnet = mconf.sim_method == "convnet"
    if state.is_3d and convnet and not output_div and \
            density is not None and not forces.batched:
        state = _convnet_projection(state, mconf, model, bcs, buoy_g,
                                    grav_g, amp, dt, use_kernels)
    else:
        # 3. External BCs; 4.-6. forces (simulate.py:199-241).
        state = apply_boundaries(state, bcs)
        u = _forces(state, buoy_g, grav_g, amp, dt, forces, use_kernels)
        if output_div:
            return state.replace(u=u)
        # 7. Projection (simulate.py:248-290).
        if not convnet:
            u = set_wall_bcs(u, flags)
        state = apply_boundaries(state.replace(u=u), bcs)
        if convnet:
            state = _polish(state, mconf, *model(state.p, state.u, flags),
                            use_kernels)
        else:
            state = _solver_projection(state, mconf, consts, use_kernels)
    state = apply_boundaries(state, bcs)
    u = state.u
    if u.requires_grad:
        # jnp.clip's gradient at ties (simulate.py:289), not torch.clamp's.
        lim = u.new_tensor(U_CLAMP)
        return state.replace(u=torch.minimum(torch.maximum(u, -lim), lim))
    return state.replace(u=u.clamp(-U_CLAMP, U_CLAMP))


def _polish(state, mconf, p, u, use_kernels):
    """The ConvNet's result, with polish_iters > 0 that many Jacobi sweeps
    (K3) on its residual divergence, the velocity update and p += dp."""
    if mconf.polish_iters > 0:
        res_div = velocity_divergence(u, state.flags)
        dp = _fixed_jacobi(state.flags, res_div, mconf.polish_iters,
                           use_kernels)
        u = velocity_update(u, state.flags, dp)
        p = p + dp
    return state.replace(u=u, p=p)


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
    # does. The model takes the prologue's divergence (fault F3 fixed: the
    # gradient reaches u through it).
    state = apply_boundaries(state.replace(u=u), bcs_nou)
    return _polish(state, mconf,
                   *model(state.p, u, flags, precomputed_div=div),
                   use_kernels)


def _solver_projection(state, mconf, consts, use_kernels):
    """The Jacobi / PCG projection of the wall-BC'ed state: divergence,
    solve, velocity update. Returns the state before the final BCs."""
    flags, u = state.flags, state.u
    div = velocity_divergence(u, flags)
    if mconf.sim_method == "pcg":
        if consts.labels is None:
            consts.labels = component_segments(connected_components(flags))
        p, _ = solve_pcg(flags, div, tol=mconf.pcg_tol,
                         max_iter=mconf.max_iter, labels=consts.labels)
    else:
        p = _fixed_jacobi(flags, div, mconf.max_iter, use_kernels)
    return state.replace(u=velocity_update(u, flags, p), p=p)


def rollout(state: FluidState, mconf: ModelConfig, n_steps: int,
            model=None, bcs: Optional[Boundaries] = None,
            save_every: int = 0, use_kernels: bool = True,
            consts: Optional[FlagConsts] = None):
    """Runs `n_steps` simulate() steps as a Python loop (the JAX package
    scans on device; a CUDA graph of this loop is later work). What
    depends on the flags alone, which do not change, is computed once:
    the free space, and for PCG the connected-component labels (`consts`
    keeps them across calls on the same flags, as cli/sim3d's chunks do).

    Returns the final state; with `save_every > 0` also the density every
    `save_every` steps, stacked (n_steps // save_every, b, c, z, y, x)."""
    if save_every > 1 and n_steps % save_every:
        raise ValueError(f"n_steps ({n_steps}) must be divisible by "
                         f"save_every ({save_every})")
    forces = _resolve_forces(state, mconf, None, None, None, None)
    _check_slice(state, mconf, model)
    consts = FlagConsts() if consts is None else consts
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
