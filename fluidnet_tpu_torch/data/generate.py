"""Self-generation of training data with the built-in PCG solver.

Port of fluidnet_tpu.data.generate. The reference depends on an external
mantaflow fork to render training pairs (README.md:126-179); here random
scenes (turbulent initial velocity from a divergence-free spectral noise
field, random obstacle boxes/spheres, an optional plume source, random
buoyancy and vorticity) are stepped with the PCG projection, and each saved
frame writes the manta-compatible pair

  NNNNNN_divergent.bin  - state after advection + forces, before projection
  NNNNNN.bin            - state after the PCG projection (the target)

the layout DataBinary consumes (torch/lib/data_binary.lua:51-52). The numpy
draws are the JAX module's, in the same order, so a seed gives the same
scenes in both packages. Scenes are stepped on `device` (the CUDA device
by default) with simulate(output_div=True): the 3-D default W = 2 with
the adaptive window, K1 for the advection, K2's forces block for scalar
force scales (per-scene scales run the plain composition).
"""

import dataclasses
import os
import time

import numpy as np
import torch

from fluidnet_tpu_torch.core.celltype import CellType
from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import (FluidState, empty_domain,
                                           resolve_device)
from fluidnet_tpu_torch.data.manta_io import frame_name, save_manta_file
from fluidnet_tpu_torch.ops.boundary import set_wall_bcs
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.velocity_update import velocity_update
from fluidnet_tpu_torch.sim.simulate import (Boundaries, FlagConsts,
                                             create_plume_bcs, simulate)
from fluidnet_tpu_torch.solvers.cg import solve_pcg
from fluidnet_tpu_torch.solvers.components import (component_segments,
                                                   connected_components)


def divergence_free_noise(rng, shape_zyx, is_3d, n_modes=24, max_freq=6,
                          amplitude=1.0):
    """Band-limited divergence-free velocity: curl of a random stream
    function (2-D) / vector potential (3-D). Returns (1, c, Z, Y, X)
    numpy."""
    Z, Y, X = shape_zyx
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    n_pots = 3 if is_3d else 1
    pots = np.zeros((n_pots, Z, Y, X), np.float32)
    for _ in range(n_modes):
        k = rng.integers(1, max_freq + 1, size=3)
        if not is_3d:
            k[0] = 0
        phase = rng.random(3) * 2 * np.pi
        amp = amplitude * rng.standard_normal() / n_modes
        wave = np.cos(2 * np.pi * (k[0] * zz / max(Z, 1) +
                                   k[1] * yy / Y + k[2] * xx / X) +
                      phase[0]).astype(np.float32)
        pots[rng.integers(0, n_pots)] += amp * wave

    def d(a, ax):
        return np.gradient(a, axis=ax)

    if is_3d:
        az, ay, ax_ = pots[0], pots[1], pots[2]
        u = np.stack([d(az, 1) - d(ay, 0), d(ax_, 0) - d(az, 2),
                      d(ay, 2) - d(ax_, 1)])
    else:
        psi = pots[0]
        u = np.stack([d(psi, 1), -d(psi, 2)])
    return u[None]


def random_obstacle_flags(rng, shape_zyx, is_3d, max_obstacles=3,
                          voxels=None):
    """Empty domain + random solid boxes/spheres (numpy int32
    (1, 1, Z, Y, X)); optionally a voxel occupancy grid blitted in."""
    Z, Y, X = shape_zyx
    flags = empty_domain((1, 1, Z, Y, X), is_3d, device="cpu").numpy().copy()
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    for _ in range(rng.integers(0, max_obstacles + 1)):
        kind = rng.choice(["box", "sphere"])
        cx = rng.integers(X // 8, X - X // 8)
        cy = rng.integers(Y // 8, Y - Y // 8)
        cz = rng.integers(Z // 8, Z - Z // 8) if is_3d else 0
        r = rng.integers(2, max(3, min(X, Y) // 6))
        if kind == "box":
            m = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
            if is_3d:
                m &= np.abs(zz - cz) <= r
        else:
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2
            if is_3d:
                d2 = d2 + (zz - cz) ** 2
            m = d2 <= r * r
        flags[0, 0][m] = int(CellType.TypeObstacle)
    if voxels is not None:
        flags[0, 0][voxels > 0.5] = int(CellType.TypeObstacle)
    return flags


def project_pcg(state: FluidState, max_iter=300, tol=1e-5, labels=None):
    """The calcPUTargets path (simulate.lua:332-372): wall BCs ->
    divergence -> PCG -> velocity update -> wall BCs. Returns (state,
    residual)."""
    u = set_wall_bcs(state.u, state.flags)
    div = velocity_divergence(u, state.flags)
    p, residual = solve_pcg(state.flags, div, tol=tol, max_iter=max_iter,
                            labels=labels)
    u = set_wall_bcs(velocity_update(u, state.flags, p), state.flags)
    return state.replace(u=u, p=p), residual


def _identity_boundaries_like(bcs: Boundaries) -> Boundaries:
    """Boundaries that change nothing (inv_mask 1, bc 0) with the shapes of
    `bcs`: plume-free scenes inside a plume batch."""
    def z(a):
        return None if a is None else torch.zeros_like(a)

    def o(a):
        return None if a is None else torch.ones_like(a)
    return Boundaries(u_bc=z(bcs.u_bc), u_bc_inv_mask=o(bcs.u_bc_inv_mask),
                      p_bc=z(bcs.p_bc), p_bc_inv_mask=o(bcs.p_bc_inv_mask),
                      density_bc=z(bcs.density_bc),
                      density_bc_inv_mask=o(bcs.density_bc_inv_mask))


def _save_frames(out_dirs, frame, state: FluidState, divergent):
    arrs = [t.cpu().numpy() for t in (state.p, state.u, state.flags,
                                      state.density[:, :1])]
    for i, d in enumerate(out_dirs):
        save_manta_file(os.path.join(d, frame_name(frame, divergent)),
                        *(a[i:i + 1] for a in arrs))


def _roll(out_dirs, state, mconf, bcs, b_scale, v_amp, n_frames,
          save_every, max_iter):
    """Steps the scenes n_frames times (divergent state, then the PCG
    projection), saving every save_every-th pair. Returns the max PCG
    residual."""
    consts = FlagConsts(labels=component_segments(
        connected_components(state.flags)))
    max_res = 0.0
    for f in range(n_frames):
        state = simulate(state, mconf, None, bcs, output_div=True,
                         buoyancy_scale=b_scale, vorticity_amp=v_amp,
                         consts=consts)
        if f % save_every == 0:
            _save_frames(out_dirs, f, state, True)
        with torch.no_grad():
            state, res = project_pcg(state, max_iter, labels=consts.labels)
        max_res = max(max_res, float(res))
        if f % save_every == 0:
            _save_frames(out_dirs, f, state, False)
    return max_res


def generate_run(out_dir, rng, size_xyz=(64, 64, 1), is_3d=False,
                 n_frames=64, dt=0.1, buoyancy_scale=None, plume=None,
                 advection="maccormackOurs", save_every=1, max_iter=300,
                 device=None):
    """Generates one run directory of paired frames. Returns the max
    residual."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    X, Y, Z = size_xyz
    flags = torch.from_numpy(random_obstacle_flags(rng, (Z, Y, X), is_3d))
    u0 = torch.from_numpy(np.asarray(divergence_free_noise(
        rng, (Z, Y, X), is_3d, amplitude=float(rng.random() * 4 + 1)),
        np.float32))
    rho0 = torch.from_numpy(rng.random((1, 1, Z, Y, X)).astype(np.float32))
    state = FluidState(u=u0.to(dev), p=torch.zeros((1, 1, Z, Y, X),
                                                   device=dev),
                       flags=flags.to(dev), density=rho0.to(dev))
    if buoyancy_scale is None:
        buoyancy_scale = float(rng.random() * 2.0) \
            if rng.random() < 0.5 else 0.0
    mconf = ModelConfig(is_3d=is_3d, dt=dt, advection_method=advection,
                        sim_method="pcg", max_iter=max_iter)
    bcs = None
    if plume is not None or rng.random() < 0.5:
        scale = plume if plume is not None else float(rng.random() * 1.0 +
                                                      0.2)
        state = state.replace(density=torch.zeros_like(state.density))
        bcs = create_plume_bcs(state, [1.0], u_scale=scale, rad=0.15)
    return _roll([out_dir], state, mconf, bcs,
                 torch.tensor(buoyancy_scale, dtype=torch.float32),
                 torch.zeros(()), n_frames, save_every, max_iter)


def generate_run_batch(out_dirs, rng, size_xyz=(64, 64, 1), is_3d=False,
                       n_frames=64, dt=0.1, advection="maccormackOurs",
                       save_every=1, max_iter=300, device=None):
    """Batched scene generation: len(out_dirs) scenes stepped as one batch.
    All randomization is per scene: obstacles, noise, density, buoyancy and
    vorticity scales ((B,) vectors) and the plume (per-scene masks;
    plume-free scenes get identity BCs). Returns the max PCG residual."""
    dev = resolve_device(device)
    B = len(out_dirs)
    for d in out_dirs:
        os.makedirs(d, exist_ok=True)
    X, Y, Z = size_xyz
    flags = np.concatenate([random_obstacle_flags(rng, (Z, Y, X), is_3d)
                            for _ in range(B)])
    u0 = np.concatenate([np.asarray(divergence_free_noise(
        rng, (Z, Y, X), is_3d, amplitude=float(rng.random() * 4 + 1)),
        np.float32) for _ in range(B)])
    rho0 = rng.random((B, 1, Z, Y, X)).astype(np.float32)
    mconf = ModelConfig(is_3d=is_3d, dt=dt, advection_method=advection,
                        sim_method="pcg", max_iter=max_iter)

    # Per-scene force draws (the same marginals as the per-scene path).
    buoy = np.where(rng.random(B) < 0.5, rng.random(B) * 2.0, 0.0)
    vort = np.where(rng.random(B) < 0.5, rng.random(B) * 3.0, 0.0)

    # Per-scene plume: each scene draws its own on/off, inflow speed and
    # radius; plume scenes start with zero density (filled by the inflow).
    has_plume = rng.random(B) < 0.5
    scene_bcs = []
    for i in range(B):
        si = FluidState(u=torch.from_numpy(u0[i:i + 1]),
                        p=torch.zeros((1, 1, Z, Y, X)),
                        flags=torch.from_numpy(flags[i:i + 1]),
                        density=torch.from_numpy(rho0[i:i + 1]))
        b_i = create_plume_bcs(
            si, [1.0], u_scale=float(rng.random() * 1.0 + 0.2),
            rad=float(rng.random() * 0.1 + 0.1))
        if has_plume[i]:
            rho0[i] = 0.0
        else:
            b_i = _identity_boundaries_like(b_i)
        scene_bcs.append(b_i)
    bcs = Boundaries(**{
        f.name: torch.cat([getattr(b, f.name) for b in scene_bcs]).to(dev)
        for f in dataclasses.fields(Boundaries)
        if getattr(scene_bcs[0], f.name) is not None})
    state = FluidState(u=torch.from_numpy(u0).to(dev),
                       p=torch.zeros((B, 1, Z, Y, X), device=dev),
                       flags=torch.from_numpy(flags).to(dev),
                       density=torch.from_numpy(rho0).to(dev))
    return _roll(out_dirs, state, mconf, bcs,
                 torch.tensor(buoy, dtype=torch.float32),
                 torch.tensor(vort, dtype=torch.float32), n_frames,
                 save_every, max_iter)


def generate_dataset(root, n_tr=4, n_te=2, seed=0, scenes_per_batch=1,
                     residuals=None, **kw):
    """Creates <root>/{tr,te}/NNN run directories (data_binary.lua layout).
    scenes_per_batch > 1 steps that many scenes as one batch
    (generate_run_batch); scene content stays per-scene random. Keyword
    arguments go to generate_run / generate_run_batch (size_xyz, is_3d,
    n_frames, save_every, max_iter, device, ...). Each run's (or batch's)
    max PCG residual is appended to the list `residuals` if one is given.
    Returns root."""
    residuals = [] if residuals is None else residuals
    rng = np.random.default_rng(seed)
    for split, n in (("tr", n_tr), ("te", n_te)):
        if scenes_per_batch > 1:
            r = 0
            while r < n:
                g = min(scenes_per_batch, n - r)
                dirs = [os.path.join(root, split, "%03d" % (r + i))
                        for i in range(g)]
                t0 = time.time()
                res = generate_run_batch(dirs, rng, **kw)
                residuals.append(res)
                print(f"  [{split} {r + g}/{n}] {g} scenes in "
                      f"{time.time() - t0:.1f}s (max residual {res:.2e})",
                      flush=True)
                r += g
        else:
            for r in range(n):
                residuals.append(generate_run(
                    os.path.join(root, split, "%03d" % r), rng, **kw))
    return root
