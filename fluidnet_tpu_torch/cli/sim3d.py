"""3-D smoke simulation entry point.

Port of fluidnet_tpu.cli.sim3d, the equivalent of `qlua
fluid_net_3d_sim.lua` (torch/fluid_net_3d_sim.lua): a res^3 buoyant plume
around an optional voxelized obstacle model (.binvox), stepped with the
ConvNet, Jacobi or PCG projection; density volumes exported as .vbox for
the Blender pipeline; prints ms/frame at exit (fluid_net_3d_sim.lua:
300-304).

  python -m fluidnet_tpu_torch.cli.sim3d --res 128 --num_frames 768 \\
      --model data/models_bundled/m3d_v5_bestRollout --voxel_model bunny.binvox

It runs on the GPU; `--device cpu` runs on the CPU (the kernels' plain
versions). With `--model` the projection is that checkpoint's ConvNet.
Without it, `--sim_method convnet` draws random weights with
models.fluidnet.random_model(seed 0): a smoke test of the full path whose
weights are not the JAX package's (its init_train_state draws from JAX's
PRNG).
"""

import argparse
import os
import time

import numpy as np
import torch

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import (FluidState, empty_domain,
                                           resolve_device)
from fluidnet_tpu_torch.io.binvox import load_binvox
from fluidnet_tpu_torch.io.vbox import VboxWriter
from fluidnet_tpu_torch.io.voxel_utils import (flip_diagonal,
                                               pad_voxels_to_dims,
                                               place_voxels_in_flags)
from fluidnet_tpu_torch.models.fluidnet import random_model
from fluidnet_tpu_torch.sim.simulate import (FlagConsts, create_plume_bcs,
                                             rollout, simulate)
from fluidnet_tpu_torch.train.train import init_train_state
from fluidnet_tpu_torch.utils.checkpoint import load_checkpoint, load_mconf


def build_scene(res, voxel_model=None, device=None):
    """A res^3 empty domain with the plume inflow and an optional voxel
    obstacle (fluid_net_3d_sim.lua:62-152), on resolve_device(device).
    Returns (state, bcs)."""
    dev = resolve_device(device)
    B, Z, Y, X = 1, res, res, res
    flags = empty_domain((B, 1, Z, Y, X), True, device=dev)
    if voxel_model:
        vox = load_binvox(voxel_model)["data"]     # (x, y, z)
        vox = flip_diagonal(vox, 1)                # as loadVoxelModel flips
        vox = pad_voxels_to_dims(X, Y, Z, vox)
        flags = torch.from_numpy(place_voxels_in_flags(
            flags.cpu().numpy(), vox)).to(dev)
    state = FluidState(
        u=torch.zeros((B, 3, Z, Y, X), device=dev),
        p=torch.zeros((B, 1, Z, Y, X), device=dev),
        flags=flags,
        density=torch.zeros((B, 1, Z, Y, X), device=dev))
    bcs = create_plume_bcs(state, [1.0], u_scale=0.6 * (res / 128),
                           rad=0.15)
    return state, bcs


def scene_knobs(mconf, res, max_iter=34, pcg_tol=1e-4, polish_iters=0):
    """mconf with the scene's forced knobs (fluid_net_3d_sim.lua:73-87):
    dt 0.1, buoyancy 2 res/128, vorticity confinement 3, MacCormack
    strength 0.6, maccormackOurs, and the solver's iterations."""
    return mconf.replace(
        dt=0.1, buoyancy_scale=2.0 * (res / 128.0),
        vorticity_confinement_amp=3.0, maccormack_strength=0.6,
        advection_method="maccormackOurs", max_iter=max_iter,
        pcg_tol=pcg_tol, polish_iters=polish_iters)


def _fence(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args):
    dev = resolve_device(args.device)
    res = args.res
    model = None
    if args.model:
        mconf = load_mconf(args.model)
        if not mconf.is_3d:
            raise ValueError(f"{args.model} holds a 2-D model; sim3d needs "
                             f"3-D")
        mconf = mconf.replace(sim_method="convnet")
        tstate, mconf, _ = load_checkpoint(
            args.model, init_train_state(0, mconf, dev))
        model = tstate.model
    else:
        mconf = ModelConfig(is_3d=True, sim_method=args.sim_method)
        if args.sim_method == "convnet":
            model = random_model(mconf, 0, dev)
    mconf = scene_knobs(mconf, res, args.max_iter, args.pcg_tol,
                        args.polish_iters)

    state, bcs = build_scene(res, args.voxel_model or None, dev)
    consts = FlagConsts()

    writers = {}
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        # Frames are written for i in [1, num_frames) with i % decimation
        # == 0 (the reference saves every 3rd frame,
        # fluid_net_3d_sim.lua:286-290).
        writers["density"] = VboxWriter(
            os.path.join(args.out_dir,
                         f"density_output_dt{mconf.dt}.vbox"),
            res, res, res, (args.num_frames - 1) // args.decimation)
        with VboxWriter(os.path.join(args.out_dir, "geom_output.vbox"),
                        res, res, res, 1) as gw:
            occ = (state.flags[0, 0].cpu().numpy() & 2) > 0
            gw.write_frame(occ.astype(np.float32))

    # The first step outside the timing.
    state = simulate(state, mconf, model, bcs, consts=consts)
    _fence(dev)
    t0 = time.perf_counter()
    # Steps i = 1 .. num_frames - 1; a frame is written after every
    # `decimation`-step chunk (step index i % decimation == 0); the
    # remainder is stepped alone.
    n_steps = args.num_frames - 1
    n_chunks, rem = divmod(n_steps, args.decimation)
    for _ in range(n_chunks):
        state = rollout(state, mconf, args.decimation, model, bcs,
                        consts=consts)
        if "density" in writers:
            writers["density"].write_frame(state.density[0, 0].cpu().numpy())
    for _ in range(rem):
        state = simulate(state, mconf, model, bcs, consts=consts)
    _fence(dev)
    dt_frame = (time.perf_counter() - t0) / max(n_steps, 1)
    for w in writers.values():
        w.close()
    print(f"Simulation done: {dt_frame * 1e3:.3f} ms/frame at {res}^3 "
          f"({mconf.sim_method} projection)")
    return dt_frame


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--num_frames", type=int, default=768)
    ap.add_argument("--decimation", type=int, default=3)
    ap.add_argument("--sim_method", default="convnet",
                    choices=["convnet", "jacobi", "pcg"])
    ap.add_argument("--max_iter", type=int, default=34)
    ap.add_argument("--pcg_tol", type=float, default=1e-4,
                    help="pcg residual tolerance (pTol, default_conf.lua)")
    ap.add_argument("--polish_iters", type=int, default=0,
                    help="hybrid Jacobi polish sweeps after the convnet "
                    "projection (ModelConfig.polish_iters)")
    ap.add_argument("--model", default="",
                    help="checkpoint dir of a trained 3-D model")
    ap.add_argument("--voxel_model", default="",
                    help=".binvox obstacle file (e.g. bunny)")
    ap.add_argument("--out_dir", default="data/output")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
