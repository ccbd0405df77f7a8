#!/usr/bin/env python3
"""Where a step of the PyTorch port spends its time on the GPU, for each
projection: the 128^3 plume rollout, or the 2-D demo server's step; or a
training step.

    python3 scripts/torch_profile_step.py [--res 128] [--steps 10]
        [--warmup 20] [--only convnet,jacobi34,pcg,convnet_p8]
        [--model_type tog]
    python3 scripts/torch_profile_step.py --serve2d [--res 128]
        [--only convnet,jacobi34,pcg]
    python3 scripts/torch_profile_step.py --train [--res 64] [--batch 6]
        [--steps 3] [--warmup 2] [--only 4,16] [--model_type tog]

3-D: each projection (the ConvNet with the bundled m3d_v5_bestRollout
weights and bench.py's knobs; ConvNet + 8 Jacobi polish sweeps; jacobi-34;
PCG with 100 iterations at tol 1e-4) on a t = 0 plume. --serve2d: the step
of cli/serve.py (bundled m2d ConvNet, RGB density, maccormackOurs with the
adaptive window, buoyancy 1, the force overrides) with the ConvNet,
jacobi-34 or PCG, on a res^2 plume. --train: train.train_step with
m3d_v5's recipe (scripts/train3d_v5.sh: full-gradient unroll, bf16 convs,
Adam) from a random-init model on a batch of `--batch` res^3 scenes built
by the data generator's draws (random obstacles, divergence-free noise,
random density), at each unroll horizon in --only. `--model_type` (3-D and --train)
profiles another model type of the same config, from random_model(seed
18) in 3-D, in place of the bundled weights. Each: `--warmup` steps,
then `--steps` steps timed on the host clock without the profiler, then
`--steps` steps under torch.profiler. Prints per step: the unprofiled time
and the main thread's CPU time in it (the host's own cost, which a busy
shared host stretches less than the wall time), the device time of each
group of kernels (K1 fused and unfused, K2 prologue, K2 forces block, K3,
K4, K5, K6, the convolutions, everything else), the number of device
kernels, and the device busy time against the unprofiled step (1 - busy /
step is the idle share). Needs a CUDA device.
"""

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fluidnet_tpu_torch.cli import demo2d  # noqa: E402
from fluidnet_tpu_torch.core.grids import FluidState, empty_domain  # noqa
from fluidnet_tpu_torch.models.fluidnet import (FluidNet,  # noqa: E402
                                                random_model)
from fluidnet_tpu_torch.sim.simulate import (FlagConsts,  # noqa: E402
                                             create_plume_bcs, rollout,
                                             simulate)
from fluidnet_tpu_torch.utils.checkpoint import (load_mconf,  # noqa: E402
                                                 load_params)

BUNDLED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "models_bundled", "m3d_v5_bestRollout")
M2D = os.path.join(os.path.dirname(BUNDLED), "m2d")
BENCH_KNOBS = dict(sim_method="convnet", dt=0.1, buoyancy_scale=2.0,
                   vorticity_confinement_amp=3.0, maccormack_strength=0.6,
                   advection_method="maccormackOurs", adaptive_window=False,
                   advection_window=1)
# The demo server's knobs (cli/serve.py DemoSim).
SERVE_KNOBS = dict(sim_method="convnet", dt=0.1, buoyancy_scale=1.0,
                   vorticity_confinement_amp=0.0,
                   advection_method="maccormackOurs", max_iter=34)
PROJECTIONS = {"convnet": {}, "convnet_p8": dict(polish_iters=8),
               "jacobi34": dict(sim_method="jacobi", max_iter=34),
               "pcg": dict(sim_method="pcg", max_iter=100, pcg_tol=1e-4)}
# Kernel-name fragments of each group (mangled or demangled), tested in
# this order: K1's last template argument is FUSE, K2's are (EPI, RHO).
GROUPS = (("K1 mac_sweep fused", ("Lb1EEEvNS_4Args", "true>((anonymous")),
          ("K1 mac_sweep unfused", ("mac_sweep_",)),
          ("K2 prologue", ("prologue_kernel<true",
                           "prologue_kernelILb1E")),
          ("K4 vorticity", ("prologue_kernel<false, false>",
                            "prologue_kernelILb0ELb0E")),
          ("K2 forces block", ("prologue_kernel<false",
                               "prologue_kernelILb0E")),
          ("K3 jacobi", ("jacobi_sweep",)),
          ("K6 warp transpose", ("warp_transpose",)),
          ("K5 warp", ("warp_direct",)),
          ("convolutions", ("conv", "xmma", "gemm", "cudnn", "cutlass")),
          )


def group_of(name):
    for group, frags in GROUPS:
        if group.startswith("K1 mac_sweep fused"):
            if "mac_sweep_" in name and any(f in name for f in frags):
                return group
        elif any(f in name for f in frags):
            return group
    return "other (elementwise glue)"


def plume(dev, res):
    shape = (1, 1, res, res, res)
    state = FluidState(u=torch.zeros((1, 3, res, res, res), device=dev),
                       p=torch.zeros(shape, device=dev),
                       flags=empty_domain(shape, True, device=dev),
                       density=torch.zeros(shape, device=dev))
    return state, create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)


def runner_3d(dev, res, name, model, base):
    """run(n): n steps of the 3-D plume rollout with projection `name`."""
    mconf = base.replace(**PROJECTIONS[name])
    net = model if mconf.sim_method == "convnet" else None
    box = dict(zip(("state", "bcs"), plume(dev, res)))

    def run(n):
        box["state"] = rollout(box["state"], mconf, n, net, box["bcs"])
    return run


def runner_serve2d(dev, res, name, model, base):
    """run(n): n steps of the demo server's step (DemoSim.advance without
    the PNG) with projection `name`."""
    mconf = base.replace(**PROJECTIONS[name])
    net = model if mconf.sim_method == "convnet" else None
    state = demo2d.initial_state(res, dev)
    box = {"state": state}
    bcs, consts = demo2d.plume_bcs(state), FlagConsts()

    def run(n):
        for _ in range(n):
            box["state"] = simulate(
                box["state"], mconf, net, bcs, dt=mconf.dt,
                buoyancy_scale=mconf.buoyancy_scale,
                vorticity_amp=mconf.vorticity_confinement_amp, consts=consts)
    return run


def runner_train(dev, res, n_future, batch_size, model_type=None):
    """run(n): n train.train_step calls at unroll horizon n_future with
    m3d_v5's recipe on one batch of generated-scene fields."""
    import numpy as np
    from fluidnet_tpu_torch.core.config import default_conf, parse_args
    from fluidnet_tpu_torch.data.generate import (divergence_free_noise,
                                                  random_obstacle_flags)
    from fluidnet_tpu_torch.train.train import init_train_state, train_step
    mconf = parse_args(default_conf(), TRAIN_RECIPE).new_model
    if model_type:
        mconf = mconf.replace(model_type=model_type)
    rng = np.random.default_rng(29)
    zyx = (res, res, res)
    batch = {
        "flags": np.concatenate([random_obstacle_flags(rng, zyx, True)
                                 for _ in range(batch_size)]),
        "u_div": np.concatenate([divergence_free_noise(
            rng, zyx, True, amplitude=float(rng.random() * 4 + 1))
            for _ in range(batch_size)]).astype(np.float32),
        "p_div": np.zeros((batch_size, 1) + zyx, np.float32),
        "density": rng.random((batch_size, 1) + zyx).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    box = {"state": init_train_state(17, mconf, dev)}

    def run(n):
        for _ in range(n):
            gen = torch.Generator().manual_seed(box["state"].step)
            box["state"], _ = train_step(box["state"], batch, gen, mconf,
                                         n_future)
    return run


# The training flags of scripts/train3d_v5.sh (the m3d_v5 recipe).
TRAIN_RECIPE = [
    "-new_model.is_3d", "true",
    "-new_model.advection_method", "maccormackOurs",
    "-new_model.adaptive_window", "false", "-new_model.advection_window", "1",
    "-new_model.maccormack_strength", "0.75",
    "-new_model.train_buoyancy_prob", "0.5",
    "-new_model.train_buoyancy_scale", "2.0",
    "-new_model.train_vorticity_confinement_prob", "0.3",
    "-new_model.train_vorticity_confinement_amp", "3.0",
    "-new_model.long_term_div_lambda", "1.0",
    "-new_model.long_term_grad_mode", "full",
    "-new_model.loss_div_lambda", "1.0",
    "-new_model.loss_reject_threshold", "0.1",
    "-new_model.optim.learning_rate", "0.0005"]


def device_us(evt):
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else evt.self_cuda_time_total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=None,
                    help="grid size (default 64 with --train, else 128)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--only", default="")
    ap.add_argument("--top", type=int, default=0,
                    help="also list the N busiest ungrouped kernels")
    ap.add_argument("--serve2d", action="store_true",
                    help="profile the 2-D demo server's step (m2d)")
    ap.add_argument("--train", action="store_true",
                    help="profile train_step (m3d_v5's recipe) at the "
                    "horizons in --only")
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--model_type", default=None,
                    help="3-D and --train: this model type (random "
                    "weights) in place of the bundled model's")
    args = ap.parse_args()
    if args.res is None:
        args.res = 64 if args.train else 128
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_step: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    if args.train:
        where = f"{args.batch}x{args.res}^3 (train step)"

        def make(dev_, res, name, model_, base_):
            return runner_train(dev_, res, int(name), args.batch,
                                args.model_type)
        model = base = None
    elif args.serve2d:
        path, make, where = M2D, runner_serve2d, f"{args.res}^2 (serve)"
        base = load_mconf(M2D).replace(**SERVE_KNOBS)
    else:
        path, make, where = BUNDLED, runner_3d, f"{args.res}^3"
        base = load_mconf(BUNDLED).replace(**BENCH_KNOBS)
    if args.model_type and not args.train:
        if args.serve2d:
            raise SystemExit("--model_type: 3-D and --train only")
        base = base.replace(model_type=args.model_type)
        model = random_model(base, 18, dev)
    elif not args.train:
        model = FluidNet(base, device=dev).load_jax_params(load_params(path))
    if args.model_type:
        where += f" ({args.model_type}, random weights)"
    n = args.steps
    only = args.only or ("4,16" if args.train else "convnet,jacobi34,pcg"
                         if args.serve2d else ",".join(PROJECTIONS))
    for name in only.split(","):
        run = make(dev, args.res, name, model, base)
        run(args.warmup)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        run(n)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
        cpu_ms = (time.thread_time() - c0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(n)
            torch.cuda.synchronize()
        groups, kernels, other = {}, 0, []
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = device_us(evt)
            if us <= 0:
                continue
            g = group_of(evt.key)
            if g.startswith("other"):
                other.append((us / 1e3 / n, evt.count / n, evt.key[:90]))
            ms, cnt = groups.get(g, (0.0, 0))
            groups[g] = (ms + us / 1e3 / n, cnt + evt.count)
            kernels += evt.count
        busy = sum(ms for ms, _ in groups.values())
        label = f"n = {name}" if args.train else name
        print(f"{label} at {where}: {step_ms:.3f} ms/step unprofiled "
              f"(host thread CPU {cpu_ms:.3f} ms/step); device busy "
              f"{busy:.3f} ms/step ({busy / step_ms:.3f} of the step), "
              f"{kernels / n:.1f} kernels/step", flush=True)
        for g, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:8.3f} ms/step  {ms / busy:6.1%}  {cnt / n:7.1f} "
                  f"kernels/step  {g}", flush=True)
        for ms, cnt, key in sorted(other, reverse=True)[:args.top]:
            print(f"    {ms:8.4f} ms/step {cnt:7.1f}/step  {key}", flush=True)


if __name__ == "__main__":
    main()
