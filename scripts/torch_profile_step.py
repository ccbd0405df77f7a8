#!/usr/bin/env python3
"""Where a step of the PyTorch port spends its time on the GPU, for each
projection: the 128^3 plume rollout, or the 2-D demo server's step.

    python3 scripts/torch_profile_step.py [--res 128] [--steps 10]
        [--warmup 20] [--only convnet,jacobi34,pcg,convnet_p8]
    python3 scripts/torch_profile_step.py --serve2d [--res 128]
        [--only convnet,jacobi34,pcg]

3-D: each projection (the ConvNet with the bundled m3d_v5_bestRollout
weights and bench.py's knobs; ConvNet + 8 Jacobi polish sweeps; jacobi-34;
PCG with 100 iterations at tol 1e-4) on a t = 0 plume. --serve2d: the step
of cli/serve.py (bundled m2d ConvNet, RGB density, maccormackOurs with the
adaptive window, buoyancy 1, the force overrides) with the ConvNet,
jacobi-34 or PCG, on a res^2 plume. Each: `--warmup` steps, then `--steps`
steps timed on the host clock without the profiler, then `--steps` steps
under torch.profiler. Prints per step: the unprofiled time, the device
time of each group of kernels (K1, K2 prologue, K2 forces block, K3, K5,
the convolutions, everything else), the number of device kernels, and the
device busy time against the unprofiled step (1 - busy / step is the idle
share). Needs a CUDA device.
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
from fluidnet_tpu_torch.models.fluidnet import FluidNet  # noqa: E402
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
# Kernel-name fragments of each group, tested in this order.
GROUPS = (("K1 mac_sweep", ("mac_sweep_kernel",)),
          ("K2 prologue", ("prologue_kernel<true>",
                           "prologue_kernelILb1E")),
          ("K2 forces block", ("prologue_kernel<false>",
                               "prologue_kernelILb0E")),
          ("K3 jacobi", ("jacobi_sweep",)),
          ("K5 warp", ("warp_kernel",)),
          ("convolutions", ("conv", "xmma", "gemm", "cudnn", "cutlass")),
          )


def group_of(name):
    for group, frags in GROUPS:
        if any(f in name for f in frags):
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


def device_us(evt):
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else evt.self_cuda_time_total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--only", default="")
    ap.add_argument("--top", type=int, default=0,
                    help="also list the N busiest ungrouped kernels")
    ap.add_argument("--serve2d", action="store_true",
                    help="profile the 2-D demo server's step (m2d)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_step: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    if args.serve2d:
        path, make, where = M2D, runner_serve2d, f"{args.res}^2 (serve)"
        base = load_mconf(M2D).replace(**SERVE_KNOBS)
    else:
        path, make, where = BUNDLED, runner_3d, f"{args.res}^3"
        base = load_mconf(BUNDLED).replace(**BENCH_KNOBS)
    model = FluidNet(base, device=dev).load_jax_params(load_params(path))
    n = args.steps
    only = args.only or ("convnet,jacobi34,pcg" if args.serve2d
                         else ",".join(PROJECTIONS))
    for name in only.split(","):
        run = make(dev, args.res, name, model, base)
        run(args.warmup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
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
        print(f"{name} at {where}: {step_ms:.3f} ms/step unprofiled; "
              f"device busy {busy:.3f} ms/step ({busy / step_ms:.3f} of the "
              f"step), {kernels / n:.1f} kernels/step", flush=True)
        for g, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:8.3f} ms/step  {ms / busy:6.1%}  {cnt / n:7.1f} "
                  f"kernels/step  {g}", flush=True)
        for ms, cnt, key in sorted(other, reverse=True)[:args.top]:
            print(f"    {ms:8.4f} ms/step {cnt:7.1f}/step  {key}", flush=True)


if __name__ == "__main__":
    main()
