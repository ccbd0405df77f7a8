#!/usr/bin/env python3
"""Where a step of the PyTorch port's 128^3 plume rollout spends its time
on the GPU, for each projection.

    python3 scripts/torch_profile_step.py [--res 128] [--steps 10]
        [--warmup 20] [--only convnet,jacobi34,pcg,convnet_p8]

For each projection (the ConvNet with the bundled m3d_v5_bestRollout
weights and bench.py's knobs; ConvNet + 8 Jacobi polish sweeps; jacobi-34;
PCG with 100 iterations at tol 1e-4), from a t = 0 plume: `--warmup`
steps, then `--steps` steps timed on the host clock without the profiler,
then `--steps` steps under torch.profiler. Prints per step: the
unprofiled time, the device time of each group of kernels (K1, K2
prologue, K2 forces block, K3, the convolutions, everything else), the
number of device kernels, and the device busy time against the
unprofiled step (1 - busy / step is the idle share). Needs a CUDA device.
"""

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fluidnet_tpu_torch.core.grids import FluidState, empty_domain  # noqa
from fluidnet_tpu_torch.models.fluidnet import FluidNet  # noqa: E402
from fluidnet_tpu_torch.sim.simulate import (create_plume_bcs,  # noqa
                                             rollout)
from fluidnet_tpu_torch.utils.checkpoint import (load_mconf,  # noqa: E402
                                                 load_params)

BUNDLED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "models_bundled", "m3d_v5_bestRollout")
BENCH_KNOBS = dict(sim_method="convnet", dt=0.1, buoyancy_scale=2.0,
                   vorticity_confinement_amp=3.0, maccormack_strength=0.6,
                   advection_method="maccormackOurs", adaptive_window=False,
                   advection_window=1)
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


def device_us(evt):
    t = getattr(evt, "self_device_time_total", None)
    return t if t is not None else evt.self_cuda_time_total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--only", default=",".join(PROJECTIONS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_step: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    base = load_mconf(BUNDLED).replace(**BENCH_KNOBS)
    model = FluidNet(base, device=dev).load_jax_params(load_params(BUNDLED))
    n = args.steps
    for name in args.only.split(","):
        mconf = base.replace(**PROJECTIONS[name])
        net = model if mconf.sim_method == "convnet" else None
        state, bcs = plume(dev, args.res)
        state = rollout(state, mconf, args.warmup, net, bcs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = rollout(state, mconf, n, net, bcs)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = rollout(state, mconf, n, net, bcs)
            torch.cuda.synchronize()
        groups, kernels = {}, 0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = device_us(evt)
            if us <= 0:
                continue
            g = group_of(evt.key)
            ms, cnt = groups.get(g, (0.0, 0))
            groups[g] = (ms + us / 1e3 / n, cnt + evt.count)
            kernels += evt.count
        busy = sum(ms for ms, _ in groups.values())
        print(f"{name} at {args.res}^3: {step_ms:.3f} ms/step unprofiled; "
              f"device busy {busy:.3f} ms/step ({busy / step_ms:.3f} of the "
              f"step), {kernels / n:.1f} kernels/step", flush=True)
        for g, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {ms:8.3f} ms/step  {ms / busy:6.1%}  {cnt / n:7.1f} "
                  f"kernels/step  {g}", flush=True)


if __name__ == "__main__":
    main()
