#!/usr/bin/env python3
"""Host-bound step times of two versions of the PyTorch port, interleaved
in one process on one GPU.

    git archive <commit> | tar -x -C build/ab_base
    python3 scripts/torch_ab_step.py --base build/ab_base [--rounds 12]
        [--steps 10]

`--base` is an unpacked checkout of another commit. Its fluidnet_tpu_torch
package is copied, renamed fluidnet_tpu_torch_base, into
build/ab_step/ (it builds its own kernels there), so both versions load
side by side. For each path (the 2-D demo server's step at 128^2, as
scripts/torch_profile_step.py --serve2d runs it; the 128^3 plume rollout
with the ConvNet and with jacobi-34, bench.py's knobs) both versions warm
up, then run `--rounds` blocks of `--steps` steps each, alternating which
goes first. These steps are bound, wholly or in part, by the host's cost
of issuing their kernels, so times taken in separate processes on a
shared host differ by more than a small change moves them; interleaving
in one process puts both versions under the same load. Prints the card's
name and power limit, then one line per path with the median and the
minimum ms/step of each version. Needs a CUDA device.
"""

import argparse
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_profile_step as tps  # noqa: E402

PKG = "fluidnet_tpu_torch"


def stage_base(base):
    """Copies base/fluidnet_tpu_torch into build/ab_step as
    fluidnet_tpu_torch_base, imports renamed; returns the package name."""
    dst_root = os.path.join(ROOT, "build", "ab_step")
    dst = os.path.join(dst_root, PKG + "_base")
    shutil.rmtree(dst_root, ignore_errors=True)
    shutil.copytree(os.path.join(base, PKG), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    word = re.compile(rf"\b{PKG}\b")
    for folder, _, files in os.walk(dst):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(folder, name)
                with open(path) as f:
                    text = f.read()
                with open(path, "w") as f:
                    f.write(word.sub(PKG + "_base", text))
    sys.path.insert(0, dst_root)
    return PKG + "_base"


def runners(pkg, dev):
    """{path: run(n)} for the package `pkg`."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    demo2d, grids, fnet = mod("cli.demo2d"), mod("core.grids"), \
        mod("models.fluidnet")
    sim, ck = mod("sim.simulate"), mod("utils.checkpoint")
    out = {}

    base2 = ck.load_mconf(tps.M2D).replace(**tps.SERVE_KNOBS)
    m2d = fnet.FluidNet(base2, device=dev).load_jax_params(
        ck.load_params(tps.M2D))
    box2 = {"state": demo2d.initial_state(128, dev)}
    bcs2, consts = demo2d.plume_bcs(box2["state"]), sim.FlagConsts()

    def serve(n):
        for _ in range(n):
            box2["state"] = sim.simulate(
                box2["state"], base2, m2d, bcs2, dt=base2.dt,
                buoyancy_scale=base2.buoyancy_scale,
                vorticity_amp=base2.vorticity_confinement_amp,
                consts=consts)
    out["serve2d convnet 128^2"] = serve

    base3 = ck.load_mconf(tps.BUNDLED).replace(**tps.BENCH_KNOBS)
    m3d = fnet.FluidNet(base3, device=dev).load_jax_params(
        ck.load_params(tps.BUNDLED))
    for name in ("convnet", "jacobi34"):
        mconf = base3.replace(**tps.PROJECTIONS[name])
        shape = (1, 1, 128, 128, 128)
        state = grids.FluidState(
            u=torch.zeros((1, 3) + shape[2:], device=dev),
            p=torch.zeros(shape, device=dev),
            flags=grids.empty_domain(shape, True, device=dev),
            density=torch.zeros(shape, device=dev))
        box = {"state": state, "bcs": sim.create_plume_bcs(
            state, [1.0], u_scale=0.6, rad=0.15)}

        def run(n, box=box, mconf=mconf,
                net=m3d if name == "convnet" else None):
            box["state"] = sim.rollout(box["state"], mconf, n, net,
                                       box["bcs"])
        out[f"3-D {name} 128^3"] = run
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="an unpacked checkout of the version to compare")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_step: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    versions = {"base": runners(stage_base(os.path.abspath(args.base)),
                                dev),
                "this": runners(PKG, dev)}
    for path in versions["this"]:
        for v in versions.values():
            v[path](args.steps)
        times = {"base": [], "this": []}
        for rnd in range(args.rounds):
            order = ("base", "this") if rnd % 2 == 0 else ("this", "base")
            for who in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                versions[who][path](args.steps)
                torch.cuda.synchronize()
                times[who].append((time.perf_counter() - t0) / args.steps
                                  * 1e3)
        print(json.dumps({"path": path, **{
            f"{who}_ms": {"median": statistics.median(t), "min": min(t)}
            for who, t in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
