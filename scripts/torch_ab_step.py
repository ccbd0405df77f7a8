#!/usr/bin/env python3
"""Host-bound step times of two versions of the PyTorch port, interleaved
in one process on one GPU.

    git archive <commit> | tar -x -C build/ab_base
    python3 scripts/torch_ab_step.py --base build/ab_base [--rounds 12]
        [--steps 10] [--kernels] [--only REGEX]

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

`--kernels` times the kernels instead, at the shapes chip_smoke.py times:
K1's fused forward and backward sweeps (the plume chip_smoke.py holds them
on at 128^3 with windows 1 and 2, the same flags at rest, random
obstacles with a random flow past the window) and its unfused forms (the
'Ours' renormalised pair at 6x64^3 and 1x128^3), K2 at 128^3 on the plume
and on its random 1x37x45x61 case and on random obstacles at 6x64^3 and
1x64^3, K4 at 6x64^3 and 1x128^3 (K1, K2 and K4 also at each other tile
height of this version, K1 with its tiling printed), K6 at 6x64^3 and
1x128^3 (G = 3, the unfused sweep's own positions), K5 at 128^3 (G = 1,
F = 1, min/max) and
the 2-D server's forms (a) and (c) at 128^2, K3 at 128^3 on the plume
chip_smoke.py holds it on (flags and divergence after 12 ConvNet steps)
with 34 and 8 sweeps, on the same flags with random and with zero
divergence at 34, and at 128^2 (random obstacles) with 34. Each
version's call is captured 50 times in a CUDA graph, the graphs replayed
in turns (`--rounds`, alternating which goes first), and the median and
minimum device ms per call printed; both versions' outputs must be
equal. Then the m3d_v5 train step at horizon n = 4 (6x64^3), interleaved
as the paths above (ms per step on the host clock). `--only REGEX` keeps
the kernel cases and paths whose names match.
"""

import argparse
import functools
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


def train_runner(pkg, dev, n_future=4, batch_size=6, res=64):
    """run(n): n train_step calls of `pkg` at horizon n_future with m3d_v5's
    recipe on one batch of generated-scene fields (the same batch for every
    version: numpy, seed 29)."""
    import numpy as np

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    cfg, gen, train = mod("core.config"), mod("data.generate"), \
        mod("train.train")
    mconf = cfg.parse_args(cfg.default_conf(), tps.TRAIN_RECIPE).new_model
    rng = np.random.default_rng(29)
    zyx = (res, res, res)
    batch = {
        "flags": np.concatenate([gen.random_obstacle_flags(rng, zyx, True)
                                 for _ in range(batch_size)]),
        "u_div": np.concatenate([gen.divergence_free_noise(
            rng, zyx, True, amplitude=float(rng.random() * 4 + 1))
            for _ in range(batch_size)]).astype(np.float32),
        "p_div": np.zeros((batch_size, 1) + zyx, np.float32),
        "density": rng.random((batch_size, 1) + zyx).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    box = {"state": train.init_train_state(17, mconf, dev)}

    def run(n):
        for _ in range(n):
            g = torch.Generator().manual_seed(box["state"].step)
            box["state"], _ = train.train_step(box["state"], batch, g, mconf,
                                               n_future)
    return run


def kernel_cases(dev):
    """{name: (kernel, args)} at chip_smoke.py's timed shapes; kernel is
    'warp' (ops/warp.py::warp_group), 'warp_transpose'
    (ops/cuda/warp_transpose.py::warp_transpose_cuda), 'jacobi'
    (solvers/cuda_jacobi.py::jacobi_cuda), 'prologue', 'forces_block' or
    'vorticity' (ops/cuda/forces_kernel.py's prologue_cuda,
    forces_block_cuda, vorticity_cuda)."""
    import numpy as np

    import chip_smoke as cs
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_tpu_torch.ops.cuda import mac_sweep
    from fluidnet_tpu_torch.ops.divergence import velocity_divergence
    from fluidnet_tpu_torch.utils.checkpoint import load_mconf, load_params
    rng = np.random.default_rng(41)
    cases = {}
    mconf = load_mconf(cs.BUNDLED).replace(**cs.BENCH_KNOBS)
    model = FluidNet(mconf, device=dev).load_jax_params(
        load_params(cs.BUNDLED))
    state, bcs = cs.rolled_plume(dev, mconf, model)
    flags = state.flags
    div = velocity_divergence(state.u, flags)
    rnd = cs.random_case(dev)
    for label, case in ((f"{cs.RES}^3 plume", cs.plume_forces_args(
            state, bcs, mconf.dt)), ("1x37x45x61 random",
                                     cs.random_forces_args(rnd, mconf.dt))):
        cases[f"K2 prologue {label}"] = ("prologue", case)
        cases[f"K2 forces block {label}"] = ("forces_block", case[:7])
    cases.update(k1_cases(dev, cs, state, mconf))
    for b, res in ((cs.TRAIN_B, cs.TRAIN_RES), (1, cs.TRAIN_RES)):
        # The training batch's and the stats / exact route's shapes.
        c = cs.train_case(dev, b, res, 31 + b)
        args = (c["u"], c["flags"], c["s"], [0.0, -0.1, 0.0], [0.0] * 3,
                3.0 / res, mconf.dt)
        cases[f"K2 prologue {b}x{res}^3"] = ("prologue", args)
        cases[f"K2 forces block {b}x{res}^3"] = ("forces_block", args)
    for b, res in ((cs.TRAIN_B, cs.TRAIN_RES), (1, cs.RES)):
        c = cs.train_case(dev, b, res, 31 + b)
        cases[f"K4 {b}x{res}^3"] = ("vorticity", (c["u"], c["flags"],
                                                  3.0 / res))
    for n in (34, 8):
        cases[f"K3 {cs.RES}^3 {n} sweeps"] = ("jacobi", (flags, div, n))
    # The same flags with other divergences: how the time depends on the
    # values (the plume's is exactly 0 outside the plume).
    for label, other in (("random", torch.tensor(rng.standard_normal(
            flags.shape).astype(np.float32), device=dev)),
            ("zero", torch.zeros_like(div))):
        cases[f"K3 {cs.RES}^3 34 sweeps, {label} div"] = ("jacobi", (
            flags, other, 34))
    shape2 = (1, 1, 1, cs.RES2, cs.RES2)
    cases[f"K3 {cs.RES2}^2 34 sweeps"] = ("jacobi", (
        torch.tensor(cs.random_flags(rng, shape2), device=dev),
        torch.tensor(rng.standard_normal(shape2).astype(np.float32),
                     device=dev), 34))
    for b, res in ((cs.TRAIN_B, cs.TRAIN_RES), (1, cs.RES)):
        c = cs.train_case(dev, b, res, 31 + b)
        pos = mac_sweep.positions_for_vjp(c["u"], c["free"], -0.1, 1, True)
        g = torch.randn((b, 3, 1, res, res, res), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
        cases[f"K6 {b}x{res}^3 G=3"] = ("warp_transpose",
                                        (g, *pos, 1, False))
    field, pos = cs.warp_3d_case(dev, (1, 1, cs.RES, cs.RES, cs.RES), 1,
                                 0.999, 24)
    cases[f"K5 {cs.RES}^3 G=1 F=1 minmax"] = ("warp",
                                              (field, *pos, 1, False, True))
    sim = cs.serve_sim(dev)
    state = cs.serve_steps(sim.state, sim.mconf, sim.model, sim.bcs, 10,
                           sim.consts)
    calls = cs.record_warp_calls(lambda: cs.serve_steps(
        state, sim.mconf, sim.model, sim.bcs, 1, sim.consts))
    for label, form in (("(a)", "five_sources"), ("(c)", "group_minmax")):
        call = next(c for c in calls if cs.warp_form(c) == form)
        cases[f"K5 {cs.RES2}^2 {label} {form}"] = ("warp", call)
    return cases


def k1_cases(dev, cs, state, mconf):
    """K1's cases: the fused forward and backward sweeps at 128^3 on the
    plume chip_smoke.py holds them on (W = 1 and 2), on the same flags at
    rest (every corner a cell's own row) and on random obstacles with a
    random flow past the window (scattered corners); the unfused forward
    (scalar, renorm, 14 channels) and backward (12) at 6x64^3 and 1x128^3
    on chip_smoke.py's training cases."""
    from fluidnet_tpu_torch.core.celltype import is_fluid
    from fluidnet_tpu_torch.ops.advect_fast import chebyshev_free_space
    from fluidnet_tpu_torch.ops.cuda import mac_sweep
    dt, strength = mconf.dt, mconf.maccormack_strength
    flags = state.flags
    m = is_fluid(flags).to(torch.float32)
    rnd = cs.train_case(dev, 1, cs.RES, 32)
    flows = {"plume": (state.u, state.density, m, flags, 1),
             "plume W=2": (state.u, state.density, m, flags, 2),
             "at rest": (torch.zeros_like(state.u), state.density, m, flags,
                         1),
             "random": (rnd["u"], rnd["s"], rnd["m"], rnd["flags"], 1)}
    cases = {}
    for label, (u, s, mm, fl, W) in flows.items():
        free = chebyshev_free_space(fl, W + 1)
        fwd = (u, s, mm, None, None, free, -dt, strength, W, True, True)
        ref = mac_sweep.sweep_fused_ep_plain(*fwd)
        bwd = (u, s, mm, ref["u_w"].contiguous(), ref["s_val"].contiguous(),
               free, dt, strength, W, True, True)
        cases[f"K1 fused fwd {cs.RES}^3 {label}"] = ("mac_sweep_fused", fwd)
        cases[f"K1 fused bwd {cs.RES}^3 {label}"] = ("mac_sweep_fused", bwd)
    for b, res in ((cs.TRAIN_B, cs.TRAIN_RES), (1, cs.RES)):
        c = cs.train_case(dev, b, res, 31 + b)
        fwd = (c["u"], c["s"], c["m"], None, None, c["free"], -dt, 1, True,
               True, True)
        raw = mac_sweep.sweep_plain(*fwd)
        bwd = (c["u"], None, c["m"], raw[:, 0:3].contiguous(),
               raw[:, 9:10].contiguous(), c["free"], dt, 1, True, True, True)
        cases[f"K1 unfused fwd {b}x{res}^3"] = ("mac_sweep_unfused", fwd)
        cases[f"K1 unfused bwd {b}x{res}^3"] = ("mac_sweep_unfused", bwd)
    return cases


def kernel_fn(pkg, kernel, args, **kw):
    module, name = {"mac_sweep_fused": ("ops.cuda.mac_sweep",
                                        "advect_sweep_fused_ep"),
                    "mac_sweep_unfused": ("ops.cuda.mac_sweep", "sweep_cuda"),
                    "warp": ("ops.warp", "warp_group"),
                    "warp_transpose": ("ops.cuda.warp_transpose",
                                       "warp_transpose_cuda"),
                    "jacobi": ("solvers.cuda_jacobi", "jacobi_cuda"),
                    "prologue": ("ops.cuda.forces_kernel", "prologue_cuda"),
                    "forces_block": ("ops.cuda.forces_kernel",
                                     "forces_block_cuda"),
                    "vorticity": ("ops.cuda.forces_kernel",
                                  "vorticity_cuda")}[kernel]
    return functools.partial(getattr(importlib.import_module(
        f"{pkg}.{module}"), name), *args, **kw)


def equal(a, b):
    """torch.equal, element by element for a tuple or dict of tensors."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(equal, a, b))
    return torch.equal(a, b)


def capture(fn, n):
    """A CUDA graph of n calls of fn (warmed up on a side stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return graph


def replay_ms(graph, n, reps=5):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def kernels_ab(base_pkg, dev, rounds, only, n=50):
    """K1-K6 of both versions from CUDA graphs, in turns, the cases whose
    names match the regex `only`; K1, K2 and K4 of this version also at
    its other tile heights ("this_ty<h>")."""
    import chip_smoke as cs
    from fluidnet_tpu_torch.ops.cuda import mac_sweep
    from fluidnet_tpu_torch.ops.cuda._build import sm_count
    from fluidnet_tpu_torch.ops.cuda.forces_kernel import (
        TILE_YS, prologue_tiling)
    for name, (kernel, args) in kernel_cases(dev).items():
        if not re.search(only, name):
            continue
        fns = {"base": kernel_fn(base_pkg, kernel, args),
               "this": kernel_fn(PKG, kernel, args)}
        tiling, heights = None, ()
        if kernel in ("prologue", "forces_block", "vorticity"):
            tiling = prologue_tiling(args[0].shape, sm_count(dev.index),
                                     epi=kernel == "prologue")
            heights = TILE_YS
        elif kernel.startswith("mac_sweep"):
            tiling = cs.k1_tiling(args, kernel == "mac_sweep_fused")
            heights = mac_sweep.TILE_YS if tiling else ()
        for ty in heights:
            if ty != tiling.tile_y:
                fns[f"this_ty{ty}"] = kernel_fn(PKG, kernel, args, tile_y=ty)
        outs = {who: fn() for who, fn in fns.items()}
        for who, out in outs.items():
            if not equal(outs["base"], out):
                raise AssertionError(f"{name}: {who}'s output differs from "
                                     "base's")
        graphs = {who: capture(fn, n) for who, fn in fns.items()}
        times = {who: [] for who in fns}
        order = list(fns)
        for rnd in range(rounds):
            for who in (order if rnd % 2 == 0 else order[::-1]):
                times[who].append(replay_ms(graphs[who], n))
        print(json.dumps({"kernel": name, **({"tiling": tiling._asdict()}
                                             if tiling else {}), **{
            f"{who}_ms": {"median": statistics.median(t), "min": min(t)}
            for who, t in times.items()}}), flush=True)
        del graphs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="an unpacked checkout of the version to compare")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--kernels", action="store_true",
                    help="K1-K6 from CUDA graphs, then the n = 4 "
                    "train step")
    ap.add_argument("--only", default="",
                    help="a regex: only the kernel cases and paths whose "
                    "names match it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_step: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    base_pkg = stage_base(os.path.abspath(args.base))
    if args.kernels:
        kernels_ab(base_pkg, dev, args.rounds, args.only)
        versions = {"base": {"train n=4 6x64^3": train_runner(base_pkg,
                                                              dev)},
                    "this": {"train n=4 6x64^3": train_runner(PKG, dev)}}
    else:
        versions = {"base": runners(base_pkg, dev),
                    "this": runners(PKG, dev)}
    for path in versions["this"]:
        if not re.search(args.only, path):
            continue
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
