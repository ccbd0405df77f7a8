#!/usr/bin/env python3
"""Smoke test of the PyTorch port (fluidnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card: the 3-D 128^3 plume that bench.py
times for the JAX package (the ConvNet rollout and the jacobi-34 / PCG /
ConvNet + Jacobi-polish certification rollouts), and the 2-D interactive
demo server (cli/serve.py with the bundled m2d ConvNet at 128^2), in
these phases:

  1. device: fails without CUDA; prints the card's name and power limit.
  2. build:  compiles the CUDA kernels (csrc/*.cu, one nvcc per source, all
             at once, into build/kernels/) and prints the seconds it took
             and ptxas's registers and spills per kernel.
  3. kernels vs plain: each 3-D kernel (K1 forward, K1 backward, K2
             prologue, K2 forces block, K3 Jacobi) against its plain
             PyTorch version on the same CUDA inputs: on the 128^3 plume
             state after a few steps, on a 1x37x45x61 grid with random
             obstacles, Stick and Empty cells and slab BCs, and (K3) on a
             2-D 2x1x45x61 grid. Fails above 1e-5 of the field's largest
             value. Times both versions at 128^3 with CUDA events (K3 at 34
             sweeps).
  4. warp (K5) vs plain: every K5 call that one 2-D step makes, for each
             advection method at windows 1 and 2, recorded on a 128^2 serve
             plume after a few steps and on a random 2x1x1x45x61 grid with
             15% obstacles and fast flow (positions past the borders),
             replayed against the plain version; plus a 3-D 1x37x45x61
             case, trilinear with min/max and nearest. Same limit. Times
             the serve's forms at 128^2 and the G=1 F=1 min/max form at
             128^3 beside torch grid_sample (timed, never used).
  5. slice:  the bundled checkpoint (data/models_bundled/m3d_v5_bestRollout,
             read by the port's own reader) with bench.py's knobs on a
             128^3 plume: 30 warm-up steps, then 4 x 30 timed steps. The
             launch counters must show K1 twice and K2's prologue once per
             step; the final state must be finite. Then 8 steps with the
             kernels against 8 with the plain versions, from that state.
  6. certification, as bench.py:168-195: from a fresh t = 0 plume, 150
             steps each of jacobi-34, PCG (100 iterations, tol 1e-4) and
             the ConvNet with 8 Jacobi polish sweeps, each with its launch
             counters read on their own. Every final state must be finite
             and PCG's ||div||_2 below jacobi-34's. Then 8 jacobi-34 and 8
             ConvNet + p8 steps with the kernels against 8 of each with the
             plain versions, from the certification states.
  7. serve:  DemoSim(res=128, model=m2d) on the card, its loop thread and
             the HTTP server on 127.0.0.1: GET /, /frame.png (a 128x128 PNG
             checked with zlib), /stats (frames advancing, fps > 0), POST
             /splat and /toggle (200), a bad toggle (400). Then the toggles
             sim_method=jacobi, advection=maccormack, euler and back, each
             step's K5 launches (8, 20, 4 for maccormackOurs, maccormack,
             euler) and K3's (once per jacobi step) counted; a strong splat
             must force window 2, the calm plume window 1.
  8. 2-D timing and certification with the serve's knobs on a fresh 128^2
             plume: 30 warm-up and 4 x 30 timed steps; 150 steps each of the
             ConvNet, jacobi-34 and PCG, finite, PCG's ||div||_2 below
             jacobi-34's; 8 ConvNet and 8 jacobi-34 steps with the kernels
             against 8 with the plain versions.

The last three lines are the card's name and power limit, a JSON object
with one entry per kernel, and {"ok": true, "device": {...}}. Any failure
raises: the exit code is then not 0 and no result line is printed.
"""


import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch

RES = 128
WARMUP, STEPS, REPS = 30, 30, 4
CERT_STEPS = (1 + REPS) * STEPS   # bench.py's total_steps
TOL = 1e-5          # kernel vs plain: max abs error / the field's max
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3 memory rate
PEAK_F32_S = 67e12       # H100 SXM float32 outside the tensor cores
BUNDLED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "models_bundled", "m3d_v5_bestRollout")
M2D = os.path.join(os.path.dirname(BUNDLED), "m2d")
RES2 = 128                      # the server's default resolution
BENCH_KNOBS = dict(sim_method="convnet", dt=0.1, buoyancy_scale=2.0,
                   vorticity_confinement_amp=3.0, maccormack_strength=0.6,
                   advection_method="maccormackOurs", adaptive_window=False,
                   advection_window=1)
# The certification projections of bench.py:184-195 and the hybrid, with
# the kernels each step launches besides K1's two sweeps.
CERT = {"jacobi34": (dict(sim_method="jacobi", max_iter=34),
                     {"forces_block": 1, "jacobi": 1}),
        "pcg": (dict(sim_method="pcg", max_iter=100, pcg_tol=1e-4),
                {"forces_block": 1}),
        "convnet_p8": (dict(polish_iters=8), {"prologue": 1, "jacobi": 1})}
KERNELS = {
    "mac_sweep_fwd": ("fluidnet_tpu_torch/csrc/mac_sweep.cu",
                      "fluidnet_tpu/ops/pallas/mac_sweep.py:57"),
    "mac_sweep_bwd": ("fluidnet_tpu_torch/csrc/mac_sweep.cu",
                      "fluidnet_tpu/ops/pallas/mac_sweep.py:57"),
    "prologue": ("fluidnet_tpu_torch/csrc/prologue.cu",
                 "fluidnet_tpu/ops/pallas/forces_kernel.py:219"),
    "forces_block": ("fluidnet_tpu_torch/csrc/prologue.cu",
                     "fluidnet_tpu/ops/pallas/forces_kernel.py:219"),
    "jacobi": ("fluidnet_tpu_torch/csrc/jacobi.cu",
               "fluidnet_tpu/solvers/pallas_jacobi.py:35"),
    "warp": ("fluidnet_tpu_torch/csrc/warp.cu",
             "fluidnet_tpu/ops/pallas/warp.py:159"),
}
# K5's forms on the 2-D path, by (G, source channel counts, nearest,
# minmax) of ops/warp.py::warp_group.
WARP_FORMS = {(1, (1, 1, 1, 1, 1), False, (0, 1)): "five_sources",
              (1, (1, 1, 1), False, False): "warp_fluid",
              (2, (1,), False, True): "group_minmax",
              (2, (1, 1), False, True): "group_two_sources",
              (1, (1,), False, False): "trilinear_shared",
              (2, (1,), False, False): "trilinear",
              (1, (2,), True, False): "gather_cells_packed",
              (1, (1,), True, False): "gather_cells_obstacle"}
# K5 launches per 2-D step with RGB density, by advection method.
SERVE_K5_PER_STEP = {"maccormackOurs": 8, "maccormack": 20, "euler": 4,
                     "eulerOurs": 4}
# Float operations per cell, counted from each kernel's source (adds,
# multiplies, divisions, square roots, min/max; selects not counted).
# K3 counts per active (interior, non-obstacle) cell and sweep: 5 adds, the
# div add and one division in 3-D.
FLOPS_PER_CELL = {"mac_sweep_fwd": 378, "mac_sweep_bwd": 378,
                  "prologue": 81, "forces_block": 76}
JACOBI_FLOPS_3D = 7


def log(*a):
    print(*a, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # f32 stays f32: no TF32 in convolutions or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    return smi


def cuda_ms(fn, n):
    """Mean milliseconds of fn() over n runs, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n, reps=5):
    """Mean milliseconds of one fn() replayed from a CUDA graph of n
    captured calls: the device time, without the host's cost of issuing
    each call (which bounds a kernel of a few microseconds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, reps) / n


def bound(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes over the card's
    memory rate and the float32 operations over its peak rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def make_plume(dev):
    from fluidnet_tpu_torch.core.grids import FluidState, empty_domain
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs
    shape = (1, 1, RES, RES, RES)
    state = FluidState(
        u=torch.zeros((1, 3) + shape[2:], device=dev),
        p=torch.zeros(shape, device=dev),
        flags=empty_domain(shape, True, device=dev),
        density=torch.zeros(shape, device=dev))
    return state, create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)


def random_flags(rng, shape):
    """15% obstacles, an obstacle border (x/y only in 2-D), Stick and Empty
    cells."""
    flags = np.where(rng.random(shape) < 0.15, 2, 1)
    flags[..., 0, :] = flags[..., -1, :] = 2
    flags[..., :, 0] = flags[..., :, -1] = 2
    if shape[2] > 1:
        flags[:, :, 0] = flags[:, :, -1] = 2
    flags = np.where((flags == 1) & (rng.random(shape) < 0.08), 128, flags)
    flags = np.where((flags == 1) & (rng.random(shape) < 0.05), 4, flags)
    return flags.astype(np.int32)


def random_case(dev, seed=7):
    """1x37x45x61 with 15% obstacles, Stick and Empty cells, slab BCs."""
    rng = np.random.default_rng(seed)
    Z, Y, X = 37, 45, 61
    flags = random_flags(rng, (1, 1, Z, Y, X))

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    return {
        "flags": torch.tensor(flags, device=dev),
        # ~3 cells/step at dt 0.1: exercises the +-(W - 1e-3) clip.
        "u": t(rng.standard_normal((1, 3, Z, Y, X)) * 3.0),
        "s": t(rng.random((1, 1, Z, Y, X))),
        "div": t(rng.standard_normal((1, 1, Z, Y, X))),
        "u_bc": t(rng.standard_normal((1, 3, Z, 4, X)) * 0.3),
        "u_inv": t(rng.random((1, 3, Z, 4, X)) < 0.5),
    }


def max_err(out, ref, what, quiet=False):
    """Per-channel max abs error; raises above TOL x the channel's largest
    value (the +-1e30 'no fluid corner' sentinels excluded from the
    scale, not from the error). `quiet` logs nothing."""
    worst = 0.0
    for c in range(ref.shape[1]):
        r, o = ref[:, c], out[:, c]
        # Equal values count as no error, +-inf (no corner in the window)
        # included.
        err = torch.where(o == r, 0.0, (o - r).abs()).max().item()
        finite = r.abs() < 1e29
        scale = max(r[finite].abs().max().item() if finite.any() else 0.0,
                    1.0)
        if not quiet:
            log(f"  {what}[{c}]: max abs err {err:.3e} (field max "
                f"{scale:.3e}){'; bit-identical' if torch.equal(o, r) else ''}")
        if not err <= TOL * scale:
            raise AssertionError(f"{what} channel {c}: kernel vs plain max "
                                 f"abs err {err} > {TOL} x {scale}")
        worst = max(worst, err)
    return worst


def kernels_phase(dev, mconf, model):
    from fluidnet_tpu_torch.core.celltype import is_fluid, is_obstacle
    from fluidnet_tpu_torch.core.grids import border_mask, get_dx
    from fluidnet_tpu_torch.ops.advect_fast import chebyshev_free_space
    from fluidnet_tpu_torch.ops.cuda import forces_kernel, mac_sweep
    from fluidnet_tpu_torch.ops.divergence import velocity_divergence
    from fluidnet_tpu_torch.ops.forces import forces_block_xla
    from fluidnet_tpu_torch.sim.simulate import rollout
    from fluidnet_tpu_torch.solvers.cuda_jacobi import (jacobi_cuda,
                                                        jacobi_plain)

    dt, strength, W = mconf.dt, mconf.maccormack_strength, 1
    state, bcs = make_plume(dev)
    state = rollout(state, mconf, 12, model, bcs)
    dx = get_dx(state.flags)
    plume = {"flags": state.flags, "u": state.u, "s": state.density,
             "div": velocity_divergence(state.u, state.flags),
             "u_bc": bcs.u_bc, "u_inv": bcs.u_bc_inv_mask,
             "buoy_g": [0.0, -(dx / 4.0) * 2.0, 0.0], "grav_g": [0.0] * 3,
             "amp": 3.0 * dx}
    rnd = random_case(dev)
    rnd.update(buoy_g=[0.01, -0.2, 0.03], grav_g=[0.0, -0.05, 0.02],
               amp=0.7)
    errs = {k: 0.0 for k in KERNELS}
    calls = {}
    for name, case in (("plume 1x128^3", plume), ("random 1x37x45x61", rnd)):
        log(f"kernels vs plain on {name}:")
        flags = case["flags"]
        m = is_fluid(flags).to(torch.float32)
        free = chebyshev_free_space(flags, W + 1)
        fwd_args = (case["u"], case["s"], m, None, None, free, -dt,
                    strength, W, True, True)
        ref_f = mac_sweep.sweep_fused_ep_plain(*fwd_args)
        out_f = mac_sweep.advect_sweep_fused_ep(*fwd_args)
        bwd_args = (case["u"], case["s"], m, ref_f["u_w"].contiguous(),
                    ref_f["s_val"].contiguous(), free, dt, strength, W,
                    True, True)
        ref_b = mac_sweep.sweep_fused_ep_plain(*bwd_args)
        out_b = mac_sweep.advect_sweep_fused_ep(*bwd_args)
        pro_args = (case["u"], flags, case["s"], case["buoy_g"],
                    case["grav_g"], case["amp"], dt, case["u_bc"],
                    case["u_inv"])
        ref_p = forces_kernel.prologue_plain(*pro_args)
        out_p = forces_kernel.prologue_cuda(*pro_args)
        fb_args = pro_args[:7]
        ref_fb = forces_block_xla(*fb_args)
        out_fb = forces_kernel.forces_block_cuda(*fb_args)
        jac_args = (flags, case["div"], 34)
        ref_j = jacobi_plain(*jac_args)
        out_j = jacobi_cuda(*jac_args)
        torch.cuda.synchronize()
        for key in ref_f:
            errs["mac_sweep_fwd"] = max(errs["mac_sweep_fwd"], max_err(
                out_f[key], ref_f[key], f"K1 fwd {key}"))
        for key in ref_b:
            errs["mac_sweep_bwd"] = max(errs["mac_sweep_bwd"], max_err(
                out_b[key], ref_b[key], f"K1 bwd {key}"))
        for i, what in enumerate(("u''", "div")):
            errs["prologue"] = max(errs["prologue"], max_err(
                out_p[i], ref_p[i], f"K2 prologue {what}"))
        errs["forces_block"] = max(errs["forces_block"], max_err(
            out_fb, ref_fb, "K2 forces block u'"))
        errs["jacobi"] = max(errs["jacobi"], max_err(
            out_j, ref_j, "K3 p (34 sweeps)"))
        if case is plume:
            active = ((~border_mask(flags.shape, True, 1, dev)) &
                      ~is_obstacle(flags)).sum().item()
            calls = {
                "mac_sweep_fwd": (
                    mac_sweep.sweep_fused_ep_plain,
                    mac_sweep.advect_sweep_fused_ep, fwd_args,
                    nbytes(case["u"], case["s"], m, free) +
                    12 * 4 * m.numel(),
                    FLOPS_PER_CELL["mac_sweep_fwd"] * m.numel()),
                "mac_sweep_bwd": (
                    mac_sweep.sweep_fused_ep_plain,
                    mac_sweep.advect_sweep_fused_ep, bwd_args,
                    nbytes(case["u"], case["s"], m, free, bwd_args[3],
                           bwd_args[4]) + 10 * 4 * m.numel(),
                    FLOPS_PER_CELL["mac_sweep_bwd"] * m.numel()),
                "prologue": (
                    forces_kernel.prologue_plain,
                    forces_kernel.prologue_cuda, pro_args,
                    nbytes(case["u"], flags, case["s"], case["u_bc"],
                           case["u_inv"]) + 4 * 4 * m.numel(),
                    FLOPS_PER_CELL["prologue"] * m.numel()),
                "forces_block": (
                    forces_block_xla, forces_kernel.forces_block_cuda,
                    fb_args, nbytes(case["u"], flags, case["s"]) +
                    3 * 4 * m.numel(),
                    FLOPS_PER_CELL["forces_block"] * m.numel()),
                "jacobi": (
                    jacobi_plain, jacobi_cuda, jac_args,
                    nbytes(flags, case["div"]) + 4 * m.numel(),
                    JACOBI_FLOPS_3D * 34 * active),
            }

    log("kernels vs plain on 2-D 2x1x1x45x61 (K3):")
    rng = np.random.default_rng(9)
    shape2 = (2, 1, 1, 45, 61)
    flags2 = torch.tensor(random_flags(rng, shape2), device=dev)
    div2 = torch.tensor(rng.standard_normal(shape2).astype(np.float32),
                        device=dev)
    errs["jacobi"] = max(errs["jacobi"], max_err(
        jacobi_cuda(flags2, div2, 34), jacobi_plain(flags2, div2, 34),
        "K3 2-D p (34 sweeps)"))

    # Times at 128^3, in turns: plain, kernel, kernel, plain.
    times = {}
    for key, (plain, kern, args, nb, flops) in calls.items():
        p1 = cuda_ms(lambda: plain(*args), 5)
        k1 = cuda_ms(lambda: kern(*args), 50)
        k2 = cuda_ms(lambda: kern(*args), 50)
        p2 = cuda_ms(lambda: plain(*args), 5)
        b_ms, b_by = bound(nb, flops)
        times[key] = ((k1 + k2) / 2, (p1 + p2) / 2, b_ms, b_by)
        log(f"time {key} at {RES}^3: kernel {k1:.4f} / {k2:.4f} ms, plain "
            f"{p1:.4f} / {p2:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
            f"{nb / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP)")
    return errs, times


def check_launches(launches, n, per_step, what):
    """The counters of one path's run: K1 twice a step plus `per_step`,
    nothing else."""
    expect = {"mac_sweep_fwd": n, "mac_sweep_bwd": n}
    expect.update({k: v * n for k, v in per_step.items()})
    log(f"{what}: launches {launches} in {n} steps")
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches} in {n} steps, "
                             f"expected {expect}")


def final_check(state, what):
    from fluidnet_tpu_torch.ops.divergence import velocity_divergence
    for name in ("u", "p", "density"):
        if not torch.isfinite(getattr(state, name)).all():
            raise AssertionError(f"{what}: non-finite {name}")
    div = torch.linalg.norm(velocity_divergence(state.u, state.flags))
    div, umax = div.item(), state.u.abs().max().item()
    log(f"{what}: final ||div||_2 = {div:.6f}, max|U| = {umax:.6f}")
    return div


def kernels_vs_plain_rollout(state, mconf, model, bcs, what):
    """8 steps with the kernels against 8 with the plain versions; fails
    above a relative L2 difference of 1e-4."""
    from fluidnet_tpu_torch.sim.simulate import rollout
    runs = {}
    for use_kernels in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[use_kernels] = rollout(state, mconf, 8, model, bcs,
                                    use_kernels=use_kernels)
        torch.cuda.synchronize()
        log(f"{what}: 8 steps with {'kernels' if use_kernels else 'plain'}"
            f": {(time.perf_counter() - t0) / 8 * 1e3:.3f} ms/step")
    compare_states(runs[True], runs[False], what)


def compare_states(kern, plain, what):
    """Fails above a relative L2 difference of 1e-4 between the states of
    8 steps with the kernels and 8 with the plain versions."""
    for name in ("u", "p", "density"):
        a, b = getattr(kern, name), getattr(plain, name)
        rel = (torch.linalg.norm(a - b) /
               torch.linalg.norm(b).clamp_min(1e-30)).item()
        log(f"{what}: 8 steps kernels vs plain, relative L2 difference of "
            f"{name}: {rel:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"{what}: kernels and plain versions "
                                 f"differ by {rel} in {name} after 8 steps")


def slice_phase(dev, mconf, model):
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.sim.simulate import rollout

    state, bcs = make_plume(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    state = rollout(state, mconf, WARMUP, model, bcs)
    torch.cuda.synchronize()
    rep_s = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        state = rollout(state, mconf, STEPS, model, bcs)
        torch.cuda.synchronize()
        rep_s.append(time.perf_counter() - t0)
    launches = dict(_build.launches)
    check_launches(launches, WARMUP + STEPS * REPS, {"prologue": 1},
                   f"slice ({RES}^3 convnet)")
    steps_per_s = STEPS * REPS / sum(rep_s)
    log(f"slice: per-rep seconds for {STEPS} steps: "
        f"{[round(s, 4) for s in rep_s]}")
    log(f"slice: {steps_per_s:.2f} steps/s ({1e3 / steps_per_s:.3f} ms/step)"
        f", peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    div = final_check(state, "slice")
    kernels_vs_plain_rollout(state, mconf, model, bcs, "slice")
    return launches, steps_per_s, div


def cert_phase(dev, mconf, model):
    """bench.py's residual certification on the port: each projection from
    a fresh t = 0 plume for CERT_STEPS steps."""
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.sim.simulate import rollout

    launches, divs, finals = {}, {}, {}
    for name, (kw, per_step) in CERT.items():
        m = mconf.replace(**kw)
        net = model if m.sim_method == "convnet" else None
        state, bcs = make_plume(dev)
        torch.cuda.synchronize()
        _build.launches.clear()
        t0 = time.perf_counter()
        state = rollout(state, m, CERT_STEPS, net, bcs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = dict(_build.launches)
        check_launches(launches[name], CERT_STEPS, per_step, name)
        log(f"{name}: {CERT_STEPS} steps at {RES}^3 in {secs:.3f} s "
            f"({secs / CERT_STEPS * 1e3:.3f} ms/step)")
        divs[name] = final_check(state, name)
        finals[name] = (state, m, net, bcs)
    if not divs["pcg"] < divs["jacobi34"]:
        raise AssertionError(f"PCG ||div||_2 {divs['pcg']} is not below "
                             f"jacobi-34's {divs['jacobi34']}: a broken "
                             f"solver")
    for name in ("jacobi34", "convnet_p8"):
        kernels_vs_plain_rollout(*finals[name], name)
    return launches, divs


def warp_form(call):
    """The name of a recorded K5 call's form (WARP_FORMS)."""
    fields, px, _, _, _, nearest, minmax = call
    fs = fields if isinstance(fields, tuple) else (fields,)
    key = (px.shape[1], tuple(f.shape[2] for f in fs), bool(nearest), minmax)
    return WARP_FORMS.get(key, str(key))


def record_warp_calls(fn):
    """Runs fn() and returns the arguments of every K5 launch it made."""
    from fluidnet_tpu_torch.ops import warp as warp_mod
    real, calls = warp_mod.warp_group_cuda, []

    def record(fields, px, py, pz, window, nearest=False, minmax=False):
        calls.append((fields, px, py, pz, window, nearest, minmax))
        return real(fields, px, py, pz, window, nearest, minmax)
    warp_mod.warp_group_cuda = record
    try:
        fn()
    finally:
        warp_mod.warp_group_cuda = real
    return calls


def serve_sim(dev, **kw):
    """A DemoSim on the card with the bundled m2d model (the server)."""
    from fluidnet_tpu_torch.cli.serve import DemoSim
    return DemoSim(res=RES2, model=M2D, device=dev, **kw)


def serve_steps(state, mconf, model, bcs, n, consts, use_kernels=True):
    """n steps with the server's step arguments (DemoSim.advance)."""
    from fluidnet_tpu_torch.sim.simulate import simulate
    net = model if mconf.sim_method == "convnet" else None
    for _ in range(n):
        state = simulate(state, mconf, net, bcs, use_kernels=use_kernels,
                         dt=mconf.dt, buoyancy_scale=mconf.buoyancy_scale,
                         vorticity_amp=mconf.vorticity_confinement_amp,
                         consts=consts)
    return state


def random_2d_case(dev, mconf):
    """2x1x1x45x61 with 15% obstacles, Stick and Empty cells, RGB density
    and flow of ~3 cells a step: positions reach past the borders."""
    from fluidnet_tpu_torch.core.grids import FluidState
    rng = np.random.default_rng(21)
    shape = (2, 1, 1, 45, 61)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    state = FluidState(u=t(rng.standard_normal((2, 2, 1, 45, 61)) * 30.0),
                       p=t(np.zeros(shape)),
                       flags=torch.tensor(random_flags(rng, shape),
                                          device=dev),
                       density=t(rng.random((2, 3, 1, 45, 61))))
    return state


def warp_3d_case(dev, shape, W, reach, seed):
    """Random F=1 field and positions up to `reach` cells from the centres,
    (b, 1, ...) groups."""
    rng = np.random.default_rng(seed)
    b, _, Z, Y, X = shape
    field = torch.tensor(rng.standard_normal((b, 1, 1, Z, Y, X)).astype(
        np.float32), device=dev)
    pos = []
    for n, axis in ((X, 4), (Y, 3), (Z, 2)):
        base = np.arange(n).reshape([n if a == axis else 1
                                     for a in range(5)]) + 0.5
        d = rng.uniform(-reach, reach, (b, 1, Z, Y, X))
        pos.append(torch.tensor((base + d).astype(np.float32), device=dev))
    return field, pos


def grid_sample_args(fields, px, py, pz):
    """torch grid_sample's (input, grid) for the same interpolation:
    normalized coordinates 2 p / n - 1 (align_corners=False), border
    padding = BUILD_INDEX's clamp; groups become the batch."""
    fs = fields if isinstance(fields, tuple) else (fields,)
    b, G, _, Z, Y, X = fs[0].shape
    src = torch.cat(fs, dim=2).reshape(b * G, -1, Z, Y, X)
    gx, gy, gz = (2.0 * p / n - 1.0 for p, n in ((px, X), (py, Y), (pz, Z)))
    if Z == 1:
        return src[:, :, 0], torch.stack([gx, gy], -1).reshape(
            b * G, Y, X, 2)
    return src, torch.stack([gx, gy, gz], -1).reshape(b * G, Z, Y, X, 3)


def warp_bound(call):
    """(ms, what bounds it) of one K5 call: positions (2 in 2-D), the
    source channels and the outputs once each; per cell ~5 flops an axis,
    per corner a weight product, a multiply-add per accumulated channel
    and the min/max."""
    fields, px, _, _, _, nearest, minmax = call
    fs = fields if isinstance(fields, tuple) else (fields,)
    b, G, _, Z, Y, X = fs[0].shape
    cells = b * G * Z * Y * X
    F = sum(f.shape[2] for f in fs)
    acc = F - (2 if isinstance(minmax, tuple) else 0)
    axes = 3 if Z > 1 else 2
    Fo = F + (2 if minmax else 0)
    nb = 4 * cells * (axes + F + Fo)
    corners = 1 if nearest else 2 ** axes
    flops = cells * (5 * axes + corners * (1 + 2 * acc +
                                           (2 if minmax else 0)))
    return bound(nb, flops)


def warp_phase(dev):
    """K5 against its plain version on every call the 2-D path makes, and
    its times. Returns (max error, times for the kernels line)."""
    from fluidnet_tpu_torch.cli.demo2d import sphere_force_splat
    from fluidnet_tpu_torch.ops.warp import warp_group, warp_group_plain
    from fluidnet_tpu_torch.sim.simulate import FlagConsts

    sim = serve_sim(dev)
    state, bcs, consts = sim.state, sim.bcs, sim.consts
    state = serve_steps(state, sim.mconf, sim.model, bcs, 10, consts)
    state = sphere_force_splat(state, (60.0, 64.0), (20.0, 30.0), 12.8)
    state = serve_steps(state, sim.mconf, sim.model, bcs, 2, consts)
    cases = ((f"plume 1x1x1x{RES2}^2", state, sim.mconf, sim.model, bcs),
             ("random 2x1x1x45x61", random_2d_case(dev, sim.mconf),
              sim.mconf, sim.model, None))
    worst, timed = 0.0, {}
    for name, st, mconf, model, case_bcs in cases:
        log(f"K5 vs plain on {name}:")
        for method in SERVE_K5_PER_STEP:
            for W in (1, 2):
                m = mconf.replace(advection_method=method,
                                  adaptive_window=False, advection_window=W)
                calls = record_warp_calls(lambda: serve_steps(
                    st, m, model, case_bcs, 1, FlagConsts()))
                if len(calls) != SERVE_K5_PER_STEP[method]:
                    raise AssertionError(f"{method}: {len(calls)} K5 calls "
                                         f"in a step")
                errs, same = [], True
                for call in calls:
                    what = f"K5 {method} W={W} {warp_form(call)}"
                    ref = warp_group_plain(*call)
                    out = warp_group(*call)
                    torch.cuda.synchronize()
                    errs.append(max_err(out.flatten(1, 2), ref.flatten(1, 2),
                                        what, quiet=True))
                    same = same and torch.equal(out, ref)
                    if name.startswith("plume") and method == \
                            "maccormackOurs" and W == 1:
                        timed.setdefault(warp_form(call), call)
                forms = sorted({warp_form(c) for c in calls})
                log(f"  {method} W={W}: {len(calls)} calls ({', '.join(forms)})"
                    f", max abs err {max(errs):.3e}"
                    f"{'; bit-identical' if same else ''}")
                worst = max([worst] + errs)
    log("K5 vs plain on 3-D 1x37x45x61, W=1:")
    for nearest, minmax in ((False, True), (True, False)):
        field, (px, py, pz) = warp_3d_case(dev, (1, 1, 37, 45, 61), 1, 2.0,
                                           23)
        if nearest:
            px, py, pz = (torch.floor(p) + 0.5 for p in (px, py, pz))
        call = (field, px, py, pz, 1, nearest, minmax)
        ref, out = warp_group_plain(*call), warp_group(*call)
        torch.cuda.synchronize()
        worst = max(worst, max_err(out.flatten(1, 2), ref.flatten(1, 2),
                                   f"K5 3-D nearest={nearest} "
                                   f"minmax={minmax}"))

    # Times, in turns: plain, kernel, kernel, plain, each call issued from
    # Python (CUDA events over n calls); then the kernel and grid_sample
    # (the interpolation alone) replayed from CUDA graphs: their device
    # times. The serve's forms (a) and (c) at 128^2, then the G=1 F=1
    # min/max form at 128^3.
    field, pos = warp_3d_case(dev, (1, 1, RES, RES, RES), 1, 0.999, 24)
    runs = [(f"{RES2}^2 {form}", timed[form])
            for form in ("five_sources", "group_minmax")]
    runs.append((f"{RES}^3 G=1 F=1 minmax", (field, *pos, 1, False, True)))
    times = {}
    for what, call in runs:
        fields, px, py, pz, W, nearest, minmax = call
        fs = fields if isinstance(fields, tuple) else (fields,)
        acc = tuple(f for i, f in enumerate(fs)
                    if not (isinstance(minmax, tuple) and i in minmax))
        inp, grid = grid_sample_args(acc if len(acc) > 1 else acc[0], px,
                                     py, pz)
        n = 200 if "^2" in what else 20
        p1 = cuda_ms(lambda: warp_group_plain(*call), max(n // 10, 2))
        k1 = cuda_ms(lambda: warp_group(*call), n)
        k2 = cuda_ms(lambda: warp_group(*call), n)
        p2 = cuda_ms(lambda: warp_group_plain(*call), max(n // 10, 2))
        kg = graph_ms(lambda: warp_group(*call), 50)
        lib = graph_ms(lambda: torch.nn.functional.grid_sample(
            inp, grid, mode="bilinear", padding_mode="border",
            align_corners=False), 50)
        b_ms, b_by = warp_bound(call)
        times[what] = (kg, (p1 + p2) / 2, b_ms, b_by, lib)
        log(f"time K5 {what}: issued from Python, kernel {k1:.4f} / "
            f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; from a CUDA graph, "
            f"kernel {kg:.5f} ms, grid_sample {lib:.5f} ms; bound "
            f"{b_ms:.5f} ms ({b_by})")
    return worst, times


def check_counts(launches, n, per_step, what):
    """The counters of one 2-D path's run: exactly per_step x n."""
    expect = {k: v * n for k, v in per_step.items() if v}
    log(f"{what}: launches {launches} in {n} steps")
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches} in {n} steps, "
                             f"expected {expect}")


def png_size(data):
    """(width, height) of an 8-bit RGB PNG, its chunks' CRCs and its pixel
    data checked with zlib."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, size, idat = 8, None, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        if zlib.crc32(tag + body) & 0xffffffff != crc:
            raise AssertionError(f"PNG chunk {tag} fails its CRC")
        if tag == b"IHDR":
            size = (int.from_bytes(body[:4], "big"),
                    int.from_bytes(body[4:8], "big"))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise AssertionError("PNG pixel data has the wrong length")
    return size


def serve_phase(dev):
    """The demo server on the card: its loop thread and HTTP endpoints,
    then the toggles with each step's launches counted. Returns the
    launches of the counted runs."""
    from http.server import ThreadingHTTPServer
    from fluidnet_tpu_torch.cli.serve import make_handler
    from fluidnet_tpu_torch.ops.cuda import _build

    sim = serve_sim(dev, target_fps=1e6)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(sim))
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    threads = [threading.Thread(target=srv.serve_forever, daemon=True),
               threading.Thread(target=sim.loop, daemon=True)]
    for t in threads:
        t.start()

    def get(path):
        return urllib.request.urlopen(base + path, timeout=60).read()

    def post(path):
        req = urllib.request.Request(base + path, method="POST")
        try:
            return urllib.request.urlopen(req, timeout=60).status
        except urllib.error.HTTPError as e:
            return e.code

    total = {}
    try:
        if b"fluidnet_tpu_torch" not in get("/"):
            raise AssertionError("GET / does not serve the page")
        time.sleep(1.0)
        if png_size(get("/frame.png")) != (RES2, RES2):
            raise AssertionError("GET /frame.png is not a 128x128 PNG")
        s1 = json.loads(get("/stats"))
        if post("/splat?x=0.5&y=0.3&fx=0.02&fy=-0.01") != 200 or \
                post("/toggle?k=vorticity&v=cycle") != 200 or \
                post("/toggle?k=vorticity&v=0") != 200:
            raise AssertionError("POST /splat or /toggle refused")
        if post("/toggle?k=bogus&v=1") != 400 or \
                post("/toggle?k=dt&v=fast") != 400:
            raise AssertionError("a bad toggle was not refused with 400")
        time.sleep(1.0)
        s2 = json.loads(get("/stats"))
        log(f"serve: /stats {s1} -> {s2}")
        if not (s2["frame"] > s1["frame"] and s2["fps"] > 0):
            raise AssertionError("serve: the frame count does not advance")
    finally:
        sim.running = False
        threads[1].join()

    # The toggles, stepped on this thread, each step's launches counted
    # and its advection window read from its first K5 call.
    windows = {}
    runs = [("calm plume", [], 20, {"warp": 8}),
            ("strong splat", ["/splat?x=0.5&y=0.4&fx=0.5&fy=-0.3"], 6,
             {"warp": 8}),
            ("sim_method=jacobi", ["/toggle?k=sim_method&v=jacobi"], 10,
             {"warp": 8, "jacobi": 1}),
            ("convnet, advection=maccormack",
             ["/toggle?k=sim_method&v=convnet",
              "/toggle?k=advection&v=maccormack"], 10, {"warp": 20}),
            ("advection=euler", ["/toggle?k=advection&v=euler"], 10,
             {"warp": 4}),
            ("advection=maccormackOurs",
             ["/toggle?k=advection&v=maccormackOurs"], 10, {"warp": 8})]
    try:
        for what, posts, n, per_step in runs:
            for path in posts:
                if post(path) != 200:
                    raise AssertionError(f"POST {path} refused")
            torch.cuda.synchronize()
            _build.launches.clear()
            for _ in range(n):
                W = record_warp_calls(sim.advance)[0][4]
                windows[W] = windows.get(W, 0) + 1
            torch.cuda.synchronize()
            launches = dict(_build.launches)
            check_counts(launches, n, per_step, f"serve {what}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            if not torch.isfinite(sim.state.u).all():
                raise AssertionError(f"serve {what}: non-finite velocity")
    finally:
        srv.shutdown()
        srv.server_close()
    log(f"serve: steps by advection window {windows}")
    if not (windows.get(1) and windows.get(2)):
        raise AssertionError(f"serve: both adaptive windows must be taken, "
                             f"got {windows}")
    return total, windows


def serve_cert_phase(dev):
    """The server's step unthrottled on a fresh 128^2 plume: its time, then
    150 steps of each projection, and kernels against plain versions."""
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.sim.simulate import FlagConsts

    sim = serve_sim(dev)
    mconf, model = sim.mconf, sim.model
    total = {}

    def counted(fn, per_step, n, what):
        torch.cuda.synchronize()
        _build.launches.clear()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        check_counts(launches, n, per_step, what)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out

    state, bcs, consts = sim.state, sim.bcs, sim.consts
    torch.cuda.reset_peak_memory_stats()
    state = counted(lambda: serve_steps(state, mconf, model, bcs, WARMUP,
                                        consts), {"warp": 8}, WARMUP,
                    "2-D serve warm-up")
    rep_s = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = serve_steps(state, mconf, model, bcs, STEPS, consts)
        torch.cuda.synchronize()
        rep_s.append(time.perf_counter() - t0)
    steps_per_s = STEPS * REPS / sum(rep_s)
    log(f"2-D serve: per-rep seconds for {STEPS} steps: "
        f"{[round(x, 4) for x in rep_s]}")
    log(f"2-D serve: {steps_per_s:.2f} steps/s ({1e3 / steps_per_s:.3f} "
        f"ms/step), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    projections = {"convnet": (dict(sim_method="convnet"), {"warp": 8}),
                   "jacobi34": (dict(sim_method="jacobi", max_iter=34),
                                {"warp": 8, "jacobi": 1}),
                   "pcg": (dict(sim_method="pcg", max_iter=100,
                                pcg_tol=1e-4), {"warp": 8})}
    divs, finals = {}, {}
    for name, (kw, per_step) in projections.items():
        m = mconf.replace(**kw)
        fresh = serve_sim(dev)
        consts = FlagConsts()
        t0 = time.perf_counter()
        st = counted(lambda: serve_steps(fresh.state, m, model, fresh.bcs,
                                         CERT_STEPS, consts),
                     per_step, CERT_STEPS, f"2-D {name}")
        secs = time.perf_counter() - t0
        log(f"2-D {name}: {CERT_STEPS} steps at {RES2}^2 in {secs:.3f} s "
            f"({secs / CERT_STEPS * 1e3:.3f} ms/step)")
        divs[name] = final_check(st, f"2-D {name}")
        finals[name] = (st, m, fresh.bcs)
    if not divs["pcg"] < divs["jacobi34"]:
        raise AssertionError(f"2-D PCG ||div||_2 {divs['pcg']} is not below "
                             f"jacobi-34's {divs['jacobi34']}")
    for name in ("convnet", "jacobi34"):
        st, m, b = finals[name]
        runs = {}
        for use_kernels in (True, False):
            runs[use_kernels] = serve_steps(st, m, model, b, 8, FlagConsts(),
                                            use_kernels)
        compare_states(runs[True], runs[False], f"2-D {name}")
    return total, steps_per_s, divs


def main():
    smi = device_phase()
    dev = torch.device("cuda", 0)

    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.utils.checkpoint import load_mconf, load_params

    secs, ptxas = _build.build(force=True)
    _build.library()
    log(f"build: nvcc {_build.ARCH}, {secs:.2f} s -> "
        f"{os.path.relpath(_build.LIB_PATH)}")
    for line in ptxas.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.split('ptxas info    : ')[-1]}")

    mconf = load_mconf(BUNDLED).replace(**BENCH_KNOBS)
    model = FluidNet(mconf, device=dev).load_jax_params(load_params(BUNDLED))
    log(f"model: {os.path.relpath(BUNDLED)} ({mconf.model_type}, "
        f"{mconf.conv_compute_dtype} trunk)")

    errs, times = kernels_phase(dev, mconf, model)
    errs["warp"], warp_times = warp_phase(dev)
    times["warp"] = warp_times[f"{RES2}^2 five_sources"]
    launches, steps_per_s, div_cnn = slice_phase(dev, mconf, model)
    cert_launches, divs = cert_phase(dev, mconf, model)
    serve_launches, windows = serve_phase(dev)
    cert2_launches, steps2_per_s, divs2 = serve_cert_phase(dev)

    total = dict(launches)
    for per in list(cert_launches.values()) + [serve_launches,
                                               cert2_launches]:
        for key, n in per.items():
            total[key] = total.get(key, 0) + n
    for key in KERNELS:
        if not total.get(key):
            raise AssertionError(f"kernel {key} was not launched on any "
                                 f"driven path")
    kernels = [{"name": key, "route": "cuda", "source": src,
                "replaces": rep, "launches": total[key],
                "max_abs_err": errs[key], "ms": times[key][0],
                "plain_ms": times[key][1], "bound_ms": times[key][2],
                "bound_by": times[key][3],
                "library_ms": times[key][4] if len(times[key]) > 4 else None}
               for key, (src, rep) in KERNELS.items()]
    log(json.dumps({"steps_per_s": steps_per_s, "res": RES}))
    log(json.dumps({"serve_2d_steps_per_s": steps2_per_s, "res": RES2,
                    "serve_windows": windows,
                    "final_div_l2_2d": divs2,
                    "warp_times_ms": {k: {"ms": v[0], "plain_ms": v[1],
                                          "bound_ms": v[2],
                                          "library_ms": v[4]}
                                      for k, v in warp_times.items()}}))
    log(json.dumps({"final_div_l2_convnet": div_cnn,
                    "final_div_l2_jacobi34": divs["jacobi34"],
                    "final_div_l2_pcg": divs["pcg"],
                    "final_div_l2_convnet_p8": divs["convnet_p8"],
                    "residual_ok": bool(div_cnn <= divs["jacobi34"]),
                    "steps": CERT_STEPS}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
