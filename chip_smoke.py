#!/usr/bin/env python3
"""Smoke test of the PyTorch port (fluidnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card: the 3-D 128^3 plume that bench.py
times for the JAX package (the ConvNet rollout and the jacobi-34 / PCG /
ConvNet + Jacobi-polish certification rollouts), the 2-D interactive
demo server (cli/serve.py with the bundled m2d ConvNet at 128^2), 3-D
training (the m3d_v5 recipe), the offline 3-D entry points (cli/sim3d.py
around a voxelized obstacle, the exact advection route, cli/stats.py) and
the dyngather probe, in these phases:

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
             and PCG's ||div||_2 below jacobi-34's; two 16-step PCG
             rollouts from one fresh plume must be equal to the bit. Then
             8 jacobi-34 and 8 ConvNet + p8 steps with the kernels against
             8 of each with the plain versions, from the certification
             states.
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
  9. training kernels vs plain: K1's unfused forms (both sweeps, with and
             without the scalar and its renormalisation, ours or not), K6
             (the sweep's own positions for u and the scalar, positions past
             the window, nearest, W 1 and 2, a 2-D case) and K4 on random
             6x64^3 (the training shape) and 1x128^3 grids with 15%
             obstacles; fails above a max abs error of 1e-6. Times each at
             both shapes, K6 beside grid_sample's input-gradient backward
             (timed, never used).
 10. data:   the port's generate_dataset with gen3d_v5's settings at 64^3,
             cut to 6 train and 2 test scenes of 16 frames (12 samples),
             into build/smoke_train/; seconds and max PCG residual.
 11. train cli: cli/train.main with train3d_v5.sh's flags (the m3d_v5
             recipe, batch 6) for 2 epochs with the horizon curriculum
             [[0,2,4],[1,4,8]] and an 8-step rollout selection, then a
             resume from '_lastEpoch' for a third: finite losses, the TSV
             log, '_lastEpoch', '_bestRollout' and '_ema' written.
 12. train steps: train_step at n = 4 and n = 16 on a generated batch:
             ms per step, peak memory, loss, grad_norm, rejected, and each
             step's launches against train_launches(n); one step with
             augment_without_targets launches K4 once.
 13. train grads: one loss_fn at n = 4 with the kernels against one with
             every plain version (deterministic cuDNN): the loss and every
             parameter's gradient within 1e-4 relative L2.
 14. probe:  K7 (the dyngather probe's take_along_axis): scripts/
             torch_dyngather.py's both forms counted (run after phase 4);
             each form at 128x128 and 37x61 against its plain version and
             np.take_along_axis, max abs error 0; times at 128x128 from
             CUDA graphs beside torch.gather (timed, never used).
 15. stats:  cli.stats.compute on phase 10's 64^3 test split (run before
             it is removed): the bundled ConvNet, jacobi-34 and PCG, 64
             steps from every test sample; TSVs written and finite, PCG's
             last-step mean ||div||_2 below jacobi-34's.
 16. sim3d:  a closed OBJ (a box and a UV sphere) written to
             build/smoke_sim3d/, voxelized at 64^3 by the port's
             io.voxelize and saved as .binvox; cli.sim3d.build_scene's
             128^3 plume around it with the bundled ConvNet and sim3d's
             knobs. 768 frames with the ConvNet and with jacobi-34,
             nothing exported: ms/frame, ||div||_2 and finiteness every 16
             steps, K1 twice and K2's prologue once a ConvNet step (K1
             twice, the forces block and K3 once a jacobi step); 8 steps
             kernels vs plain from the ConvNet state after 64 frames; then
             cli.sim3d.main with --num_frames 25 --decimation 3, whose
             .vbox files read back hold 8 finite density frames and the
             scene's obstacle cells.
 17. exact:  advection_window 0 on the same scene: 16 ConvNet frames,
             finite, K1 not launched, ms/frame and peak memory; one exact
             advect_scalar and advect_vel (maccormackOurs) at 64^3 on the
             card against the CPU, relative L2 at most 1e-4, with the rays
             of their line traces whose decisions or positions differ
             (each trace run again on both devices from the CPU's inputs)
             and whose square root differs from the correctly rounded one.

The last three lines are the card's name and power limit, a JSON object
with one entry per kernel, and {"ok": true, "device": {...}}. Any failure
raises: the exit code is then not 0 and no result line is printed.
Outputs under build/ are removed at the end.
"""


import json
import os
import shutil
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
# The generated dataset and the CLI's models (removed at the end).
TRAIN_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke_train")
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
    "mac_sweep_unfused_fwd": ("fluidnet_tpu_torch/csrc/mac_sweep.cu",
                              "fluidnet_tpu/ops/pallas/mac_sweep.py:57"),
    "mac_sweep_unfused_bwd": ("fluidnet_tpu_torch/csrc/mac_sweep.cu",
                              "fluidnet_tpu/ops/pallas/mac_sweep.py:57"),
    "warp_transpose": ("fluidnet_tpu_torch/csrc/warp_transpose.cu",
                       "fluidnet_tpu/ops/pallas/warp.py:364"),
    "vorticity": ("fluidnet_tpu_torch/csrc/prologue.cu",
                  "fluidnet_tpu/ops/pallas/forces_kernel.py:33"),
    "dyngather": ("fluidnet_tpu_torch/csrc/dyngather.cu",
                  "scripts/test_dyngather.py:11"),
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
                  "prologue": 81, "forces_block": 76,
                  "mac_sweep_unfused_fwd": 370, "mac_sweep_unfused_bwd": 354,
                  "vorticity": 70}
JACOBI_FLOPS_3D = 7
# K6 per cell and field group: 3 axes' corner and weights (9) and, for each
# of the 8 (source, target) pairs a trilinear source reaches, 3 weight
# products and 4 for the term and its sum.
WARP_T_FLOPS = 9 + 8 * 7
# The offline 3-D slice: sim3d around a voxelized obstacle (removed at the
# end), the exact advection route, the stats CLI, the dyngather probe.
SIM3D_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "smoke_sim3d")
SIM3D_FRAMES = 768              # cli/sim3d.py's default --num_frames
DIV_EVERY = 16                  # ||div||_2 and finiteness read every 16 steps
VOX_DIM = 64                    # the obstacle's voxelization
EXACT_FRAMES, EXACT_RES = 16, 64
PCG_REPEAT_STEPS = 16           # two PCG rollouts that must agree to the bit
STATS_STEPS = 64
PROBE_SHAPES = ((128, 128), (37, 61))
TRAIN_RES, TRAIN_B = 64, 6      # gen3d_v5's grid, train3d_v5.sh's batch
TRAIN_REPS = 3                  # timed train steps per horizon
EXACT = 1e-6                    # the new kernels vs plain: max abs error
GRAD_TOL = 1e-4                 # train grads, kernels vs plain: rel. L2
# The flags of scripts/train3d_v5.sh (the m3d_v5 recipe), batch 6.
RECIPE = ["-batch_size", "6", "-seed", "17", "-profile", "false",
          "-rollout_select_steps", "8", "-ema_decay", "0.999",
          "-horizon_schedule", "[[0,2,4],[1,4,8]]",
          "-lr_epoch_mults", "[[16,0.5],[24,0.5],[30,0.5]]",
          "-new_model.is_3d", "true",
          "-new_model.advection_method", "maccormackOurs",
          "-new_model.adaptive_window", "false",
          "-new_model.advection_window", "1",
          "-new_model.maccormack_strength", "0.75",
          "-new_model.augment_without_targets", "false",
          "-new_model.train_buoyancy_prob", "0.5",
          "-new_model.train_buoyancy_scale", "2.0",
          "-new_model.train_vorticity_confinement_prob", "0.3",
          "-new_model.train_vorticity_confinement_amp", "3.0",
          "-new_model.long_term_div_lambda", "1.0",
          "-new_model.long_term_grad_mode", "full",
          "-new_model.loss_div_lambda", "1.0",
          "-new_model.loss_reject_threshold", "0.1",
          "-new_model.optim.learning_rate", "0.0005"]


def train_launches(n):
    """Kernel launches of one 'full'-mode train_step at unroll horizon n:
    K1 fused n forward + n - 1 recomputed per direction; K1 unfused and K6
    (two per sweep) for the n - 1 steps whose input depends on the
    parameters (the first step's does not, and autograd skips its
    adjoint); K2's prologue 2(n - 1); its forces block once (the last,
    output_div, step)."""
    return {"mac_sweep_fwd": 2 * n - 1, "mac_sweep_bwd": 2 * n - 1,
            "mac_sweep_unfused_fwd": n - 1, "mac_sweep_unfused_bwd": n - 1,
            "warp_transpose": 4 * (n - 1), "prologue": 2 * (n - 1),
            "forces_block": 1}


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
    log(f"final_div_l2_pcg {divs['pcg']:.6f}")
    # PCG repeats to the bit: two rollouts from the same fresh plume.
    m = mconf.replace(**CERT["pcg"][0])
    runs = []
    for _ in range(2):
        state, bcs = make_plume(dev)
        runs.append(rollout(state, m, PCG_REPEAT_STEPS, None, bcs))
    same = {f: torch.equal(getattr(runs[0], f), getattr(runs[1], f))
            for f in ("u", "p", "density")}
    log(f"pcg: two {PCG_REPEAT_STEPS}-step rollouts at {RES}^3 equal to "
        f"the bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"PCG rollouts differ between two runs: {same}")
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


# --- the training slice -----------------------------------------------------


def max_abs(out, ref, what):
    """Max abs error of a kernel's output against its plain version, equal
    values (the +-1e30 'no fluid corner' sentinels included) counting 0;
    raises above EXACT."""
    err = torch.where(out == ref, 0.0, (out - ref).abs()).max().item()
    log(f"  {what}: max abs err {err:.3e}"
        f"{'; bit-identical' if torch.equal(out, ref) else ''}")
    if not err <= EXACT:
        raise AssertionError(f"{what}: kernel vs plain max abs err {err} > "
                             f"{EXACT}")
    return err


def train_case(dev, b, res, seed):
    """b x res^3 with 15% obstacles, Stick and Empty cells, a random
    density and flow of up to ~1.5 cells a step at dt 0.1 (past the
    W = 1 window)."""
    from fluidnet_tpu_torch.core.celltype import is_fluid
    from fluidnet_tpu_torch.ops.advect_fast import chebyshev_free_space
    rng = np.random.default_rng(seed)
    shape = (b, 1, res, res, res)
    flags = torch.tensor(random_flags(rng, shape), device=dev)
    return {"flags": flags,
            "u": torch.tensor((rng.standard_normal((b, 3) + shape[2:]) * 5.0)
                              .astype(np.float32), device=dev),
            "s": torch.tensor(rng.random(shape).astype(np.float32),
                              device=dev),
            "m": is_fluid(flags).to(torch.float32),
            "free": chebyshev_free_space(flags, 2)}


def grid_sample_backward(g, px, py, pz):
    """One PyTorch call for K6's function: grid_sample's input gradient
    (trilinear, border padding, align_corners=False) at the same positions,
    the groups as the batch. Returns a closure."""
    b, G, F, Z, Y, X = g.shape
    grid = torch.stack([2.0 * p / n - 1.0 for p, n in
                        ((px, X), (py, Y), (pz, Z))], -1).reshape(
        b * G, Z, Y, X, 3)
    go = g.reshape(b * G, F, Z, Y, X)
    inp = torch.zeros_like(go)       # its values do not enter the gradient
    return lambda: torch.ops.aten.grid_sampler_3d_backward(
        go, inp, grid, 0, 1, False, [True, False])


def train_kernels_phase(dev):
    """K1's unfused forms, K6 and K4 against their plain versions at the
    training shapes (6 x 64^3) and K6's other forms (nearest, W = 2,
    positions past the window, 2-D); then each timed at 6 x 64^3 and at
    1 x 128^3 in turns (plain, kernel, kernel, plain) against its bound
    and, for K6, grid_sample's backward. Returns (errors, times at the
    training shape)."""
    from fluidnet_tpu_torch.ops.cuda import mac_sweep
    from fluidnet_tpu_torch.ops.cuda.forces_kernel import vorticity_cuda
    from fluidnet_tpu_torch.ops.cuda.warp_transpose import (
        warp_transpose_cuda, warp_transpose_plain)
    from fluidnet_tpu_torch.ops.forces import vorticity_confinement_xla

    dt, amp = 0.1, 3.0 / TRAIN_RES
    errs = {"mac_sweep_unfused_fwd": 0.0, "mac_sweep_unfused_bwd": 0.0,
            "warp_transpose": 0.0, "vorticity": 0.0}
    times = {}
    for b, res in ((TRAIN_B, TRAIN_RES), (1, RES)):
        c = train_case(dev, b, res, 31 + b)
        at = f"{b}x{res}^3"
        log(f"training kernels vs plain on {at} (15% obstacles):")
        calls = {}
        fwd_s = None
        for is_bwd, ours, with_scalar, renorm in (
                (False, True, True, True), (True, True, True, True),
                (False, False, True, False), (True, False, True, False),
                (False, True, False, False), (True, False, False, False)):
            fwd = None
            if is_bwd:
                fwd = mac_sweep.sweep_plain(c["u"], c["s"], c["m"], None,
                                            None, c["free"], -dt, 1, ours,
                                            True, renorm)
                fwd_s = fwd[:, 9:10].contiguous() if with_scalar else None
                fwd = fwd[:, 0:3].contiguous()
            args = (c["u"], None if is_bwd else c["s"],
                    c["m"] if with_scalar else None, fwd, fwd_s,
                    c["free"] if ours else None, dt if is_bwd else -dt, 1,
                    ours, with_scalar, renorm)
            key = "mac_sweep_unfused_" + ("bwd" if is_bwd else "fwd")
            ref = mac_sweep.sweep_plain(*args)
            out = mac_sweep.sweep_cuda(*args)
            torch.cuda.synchronize()
            errs[key] = max(errs[key], max_abs(
                out, ref, f"K1 unfused {'bwd' if is_bwd else 'fwd'} ours="
                f"{ours} scalar={with_scalar} renorm={renorm} "
                f"({ref.shape[1]} channels)"))
            if ours and with_scalar and renorm:
                calls[key] = (mac_sweep.sweep_plain, mac_sweep.sweep_cuda,
                              args, nbytes(*args[:6], ref),
                              FLOPS_PER_CELL[key] * c["m"].numel(), None)
        # K6 at the sweep's own positions (u: G = 3, the scalar: G = 2),
        # then nearest, W = 2 and positions past the window.
        px, py, pz = mac_sweep.positions_for_vjp(c["u"], c["free"], -dt, 1,
                                                 True)
        rng = torch.Generator(device=dev).manual_seed(5)
        g = torch.randn((b, 3, 1, res, res, res), device=dev, generator=rng)
        cases = [("G=3 F=1 W=1 (u)", g, (px, py, pz), 1, False)]
        cpx, cpy, cpz = mac_sweep.positions_for_vjp(
            c["u"], c["free"], -dt, 1, True, center=True, m=c["m"])
        cases.append(("G=2 F=1 W=1 (scalar)", g[:, :2].contiguous(),
                      tuple(p.repeat(1, 2, 1, 1, 1) for p in (cpx, cpy, cpz)),
                      1, False))
        far = tuple((p + torch.randn(p.shape, device=dev, generator=rng) *
                     1.5).contiguous() for p in (px, py, pz))
        for W in (1, 2):
            cases.append((f"G=3 W={W} past the window", g, far, W, False))
            cases.append((f"G=3 W={W} nearest", g,
                          tuple(torch.floor(p) + 0.5 for p in far), W, True))
        if b == TRAIN_B:
            g2 = torch.randn((b, 2, 2, 1, 128, 128), device=dev,
                             generator=rng)
            p2 = tuple((torch.rand((b, 2, 1, 128, 128), device=dev,
                                   generator=rng) * 4 - 2 + base).contiguous()
                       for base in (torch.arange(128, device=dev) + 0.5,
                                    (torch.arange(128, device=dev) + 0.5)
                                    [:, None], torch.full((1,), 0.5,
                                                          device=dev)))
            cases.append(("2-D G=2 F=2 W=1 past the window", g2, p2, 1,
                          False))
        for what, gg, pos, W, nearest in cases:
            ref = warp_transpose_plain(gg, *pos, W, nearest)
            out = warp_transpose_cuda(gg, *pos, W, nearest)
            torch.cuda.synchronize()
            errs["warp_transpose"] = max(errs["warp_transpose"], max_abs(
                out, ref, f"K6 {what}"))
        calls["warp_transpose"] = (
            warp_transpose_plain, warp_transpose_cuda,
            (g, px, py, pz, 1, False), nbytes(g, px, py, pz, g),
            WARP_T_FLOPS * g.numel(), grid_sample_backward(g, px, py, pz))
        va = (c["u"], c["flags"], amp)
        errs["vorticity"] = max(errs["vorticity"], max_abs(
            vorticity_cuda(*va), vorticity_confinement_xla(*va),
            "K4 vorticity confinement"))
        calls["vorticity"] = (vorticity_confinement_xla, vorticity_cuda, va,
                              nbytes(c["u"], c["flags"], c["u"]),
                              FLOPS_PER_CELL["vorticity"] * c["m"].numel(),
                              None)
        for key, (plain, kern, args, nb, flops, lib) in calls.items():
            p1 = cuda_ms(lambda: plain(*args), 3)
            k1 = cuda_ms(lambda: kern(*args), 20)
            k2 = cuda_ms(lambda: kern(*args), 20)
            p2 = cuda_ms(lambda: plain(*args), 3)
            lib_ms = cuda_ms(lib, 20) if lib is not None else None
            b_ms, b_by = bound(nb, flops)
            if b == TRAIN_B:
                times[key] = ((k1 + k2) / 2, (p1 + p2) / 2, b_ms, b_by,
                              lib_ms)
            log(f"time {key} at {at}: kernel {k1:.4f} / {k2:.4f} ms, plain "
                f"{p1:.4f} / {p2:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
                f"{nb / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP)"
                + (f"; grid_sample backward {lib_ms:.4f} ms"
                   if lib_ms is not None else ""))
    return errs, times


def data_phase(dev, root):
    """The port's generate_dataset at 64^3 with gen3d_v5's settings
    (per-scene forces and plumes, PCG 300 iterations, every 8th frame,
    6 scenes a batch), cut to 6 train and 2 test scenes of 16 frames."""
    from fluidnet_tpu_torch.data.generate import generate_dataset
    res = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_dataset(os.path.join(root, "gen3d"), n_tr=6, n_te=2, seed=29,
                     scenes_per_batch=TRAIN_B,
                     size_xyz=(TRAIN_RES,) * 3, is_3d=True, n_frames=16,
                     save_every=8, max_iter=300, device=dev, residuals=res)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"data: 8 scenes x 16 frames at {TRAIN_RES}^3 in {secs:.3f} s, max "
        f"PCG residual {max(res):.3e}")
    if not np.isfinite(res).all():
        raise AssertionError(f"data: non-finite PCG residual {res}")
    return secs, max(res)


def cli_phase(root):
    """cli/train.main with train3d_v5.sh's flags for 2 epochs, then a resume
    from '_lastEpoch' for a third. Returns the launches of both runs."""
    from fluidnet_tpu_torch.cli.train import main as train_main
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.utils.logger import read_log

    models = os.path.join(root, "models")
    flags = RECIPE + ["-data_dir", root, "-dataset", "gen3d",
                      "-model_dir", models, "-model_filename", "m3d"]
    launches = {}
    for epochs, resume in ((2, "false"), (3, "true")):
        torch.cuda.synchronize()
        _build.launches.clear()
        t0 = time.perf_counter()
        state, _ = train_main(flags + ["-max_epochs", str(epochs),
                                       "-load_model", resume,
                                       "-resume_training", resume])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k, v in _build.launches.items():
            launches[k] = launches.get(k, 0) + v
        _, rows = read_log(os.path.join(models, "m3d_log.tsv"))
        log(f"train cli: {'resumed to ' if resume == 'true' else ''}"
            f"{epochs} epochs in {secs:.3f} s, {state.step} steps, "
            f"launches {dict(_build.launches)}")
        log(f"train cli: log rows (epoch, tr_loss, .., te_loss, ..) "
            f"{rows}")
        if len(rows) != epochs or [r[0] for r in rows] != \
                list(range(epochs)) or not np.isfinite(rows).all():
            raise AssertionError(f"train cli: log rows {rows}")
    for d in ("m3d_lastEpoch", "m3d_bestRollout", "m3d_ema"):
        if not os.path.isfile(os.path.join(models, d, "mconf.json")):
            raise AssertionError(f"train cli: {d} was not written")
    return launches


def train_batch(dev, root):
    """The first 6-sample batch of the generated training set, on the
    device."""
    from fluidnet_tpu_torch.data.dataset import DeviceDataset, FluidDataset
    ds = FluidDataset(root, "gen3d", "tr")
    loader = DeviceDataset(ds, TRAIN_B, dev,
                           keys=("p_div", "u_div", "flags", "density"),
                           shuffle=False)
    return loader.batch(next(loader.epoch_indices()))


def recipe_mconf():
    from fluidnet_tpu_torch.core.config import default_conf, parse_args
    return parse_args(default_conf(), RECIPE).new_model


def train_steps_phase(dev, batch):
    """train_step at n = 4 and n = 16 from a fresh model on one batch:
    ms per step over TRAIN_REPS single steps, peak memory, the loss
    terms and each step's launches against train_launches(n); then one
    step with augment_without_targets (K4 once more)."""
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.train.train import init_train_state, train_step
    mconf = recipe_mconf()
    launches, per_n = {}, {}

    def step(state, m, n):
        torch.cuda.synchronize()
        _build.launches.clear()
        t0 = time.perf_counter()
        state, terms = train_step(state, batch,
                                  torch.Generator().manual_seed(state.step),
                                  m, n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = dict(_build.launches)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return state, terms, ms, got

    for n in (4, 16):
        state = init_train_state(17, mconf, dev)
        state = step(state, mconf, n)[0]          # warm-up
        torch.cuda.reset_peak_memory_stats()
        reps = []
        for _ in range(TRAIN_REPS):
            state, terms, ms, got = step(state, mconf, n)
            reps.append(ms)
            if got != train_launches(n):
                raise AssertionError(f"train step n={n}: launches {got}, "
                                     f"expected {train_launches(n)}")
            vals = {k: float(v) for k, v in terms.items()}
            if not all(np.isfinite(list(vals.values()))):
                raise AssertionError(f"train step n={n}: terms {vals}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_n[n] = (sorted(reps)[len(reps) // 2], reps, peak)
        log(f"train step n={n} at {TRAIN_B}x{TRAIN_RES}^3: median "
            f"{per_n[n][0]:.3f} ms/step, reps {[round(r, 3) for r in reps]}"
            f" ms; peak memory {peak:.3f} GiB; last step loss "
            f"{vals['total']:.6e}, grad_norm {vals['grad_norm']:.6e}, "
            f"rejected {vals['rejected']:.0f}; launches/step {got}")
    aug = mconf.replace(augment_without_targets=True)
    state, terms, ms, got = step(init_train_state(17, aug, dev), aug, 4)
    want = dict(train_launches(4), vorticity=1)
    log(f"train step n=4 with augment_without_targets: {ms:.3f} ms, "
        f"launches {got}")
    if got != want:
        raise AssertionError(f"augmented train step: launches {got}, "
                             f"expected {want}")
    return launches, per_n


def train_grad_phase(dev, batch):
    """One loss_fn at n = 4 with the kernels against one with every plain
    version (deterministic cuDNN, the recipe's bf16 convolutions, every
    force on): relative L2 difference of the loss and of each parameter's
    gradient, each at most GRAD_TOL."""
    from fluidnet_tpu_torch.train.train import draw, init_train_state, loss_fn
    torch.backends.cudnn.deterministic = True
    mconf = recipe_mconf()
    model = init_train_state(17, mconf, dev).model
    draws = draw(torch.Generator().manual_seed(4), mconf)._replace(
        b_scale=torch.tensor(2.0), g_scale=torch.tensor(0.0),
        v_amp=torch.tensor(3.0))
    res = {}
    for use_kernels in (True, False):
        total, _ = loss_fn(model, batch, None, mconf, 4, draws=draws,
                           use_kernels=use_kernels)
        grads = torch.autograd.grad(total, list(model.parameters()))
        torch.cuda.synchronize()
        res[use_kernels] = [total.detach()] + list(grads)
    torch.backends.cudnn.deterministic = False
    names = ["loss"] + [k for k, _ in model.named_parameters()]
    worst = 0.0
    for name, a, b in zip(names, res[True], res[False]):
        rel = (torch.linalg.norm((a - b).float()) /
               torch.linalg.norm(b.float()).clamp_min(1e-30)).item()
        log(f"train grads n=4 kernels vs plain: {name}: relative L2 "
            f"{rel:.3e}")
        if not rel <= GRAD_TOL:
            raise AssertionError(f"train grads: {name} differs by {rel}")
        worst = max(worst, rel)
    return worst


# --- the offline 3-D slice ---------------------------------------------------


def load_script(name):
    """scripts/<name>.py as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_phase(dev):
    """K7: the probe's own path (scripts/torch_dyngather.py, both forms at
    128x128) with its launches counted; then each form at 128x128 and
    37x61 against its plain version and np.take_along_axis (the max abs
    error must be 0); times at 128x128 replayed from CUDA graphs: the
    kernel, its plain version and torch.gather (timed, never used)."""
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.ops.cuda.dyngather import (
        take_along_axis, take_along_axis_plain)
    probe = load_script("torch_dyngather")
    torch.cuda.synchronize()
    _build.launches.clear()
    if probe.main(dev) != 0:
        raise AssertionError("scripts/torch_dyngather.py failed")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    check_counts(launches, 2, {"dyngather": 1}, "probe (both forms)")
    worst, times = 0.0, {}
    for shape in PROBE_SHAPES:
        for axis in (1, 0):
            rng = np.random.default_rng(shape[1] + axis)
            src = rng.standard_normal(shape).astype(np.float32)
            idx = rng.integers(0, shape[axis], shape).astype(np.int32)
            s, i = torch.tensor(src, device=dev), torch.tensor(idx, device=dev)
            out = take_along_axis(s, i, axis)
            ref = take_along_axis_plain(s, i, axis)
            torch.cuda.synchronize()
            err = max((out - ref).abs().max().item(), float(np.abs(
                out.cpu().numpy() - np.take_along_axis(src, idx, axis))
                .max()))
            log(f"  K7 axis={axis} {shape[0]}x{shape[1]}: max abs err vs "
                f"plain and np.take_along_axis {err:.3e}")
            if err != 0.0:
                raise AssertionError(f"K7 axis={axis} {shape}: max abs err "
                                     f"{err}")
            worst = max(worst, err)
            if shape != PROBE_SHAPES[0]:
                continue
            i64 = i.to(torch.int64)
            kg = graph_ms(lambda: take_along_axis(s, i, axis), 50)
            pg = graph_ms(lambda: take_along_axis_plain(s, i, axis), 50)
            lib = graph_ms(lambda: torch.gather(s, axis, i64), 50)
            k_py = cuda_ms(lambda: take_along_axis(s, i, axis), 200)
            b_ms, b_by = bound(nbytes(s, i, out), 0)
            times[axis] = (kg, pg, b_ms, b_by, lib)
            log(f"time K7 axis={axis} at 128x128: from a CUDA graph, kernel "
                f"{kg:.5f} ms, plain {pg:.5f} ms, torch.gather {lib:.5f} ms;"
                f" issued from Python {k_py:.5f} ms; bound {b_ms:.7f} ms "
                f"({b_by}: {nbytes(s, i, out)} B)")
    return launches, worst, times


def write_scene_obj(path):
    """A closed box and a closed UV sphere beside it, as one OBJ (quads
    and triangle fans, 1-based indices)."""
    verts = [(x, y, z) for z in (0.0, 0.5) for y in (0.0, 1.0)
             for x in (0.0, 0.6)]
    faces = [(1, 3, 4, 2), (5, 6, 8, 7), (1, 2, 6, 5), (3, 7, 8, 4),
             (1, 5, 7, 3), (2, 4, 8, 6)]
    n_lat, n_lon, r = 12, 16, 0.35
    c = np.array([1.2, 0.5, 0.3])
    th = np.pi * np.arange(1, n_lat) / n_lat
    ph = 2 * np.pi * np.arange(n_lon) / n_lon
    ring = c + r * np.stack([np.outer(np.sin(th), np.cos(ph)),
                             np.outer(np.sin(th), np.sin(ph)),
                             np.repeat(np.cos(th)[:, None], n_lon, 1)],
                            -1).reshape(-1, 3)
    top = len(verts) + 1
    verts += [tuple(c + [0, 0, r])] + [tuple(v) for v in ring] + \
        [tuple(c - [0, 0, r])]
    bot = len(verts)

    def rv(i, j):
        return top + 1 + (i - 1) * n_lon + j % n_lon
    for j in range(n_lon):
        faces.append((top, rv(1, j), rv(1, j + 1)))
        faces.append((bot, rv(n_lat - 1, j + 1), rv(n_lat - 1, j)))
        faces += [(rv(i, j), rv(i + 1, j), rv(i + 1, j + 1), rv(i, j + 1))
                  for i in range(1, n_lat - 1)]
    with open(path, "w") as f:
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
        f.writelines("f " + " ".join(map(str, fc)) + "\n" for fc in faces)


def div_norm(state):
    from fluidnet_tpu_torch.ops.divergence import velocity_divergence
    return torch.linalg.norm(velocity_divergence(state.u, state.flags))


def sim3d_scene(dev):
    """The closed OBJ voxelized at VOX_DIM by the port's io.voxelize,
    written as .binvox, and cli.sim3d.build_scene's 128^3 plume around it.
    Returns (binvox path, state, bcs, obstacle cells of the flags)."""
    from fluidnet_tpu_torch.cli import sim3d
    from fluidnet_tpu_torch.io.voxelize import save_binvox, voxelize_obj
    os.makedirs(SIM3D_ROOT)
    obj = os.path.join(SIM3D_ROOT, "scene.obj")
    binvox = os.path.join(SIM3D_ROOT, "scene.binvox")
    write_scene_obj(obj)
    t0 = time.perf_counter()
    vox = voxelize_obj(obj, dim=VOX_DIM)
    save_binvox(binvox, vox)
    state, bcs = sim3d.build_scene(RES, binvox, dev)
    n_obst = int(((state.flags & 2) > 0).sum().item())
    border = RES ** 3 - (RES - 2) ** 3
    log(f"sim3d scene: {int(vox['data'].sum())} voxels at {VOX_DIM}^3 in "
        f"{time.perf_counter() - t0:.3f} s; {n_obst - border} obstacle "
        f"cells inside the {RES}^3 domain (plus its {border} border cells)")
    if not n_obst > border:
        raise AssertionError("sim3d scene: the obstacle is empty")
    return binvox, state, bcs, n_obst


def sim3d_phase(dev, model):
    """cli.sim3d around the voxelized obstacle at 128^3 with the bundled
    ConvNet and sim3d's knobs: (a) 768 frames with the ConvNet and with
    jacobi-34, nothing exported: ms/frame, ||div||_2 and finiteness every
    16 steps, the launches (K1 twice, K2's prologue once a ConvNet step;
    K1 twice, the forces block and K3 once a jacobi step); (c) 8 steps
    kernels vs plain from the ConvNet state after 64 frames; (b)
    cli.sim3d.main with --num_frames 25 --decimation 3, both .vbox files
    read back. Returns (launches, numbers, the scene)."""
    from fluidnet_tpu_torch.cli import sim3d
    from fluidnet_tpu_torch.io.vbox import read_vbox
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.sim.simulate import FlagConsts, rollout
    from fluidnet_tpu_torch.utils.checkpoint import load_mconf

    binvox, state0, bcs, n_obst = sim3d_scene(dev)
    base = sim3d.scene_knobs(load_mconf(BUNDLED), RES)
    runs = {"convnet": (base, model, {"prologue": 1}),
            "jacobi34": (base.replace(sim_method="jacobi"), None,
                         {"forces_block": 1, "jacobi": 1})}
    launches, out, snap = {}, {"ms_per_frame": {}, "div_l2": {}}, None
    for name, (m, net, per_step) in runs.items():
        state, consts, divs, finite = state0, FlagConsts(), [], []
        torch.cuda.synchronize()
        _build.launches.clear()
        t0 = time.perf_counter()
        for k in range(SIM3D_FRAMES // DIV_EVERY):
            state = rollout(state, m, DIV_EVERY, net, bcs, consts=consts)
            divs.append(div_norm(state))
            finite.append(torch.stack([torch.isfinite(t).all() for t in
                                       (state.u, state.p, state.density)])
                          .all())
            if net is not None and (k + 1) * DIV_EVERY == 64:
                snap = state
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / SIM3D_FRAMES * 1e3
        got = dict(_build.launches)
        check_launches(got, SIM3D_FRAMES, per_step, f"sim3d {name}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        divs = torch.stack(divs).tolist()
        if not torch.stack(finite).all().item():
            raise AssertionError(f"sim3d {name}: a non-finite state")
        out["ms_per_frame"][name] = ms
        out["div_l2"][name] = {"first": divs[0], "last": divs[-1],
                               "max": max(divs), "every16": divs}
        log(f"sim3d {name}: {SIM3D_FRAMES} frames at {RES}^3 around the "
            f"obstacle, {ms:.3f} ms/frame (||div|| read every {DIV_EVERY}"
            f" steps); ||div||_2 first {divs[0]:.6f}, last {divs[-1]:.6f}, "
            f"max {max(divs):.6f}; max|U| {state.u.abs().max().item():.4f};"
            f" every state finite")
    kernels_vs_plain_rollout(snap, base, model, bcs, "sim3d convnet")

    out_dir = os.path.join(SIM3D_ROOT, "out")
    torch.cuda.synchronize()
    _build.launches.clear()
    cli_ms = sim3d.main(["--res", str(RES), "--num_frames", "25",
                         "--decimation", "3", "--model", BUNDLED,
                         "--voxel_model", binvox, "--out_dir", out_dir]) * 1e3
    for k, v in _build.launches.items():
        launches[k] = launches.get(k, 0) + v
    frames, whd = read_vbox(os.path.join(out_dir,
                                         f"density_output_dt{base.dt}.vbox"))
    geom, _ = read_vbox(os.path.join(out_dir, "geom_output.vbox"))
    log(f"sim3d cli: 25 frames, {cli_ms:.3f} ms/frame; density .vbox "
        f"{frames.shape} (w, h, d) {whd}, max {frames.max():.4f}; geometry "
        f"{int(geom.sum())} occupied cells")
    if frames.shape != (8, RES, RES, RES) or not np.isfinite(frames).all() \
            or not frames.max() > 0.5:
        raise AssertionError(f"sim3d cli: density frames {frames.shape}")
    if geom.shape != (1, RES, RES, RES) or int(geom.sum()) != n_obst:
        raise AssertionError(f"sim3d cli: geometry holds {geom.sum()} "
                             f"cells, the scene {n_obst}")
    out["cli_ms_per_frame"] = cli_ms
    return launches, out, (state0, bcs, base)


def exact_phase(dev, model, scene):
    """The exact advection route (advection_window 0) on the sim3d scene:
    16 ConvNet frames (finite, K1 not launched, K2's prologue once a
    step), ms/frame and peak memory; then one exact advect_scalar and one
    advect_vel (maccormackOurs) at 64^3 with 15% obstacles on the card
    against the same calls on the CPU: relative L2 at most 1e-4, and the
    cells off by more than 1e-4 counted."""
    from fluidnet_tpu_torch.core.celltype import is_fluid
    from fluidnet_tpu_torch.ops import trace_diff
    from fluidnet_tpu_torch.ops.advect import advect_scalar, advect_vel
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.sim.simulate import rollout
    state0, bcs, base = scene
    m = base.replace(advection_window=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    t0 = time.perf_counter()
    state = rollout(state0, m, EXACT_FRAMES, model, bcs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / EXACT_FRAMES * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(_build.launches)
    check_counts(launches, EXACT_FRAMES, {"prologue": 1},
                 "exact route (convnet)")
    div = final_check(state, "exact route")
    log(f"exact route: {EXACT_FRAMES} ConvNet frames at {RES}^3, "
        f"{ms:.3f} ms/frame, peak memory {peak:.3f} GiB")
    rng = np.random.default_rng(43)
    shape = (1, 1) + (EXACT_RES,) * 3
    flags = torch.tensor(random_flags(rng, shape))
    u = torch.tensor((rng.standard_normal((1, 3) + shape[2:]) * 15.0)
                     .astype(np.float32))
    s = torch.tensor(rng.random(shape).astype(np.float32))
    vs = {}
    for what, fn in (
            ("advect_scalar", lambda d: advect_scalar(
                0.1, s.to(d), u.to(d), flags.to(d), window=None)),
            ("advect_vel", lambda d: advect_vel(
                0.1, u.to(d), flags.to(d), window=None))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu, gpu_traces = trace_diff.record_traces(lambda: fn(dev))
        torch.cuda.synchronize()
        g_ms = (time.perf_counter() - t0) * 1e3
        cpu, cpu_traces = trace_diff.record_traces(
            lambda: fn(torch.device("cpu")))
        diff = gpu.cpu() - cpu
        rel = (torch.linalg.norm(diff) /
               torch.linalg.norm(cpu).clamp_min(1e-30)).item()
        off = int((diff.abs() > 1e-4).sum().item())
        branches = trace_diff.branch_diff(cpu_traces, gpu_traces, dev)
        vs[what] = {"rel_l2": rel, "cells_off_1e-4": off, "card_ms": g_ms,
                    "trace_rays_off": branches}
        log(f"exact {what} maccormackOurs at {EXACT_RES}^3 ("
            f"{int((~is_fluid(flags)).sum())} non-fluid cells): card vs CPU "
            f"relative L2 {rel:.3e}, {off} of {diff.numel()} cells off by "
            f"more than 1e-4; {g_ms:.1f} ms on the card; its "
            f"{len(cpu_traces)} line traces, rays off card vs CPU: "
            f"{branches}")
        if not rel <= 1e-4:
            raise AssertionError(f"exact {what}: card vs CPU relative L2 "
                                 f"{rel}")
    return launches, {"ms_per_frame": ms, "peak_gib": peak,
                      "final_div_l2": div, "card_vs_cpu": vs}


def stats_phase(root):
    """cli.stats.compute on the generated 64^3 test split (every sample):
    the bundled ConvNet, jacobi-34 and PCG (34 iterations, the CLI's
    default), 64 steps; every TSV written and finite, PCG's mean ||div||_2
    at the last step below jacobi-34's. Returns those means."""
    from fluidnet_tpu_torch.cli import stats
    from fluidnet_tpu_torch.data.dataset import FluidDataset
    n = len(FluidDataset(root, "gen3d", "te"))
    out = os.path.join(root, "stats")
    args = stats.parse_args([
        "--data_dir", root, "--dataset", "gen3d", "--model", BUNDLED,
        "--methods", "convnet", "jacobi", "pcg", "--n_steps",
        str(STATS_STEPS), "--n_samples", str(n), "--out_dir", out])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = stats.compute(args)
    secs = time.perf_counter() - t0
    means = {}
    for method in ("convnet", "jacobi", "pcg"):
        tsv = np.loadtxt(os.path.join(out, f"norm_div_{method}.tsv"),
                         ndmin=2)
        if tsv.shape != (n, STATS_STEPS) or not np.isfinite(tsv).all() or \
                not np.allclose(tsv, res[method], rtol=1e-6):
            raise AssertionError(f"stats {method}: TSV {tsv.shape}")
        means[method] = float(tsv[:, -1].mean())
    log(f"stats: {n} test samples at {TRAIN_RES}^3, {STATS_STEPS} steps "
        f"each of convnet, jacobi-34, PCG in {secs:.3f} s; mean ||div||_2 "
        f"at the last step {means}")
    if not means["pcg"] < means["jacobi"]:
        raise AssertionError(f"stats: PCG {means['pcg']} is not below "
                             f"jacobi-34 {means['jacobi']}")
    return means


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
    probe_launches, errs["dyngather"], probe_times = probe_phase(dev)
    times["dyngather"] = probe_times[1]
    launches, steps_per_s, div_cnn = slice_phase(dev, mconf, model)
    cert_launches, divs = cert_phase(dev, mconf, model)
    serve_launches, windows = serve_phase(dev)
    cert2_launches, steps2_per_s, divs2 = serve_cert_phase(dev)

    train_errs, train_times = train_kernels_phase(dev)
    errs.update(train_errs)
    times.update(train_times)
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    try:
        data_s, data_res = data_phase(dev, TRAIN_ROOT)
        cli_launches = cli_phase(TRAIN_ROOT)
        batch = train_batch(dev, TRAIN_ROOT)
        stats_means = stats_phase(TRAIN_ROOT)
    finally:
        shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    step_launches, per_n = train_steps_phase(dev, batch)
    grad_rel = train_grad_phase(dev, batch)

    shutil.rmtree(SIM3D_ROOT, ignore_errors=True)
    try:
        sim3d_launches, sim3d_out, scene = sim3d_phase(dev, model)
        exact_launches, exact_out = exact_phase(dev, model, scene)
    finally:
        shutil.rmtree(SIM3D_ROOT, ignore_errors=True)

    total = dict(launches)
    for per in list(cert_launches.values()) + [serve_launches,
                                               cert2_launches, cli_launches,
                                               step_launches, probe_launches,
                                               sim3d_launches,
                                               exact_launches]:
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
    log(json.dumps({"train_shape": [TRAIN_B, TRAIN_RES, TRAIN_RES,
                                    TRAIN_RES],
                    "train_step_ms": {n: v[0] for n, v in per_n.items()},
                    "train_step_reps_ms": {n: v[1] for n, v in per_n.items()},
                    "train_peak_gib": {n: v[2] for n, v in per_n.items()},
                    "train_grad_rel_l2_max": grad_rel,
                    "data_gen_s": data_s, "data_max_pcg_residual": data_res,
                    "train_cli_launches": cli_launches}))
    log(json.dumps({"offline_3d": {
        "res": RES, "sim3d_frames": SIM3D_FRAMES, **{
            f"sim3d_{k}": v for k, v in sim3d_out.items()},
        "exact_route": exact_out, "stats_mean_div_l2_last": stats_means,
        "stats_steps": STATS_STEPS,
        "probe_times_ms": {f"axis{a}": {"ms": v[0], "plain_ms": v[1],
                                        "bound_ms": v[2],
                                        "library_ms": v[4]}
                           for a, v in probe_times.items()}}}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
