#!/usr/bin/env python3
"""Smoke test of the PyTorch port (fluidnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card: the 3-D 128^3 plume that bench.py
times for the JAX package (the ConvNet rollout and the jacobi-34 / PCG /
ConvNet + Jacobi-polish certification rollouts), the 2-D interactive
demo server (cli/serve.py with the bundled m2d ConvNet at 128^2), 3-D
training (the m3d_v5 recipe), the offline 3-D entry points (cli/sim3d.py
around a voxelized obstacle, the exact advection route, cli/stats.py), the
dyngather probe, the ConvNets of the generic stage path (tog, banks,
batch norm, the pressure skip), the host data path (the threaded
loader, the native C++ runtime) and the scale-out layer (z-sharded
advection, the halo Jacobi, data-parallel training, the z-sharded step
and its training, in ranks that share the card, or under NCCL one card a
rank where the machine has a card for each), in these phases:

  1. device: fails without CUDA; prints the card's name and power limit.
  2. build:  compiles the CUDA kernels (csrc/*.cu, one nvcc per source, all
             at once, into build/kernels/) and prints the seconds it took
             and ptxas's registers and spills per kernel; compiles the
             native host library (native/src/fluidnet_native.cpp, g++, into
             build/native/) and fails if it does not load.
  3. kernels vs plain: each 3-D kernel (K1 forward, K1 backward, K2
             prologue, K2 forces block, K3 Jacobi) against its plain
             PyTorch version on the same CUDA inputs: on the 128^3 plume
             state after a few steps, on a 1x37x45x61 grid with random
             obstacles, Stick and Empty cells and slab BCs, and (K3) on
             2-D 2x1x45x61 and 1x1x128x128 grids. K1 (at windows 1 and 2,
             at z origin 0 and at the Z_ORIGINS a slab of a z-sharded grid
             gives it, the last past MAX_TILED_EXTENT on the plume: the
             global route), K2 and K3 (34 sweeps, and 8 on the plume) fail
             unless equal to the bit. Times both versions at 128^3 with
             CUDA events, K1 and K2 also replayed from CUDA graphs (K1
             beside its tiling, and at window 2); K3
             replayed from CUDA graphs at 128^3 with 34 and 8 sweeps and at
             128^2 with 34, each beside the route
             (solvers/cuda_jacobi.jacobi_route) it takes. K3 from a given
             p0 (the rounds of the sharded solve) on the plume and on
             JACOBI_SLAB, the middle rank's slab of the 128^3 plume grown
             by 32 planes a side, at 1, 2, 3 and 32 sweeps from a random
             p0: equal to the bit; timed from graphs at JACOBI_SLAB with
             32 sweeps beside its bound and plain version.
  4. warp (K5) vs plain: every K5 call that one 2-D step makes, for each
             advection method at windows 1 and 2, recorded on a 128^2 serve
             plume after a few steps and on a random 2x1x1x45x61 grid with
             15% obstacles and fast flow (positions past the borders),
             replayed against the plain version; plus a 3-D 1x37x45x61
             case, trilinear with min/max and nearest, at z origin 0 and
             Z_ORIGINS[0] (positions global). Same limit. Times
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
             without the scalar and its renormalisation, ours or not, at
             window 1; the 'Ours' renormalised pair at 2 too), K6 (the
             sweep's own positions for u and the scalar, positions past
             the window, nearest, W 1 and 2, a 2-D case) and K4 on random
             6x64^3 (the training shape) and 1x128^3 grids with 15%
             obstacles; K1's forms at window 1 and K6 at the sweep's
             positions also at z origin Z_ORIGINS[0]; K6 fails above a max
             abs error of 1e-6, K1 and K4 unless equal to the bit. Times
             each at both shapes, K1 and K4 also replayed from CUDA graphs
             (K1 beside its tiling), K6
             beside grid_sample's input-gradient backward (timed, never
             used).
 10. data:   the port's generate_dataset with gen3d_v5's settings at 64^3,
             cut to 6 train and 2 test scenes of 16 frames (12 samples),
             into build/smoke_train/; seconds and max PCG residual.
 11. train cli: cli/train.main with train3d_v5.sh's flags (the m3d_v5
             recipe, batch 6) for 2 epochs with the horizon curriculum
             [[0,2,4],[1,4,8]] and an 8-step rollout selection, then a
             resume from '_lastEpoch' for a third: finite losses, the TSV
             log, '_lastEpoch', '_bestRollout' and '_ema' written; each run
             prints its startup profile (-profile true, the default: the
             model's FLOPs a 128^3 frame and the FPROP ms of one sample).
             Phase 19 runs next, on the same data.
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
             Then its training gradient: one train_step of m3d_v5's recipe
             at window 0 (float32 convolutions, n = EXACT_TRAIN_N) on
             phase 10's first sample (the reject guard off), finite, K1
             and K6 not launched; loss_fn's gradients on the card against the
             CPU's, each parameter within EXACT_GRAD_TOL relative L2.
 18. models: the generic stage path on the card. (a) the 3-D tog model
             (16-16-16-16-32-32-1, pools x2 after stages 1 and 2, pixel
             shuffles x2 at stage 6 and the head) from random_model(seed)
             in bf16 with bench.py's knobs on a fresh 128^3 plume: 8
             warm-up and 2 x 16 timed steps, K1 twice and K2's prologue
             once a step, finite, then 8 steps kernels vs plain. (b) the
             3-D two-bank mres model (concat) with batch norm and the
             pressure skip: 8 steps, the same launches, finite, kernels vs
             plain. (c) one train_step of the tog model at 6x64^3, n = 4,
             on phase 10's batch after a warm-up step: ms, peak memory,
             finite loss and gradient norm, launches against
             train_launches(4).
 19. loader: the host route of cli/train.py on phase 10's 64^3 set (run
             after phase 11). (a) cli/train.main with the recipe for one
             epoch with -num_data_threads 1 and -device_data_cache_max_gb
             below the set's size (the host route: PrefetchLoader and
             DeviceFeed's copies), then one epoch on the device cache
             from the same seed, deterministic cuDNN: every batch handed
             to train_step equal to the bit to the dataset's own batch of
             the seed's order, on both routes; the params after the epoch
             equal to the bit (and moved: no update rejected); each
             step's launches equal to train_launches of its horizon. (b)
             two epochs on the host route with the default 8 threads:
             every sample once an epoch, finite losses; ms per train step
             on each route, the loader's wait a batch, the copies' ms and
             MB/s. (c) the native library (built in phase 2) loads; its
             threaded frame reader equals load_manta_file on a batch's
             frames, both timed; in phase 16 the voxelization's native
             flood fill equals the dilation and the .binvox read back by
             the native decoder equals the NumPy decoder's cells. (d) an
             epoch of batch 1, three times the loader's queue, through
             DeviceFeed with 8 threads: every sample once, each batch
             equal to the bit to get_batch.
 20. parallel: the scale-out layer (parallel/) in ranks of scripts/
             torch_parallel_rank.py started with torchrun's variables,
             under NCCL with a card a rank where the machine has a card
             for every rank of a spawn, else sharing the card under gloo
             (every exchange staged through the host); each spawn prints
             its backend, each rank's card and the transport. (a) a 256^3
             plume around a box across the middle cut (8 ConvNet steps)
             z-sharded over 4 ranks: advect_step_z_sharded with
             maccormackOurs at W = 1 and 2 (dt moving the fastest cell W +
             0.5 cells): each
             rank's exchanged planes equal its neighbours', each slab equal
             to the bit to the same slab advected in this process and
             within TOL of it advected by the kernels' plain versions, K1's
             two unfused sweeps and K5 twice a step on every rank; the
             gathered shards against the whole grid within PAR_MAX, at most
             PAR_FRAC of the cells past PAR_ROUND (a slab's positions round
             at its own magnitude), and each of two planted exchange faults
             (zero halos, swapped halos) past those limits; ms a sharded
             step and an exchange per rank.
             (b) halo_jacobi_solve, 34 sweeps on the 128^3 plume's
             divergence over 4 ranks, equal to the bit to jacobi_plain and
             K3 on the whole grid; its ms beside K3's. (c) train_step with
             m3d_v5's recipe (the reject guard off) at 6x64^3, n = 4, on 2
             ranks of make_global_mesh (1 x 2 x 1, 3 samples a rank) against
             one process's step on the 6 samples: loss within rtol 1e-5,
             every parameter within GRAD_TOL relative L2, each rank's
             launches train_launches(4). A rank that fails or runs past
             PAR_TIMEOUT fails the phase; the ranks' launches are added to
             the kernels line.
 21. sharded step: the z-sharded rollout (parallel/simulate_sharded.py)
             in STEP_SP = 4 ranks of scripts/torch_parallel_rank.py, NCCL
             or gloo as phase 20's. Each run starts each rank
             from its slab of a global plume with bench.py's knobs and the
             bundled model and is held against one process's rollout with
             the kernels on the same state (STEP_RUNS): (a) a float32 copy
             of the checkpoint, 8 ConvNet steps of the 128^3 plume after 12
             steps (the gathered u, p, density within STEP_MAX of the
             field's largest value, at most STEP_FRAC of the cells past
             STEP_ROUND: tests/test_torch_sharded_sim.py's limits); (b)
             the checkpoint as shipped (bf16), 8 steps: the errors
             reported, the final ||div||_2 of the gathered state within
             STEP_DIV_REL of one process's; (c) ConvNet + p8 (float32),
             (d) jacobi-34 on the halo Jacobi, both held as (a); (e) the
             empty 256^3 plume, bf16, 4 steps, held as (b); (f) (a) and
             (b) with the ghost planes of step 2's exchange zeroed must
             fail their limits; (g) why bf16 rounds apart: (b) with the
             whole grid's input scale of each step fed to the slabs, and
             one step of each, each rank's own planes against the whole
             grid's cell by cell; (h) PCG (bench.py's: max_iter 100,
             pcg_tol 1e-4; pcg_sharded.solve_pcg_z_sharded on the slabs),
             STEP_PCG_N = 4 steps: u within STEP_PCG_U of one process's
             (over u's largest value), the labels equal to one process's
             to the bit,
             every rank's CG iterations and residuals a step the same,
             each rank's rerun equal to the bit, the labelling's sweeps,
             ms and collectives and the CG iterations a step printed; (i)
             (h) with the CG direction's exchange zeroed must fail the u
             limit; (j) phase 18's models with random weights (seed 18),
             float32: tog (ghost zone G = 28, its trunk's reach 16 rounded
             up to its pooling factor 4) and the two-bank mres model with
             batch norm and the skip (G = 16), each held as (a), and (k)
             tog with its trunk one plane off the pooling factor's
             multiples must fail them; (l) the rolled state without
             density (no BCs), 8 steps, held as (a); (m) the exact route,
             maccormackOurs at window 0 (G = 27), STEP_EXACT_N = 4 steps,
             held as (a), and (n) with step 2's ghost planes zeroed must
             fail its limits; (o) Manta's euler at window 0 with u_z raised
             by STEP_FAST_UZ everywhere, 2 steps, held as (a): G from the
             all_reduced max|u_z| passes a slab's 32 planes, so the
             exchange takes planes from two ranks a side (G and the ranks
             reached a step printed). Every rank runs each rollout a second
             time with the kernels' plain versions on the same slab (K1,
             K2, K3 at the shapes this path gives them) and must give the
             same bits. Each slab advects at its z origin, so every rank's
             own planes must equal one process's to the bit through the
             advection and K2: the first step's model inputs (u, div) in
             every ConvNet run, the whole rollout in (d). Each rank
             launches K1's fused forward and backward
             and K2's prologue once a step (K2's forces block in (d) and
             (h); K1's unfused sweeps and K4 in (l); K2's prologue alone in
             (m)-(o)), K3 once a step in (c) and twice in (d): jacobi-34 runs
             halo.slab_jacobi_solve, two rounds of K3 on the slab grown by
             32 planes. (d) is rerun on the per-sweep halo Jacobi, which
             must give the same bits, and timed beside it in the same
             call; the exchanges a step of both are printed (4 and 37).
             Per rank: ms a step (a rollout over its steps), ms an
             exchange of the step's fields, beside one process's ms a
             step. A rank that fails or runs past
             PAR_TIMEOUT fails the phase; the ranks' launches are added to
             the kernels line.

 22. sharded train: train_step(mesh=) (parallel/train_sharded.py) in
             SPT_WORLD = 4 ranks of scripts/torch_parallel_rank.py, NCCL
             or gloo as phase 20's, with m3d_v5's recipe (the
             reject guard off), n = 4, deterministic cuDNN and draws with
             buoyancy and vorticity on, each run of SPT_RUNS against one
             process's loss_fn and train_step on the whole batch: (a) dp 1
             x sp 4 on phase 10's 6x64^3 batch, float32 convolutions; (b)
             the same in bf16, as trained; (c) dp 2 x sp 2, bf16; (d) dp 1 x
             sp 4 on 2 samples of the 128^3 plume, bf16; (e) (a) with
             augment_without_targets (K4 on every slab, once a step a
             rank; each rank's augmented u equal to the bit to the whole
             batch's); (c-f32) and (d-f32): (c) and (d) in float32, at
             (a)'s limits; (f) (a) with PCG solver targets and the p and u
             losses on (the sharded PCG and the per-component p mean
             across the slabs; K4 once a step), at (a)'s limits, its
             planted fault the CG direction's exchange zeroed; (g) tog
             (phase 18's, random weights) in float32 over dp 1 x sp 2 in a
             second spawn of 2 ranks (slabs of 32 planes, model calls
             grown by 24), at (a)'s limits, its planted fault the trunk
             one plane off its pooling factor's multiples; (h) the exact
             route (window 0) in float32 over dp 1 x sp 4 on one sample
             of the batch, n = SPT_EXACT_N = 2, at (a)'s limits (its ranks
             sum torch.gather's backward in a fixed order: torch's
             deterministic algorithms); (e) at
             (a)'s terms limit and 2x its gradients' sound reading
             (SPT_RUNS). Each: the loss terms within rtol and every
             gradient and param after 2 steps within the relative L2 of
             its limits; each rank's gradients equal to the bit to its
             rerun with every kernel's plain version; each rank's
             launches train_launches(n) (and K4 once in (e) and (f); K2's
             alone in (h)); the
             planted fault
             (the exchanges' adjoint drops the ghost planes' cotangents)
             past the gradient limit, its margin (fault over limit)
             printed; for a float32 run, how much one process's gradient
             of the worst parameter cancels (bias_cotangents). Per rank:
             ms a train step,
             ms a forward and an adjoint exchange of a step's fields, its
             collectives, peak memory; one process's ms and peak beside. A
             rank that fails or runs past PAR_TIMEOUT fails the phase; the
             ranks' launches are added to the kernels line.

The last lines are a JSON object per group of phases (phase 20's is "parallel",
phase 21's "sharded_step", phase 22's "sharded_train"), the card's name and power limit, a JSON object with
one entry per kernel, and {"ok": true, "device": {...}}. Any failure raises:
the exit code is then not 0 and no result line is printed.
Outputs under build/ are removed at the end.
"""


import contextlib
import io
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
# div add and one division in 3-D (3 adds in 2-D).
FLOPS_PER_CELL = {"mac_sweep_fwd": 378, "mac_sweep_bwd": 378,
                  "prologue": 81, "forces_block": 76,
                  "mac_sweep_unfused_fwd": 370, "mac_sweep_unfused_bwd": 354,
                  "vorticity": 70}
JACOBI_FLOPS_3D, JACOBI_FLOPS_2D = 7, 5
# The slab a middle rank's sharded jacobi-34 solve runs K3 on at 128^3 over
# 4 ranks: 32 own planes grown by 32 a side (rank 1's: planes 0-95).
JACOBI_SLAB = (1, 1, 96, 128, 128)
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
# The exact route's train step: its horizon, and its loss_fn gradients on
# the card against the CPU's (relative L2 a parameter).
EXACT_TRAIN_N, EXACT_GRAD_TOL = 2, 1e-3
PCG_REPEAT_STEPS = 16           # two PCG rollouts that must agree to the bit
STATS_STEPS = 64
PROBE_SHAPES = ((128, 128), (37, 61))
TRAIN_RES, TRAIN_B = 64, 6      # gen3d_v5's grid, train3d_v5.sh's batch
TRAIN_REPS = 3                  # timed train steps per horizon
# z origins (the global index of an array's first plane, a slab's of a
# z-sharded grid) at which K1, K5 and K6 are held to their plain versions
# besides 0; the second puts the 128^3 plume past MAX_TILED_EXTENT.
Z_ORIGINS = (2998, 2 ** 15 - 64)
EXACT = 1e-6                    # K6 vs plain: max abs error
GRAD_TOL = 1e-4                 # train grads, kernels vs plain: rel. L2
# The flags of scripts/train3d_v5.sh (the m3d_v5 recipe), batch 6.
RECIPE = ["-batch_size", "6", "-seed", "17",
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


# Phase 18: the models of the generic stage path on bench.py's plume,
# each with its timed reps of MODEL_STEPS steps after MODEL_WARMUP.
MODEL_WARMUP, MODEL_STEPS = 8, 16
MODEL_SEED = 18                 # random_model's seed for these models
MODELS = {"tog": (dict(model_type="tog"), 2),
          "mres_bn_skip": (dict(banks_num=2, add_batch_norm=True,
                                add_pressure_skip=True), 0)}


# Phase 20: the scale-out paths (parallel/) in ranks of
# scripts/torch_parallel_rank.py: NCCL, a card a rank, where the machine has
# a card for every rank of a spawn, else gloo, the ranks sharing the card
# (spawn_backend).
PAR_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "parallel")
PAR_RES, PAR_SP, PAR_WINDOWS = 256, 4, (1, 2)   # the 256^3 stretch path
PAR_ROLL = 8                    # ConvNet steps of the 256^3 plume
PAR_REPS = 5                    # timed sharded steps, exchanges, solves
PAR_JACOBI = 34                 # halo Jacobi sweeps on the 128^3 plume
PAR_DP, PAR_GEN_SEED = 2, 5     # data-parallel ranks; the draws' seed
PAR_TIMEOUT = 600               # seconds a spawn of ranks may take
# Each slab against the same slab advected in this process: equal to the
# bit; against that slab advected by the kernels' plain versions: within
# TOL. The gathered shards against the whole grid cannot be equal to the
# bit: positions are absolute (cell index + displacement), so a slab's
# weights round at its own index magnitude, not the grid's (at 256^3 a
# weight moves by up to ~1.2e-5), and where a displacement lies within an
# ulp of a whole cell the support's corners shift by one, which moves the
# MacCormack clamp's bounds by up to the field's jump between neighbours.
# So at most PAR_FRAC of the cells may differ by more than PAR_ROUND of
# the field's largest value, and none by more than PAR_MAX of it: a few
# times what the H100 showed (u 7.506e-05; 5.96e-08 of the cells, 3 of
# u's 50M, past PAR_ROUND). Two planted exchange faults must fail them.
PAR_ROUND, PAR_FRAC, PAR_MAX = 1e-5, 2e-7, 3e-4
PAR_FAULTS = ("zero_halo", "swapped_halo")
# Launches of one sharded maccormackOurs step with one density channel.
PAR_STEP = {"mac_sweep_unfused_fwd": 1, "mac_sweep_unfused_bwd": 1,
            "warp": 2}


# Phase 21: the z-sharded rollout (parallel/simulate_sharded.py) in ranks of
# scripts/torch_parallel_rank.py (NCCL or gloo, as phase 20's): the
# bench's plume at 128^3 over STEP_SP ranks, STEP_N steps a run, and the
# empty 256^3 plume STEP_BIG_N steps.
STEP_SP, STEP_N = 4, 8
STEP_BIG, STEP_BIG_N = 256, 4
# tests/test_torch_sharded_sim.py's limits (its PORT_*): the gathered
# slabs against one process's rollout with the kernels, the largest
# difference over the field's largest value and the share of cells past
# STEP_ROUND of it (on an H100 the float32 runs read at most 4.581e-07,
# jacobi-34 0). The bf16 trunk rounds apart from the whole grid's once
# the input scale's sums round apart (PERF.md §6) and is held by its
# final ||div||_2 within STEP_DIV_REL of one process's: on an H100, 8x the
# largest sound reading (8.236e-06 at 128^3, 0 at 256^3) and 3.5x under
# the planted bf16 fault's 2.339e-04.
STEP_MAX, STEP_ROUND, STEP_FRAC = 1e-5, 1e-6, 1e-3
STEP_DIV_REL = 6.6e-5
# The sharded PCG rollout (bench.py's PCG: max_iter 100, pcg_tol 1e-4)
# against one process's: the largest difference of u over u's largest
# value. Its dot products and component sums add in another order, and CG
# carries the rounding from one iteration to the next: 4x the sound
# reading on an H100 (6.333e-06; the planted fault 6.780e-01).
STEP_PCG_U = 2.53e-5
# PCG's runs take STEP_PCG_N steps (8 until the exact route's runs came:
# at ~1.3 s a step a rank, PCG was most of the phase).
STEP_PCG_N = 4
PCG_KW = dict(sim_method="pcg", max_iter=100, pcg_tol=1e-4)
K1_FUSED = {"mac_sweep_fwd": 1, "mac_sweep_bwd": 1}
CONVNET_STEP = dict(K1_FUSED, prologue=1)
# Each run of phase 21: mconf changes, conv dtype, state (a key of the
# phase's states, or the empty plume's resolution), steps, the run whose
# one-process rollout it is held against, how it is held, a planted
# fault (True: the ghost planes of step 2's exchange zeroed;
# "cg_direction": the CG direction's exchange zeroed; "misaligned": the
# trunk one plane off its pooling factor's multiples), whether the model
# is fed the whole grid's input scale of each step in place of the
# slab's, the launches a rank makes a step, and the seed of random
# weights (phase 18's models: tog at G = 28 and a two-bank mres model
# with batch norm and the skip at G = 16 on slabs of 32 planes; None: the
# bundled model). Held: "limits" (STEP_MAX,
# STEP_FRAC), "div" (STEP_DIV_REL), "fails_limits" and "fails_div" (a
# planted fault must fail them), "report" (errors reported: whether the
# bf16 trunk rounds apart on a slab through its input scale's sums or
# through the convolutions themselves), "u_limit" (PCG: u within
# STEP_PCG_U) and "fails_u_limit" (its planted fault must fail it).
STEP_DEFAULT = dict(kw={}, dtype="float32", state="rolled", steps=STEP_N,
                    ref=None, held="limits", fault=False, fed=False,
                    launches=CONVNET_STEP, seed=None, drop_density=False,
                    u_z_add=0.0)
TOG = dict(kw=MODELS["tog"][0], seed=MODEL_SEED)
# The z-sharded step's remainders: (l) the rolled state without density
# (no BCs: create_plume_bcs needs density), K1's unfused velocity sweeps
# and K4 a step a rank; (m) the exact route (maccormackOurs at window 0,
# G 27), STEP_EXACT_N steps, K2's prologue alone; (n) (m) with step 2's
# ghost planes zeroed; (o) Manta's euler at window 0 with u_z raised by
# STEP_FAST_UZ everywhere: dt max|u_z| past a slab's 32 planes, so G
# (from the all_reduced max|u_z| each step) takes planes from two ranks.
STEP_EXACT_N, STEP_FAST_UZ = 4, 340.0
EXACT_RUN = dict(kw=dict(advection_window=0), steps=STEP_EXACT_N,
                 launches=dict(prologue=1))
STEP_RUNS = {name: {**STEP_DEFAULT, "ref": name, **run} for name, run in {
    "f32": {},
    "bf16": dict(dtype="bfloat16", held="div"),
    "p8": dict(kw=dict(polish_iters=8),
               launches=dict(CONVNET_STEP, jacobi=1)),
    "jacobi34": dict(kw=dict(sim_method="jacobi", max_iter=34),
                     launches=dict(K1_FUSED, forces_block=1, jacobi=2)),
    "big": dict(dtype="bfloat16", state=STEP_BIG, steps=STEP_BIG_N,
                held="div"),
    "fault": dict(ref="f32", fault=True, held="fails_limits"),
    "fault_bf16": dict(dtype="bfloat16", ref="bf16", fault=True,
                       held="fails_div"),
    "bf16_fed": dict(dtype="bfloat16", ref="bf16", fed=True,
                     held="report"),
    "bf16_1": dict(dtype="bfloat16", steps=1, held="report"),
    "bf16_1_fed": dict(dtype="bfloat16", steps=1, ref="bf16_1", fed=True,
                       held="report"),
    "pcg": dict(kw=PCG_KW, held="u_limit", steps=STEP_PCG_N,
                launches=dict(K1_FUSED, forces_block=1)),
    "pcg_fault": dict(kw=PCG_KW, ref="pcg", fault="cg_direction",
                      held="fails_u_limit", steps=STEP_PCG_N,
                      launches=dict(K1_FUSED, forces_block=1)),
    "tog": TOG,
    "tog_fault": dict(TOG, ref="tog", fault="misaligned",
                      held="fails_limits"),
    "mres_bn_skip": dict(kw=MODELS["mres_bn_skip"][0], seed=MODEL_SEED),
    "nodensity": dict(drop_density=True, launches={
        "mac_sweep_unfused_fwd": 1, "mac_sweep_unfused_bwd": 1,
        "vorticity": 1}),
    "exact": EXACT_RUN,
    "exact_fault": dict(EXACT_RUN, ref="exact", fault=True,
                        held="fails_limits"),
    "exact_euler": dict(kw=dict(advection_window=0,
                                advection_method="euler"),
                        u_z_add=STEP_FAST_UZ, steps=2,
                        launches=dict(prologue=1)),
}.items()}


# Phase 22: sp-sharded training (parallel/train_sharded.py) in SPT_WORLD
# ranks of scripts/torch_parallel_rank.py (NCCL or gloo, as phase 20's):
# m3d_v5's recipe (the reject guard off), n = SPT_N, draws with buoyancy and
# vorticity on, against one process's train_step on the whole batch. Each
# run: its ('dp', 'sp') mesh, conv dtype, batch (phase 10's 6x64^3, or
# SPT_BIG_B samples of the plume at SPT_BIG^3), mconf changes and limits:
# each loss term within rtol, each gradient and each param after 2 steps
# within the relative L2; the planted fault (the exchanges' adjoint drops
# the ghost planes' cotangents) must fail the latter. float32: phase 20's
# limits, in (a), (c-f32) and (d-f32); augmentation (e): below.
# bf16, on an H100 (deterministic cuDNN: two calls read the same digits):
# terms 8x the run's sound reading, gradients 4x, which stays under its
# planted fault's: terms 4.532e-07 / 1.869e-07 / 1.102e-06 (d keeps its
# earlier 3.4e-06, 3.1x), gradients 1.992e-03 / 1.328e-03 / 2.995e-03,
# faults 4.748e-02 / 1.421e-02 / 2.011e-02 in (b) / (c) / (d) (5.9x,
# 2.6x, 1.7x their limits). (e) cannot hold GRAD_TOL on one parameter:
# over all parameters it reads 4.319e-07, but one process's gradient of
# its worst, a bias, is a sum that cancels (the phase prints by how
# much), and the slabs sum it in another order; its limit is 2x the
# sound reading 2.196e-04, 106x under its fault 4.670e-02. (f) PCG solver
# targets with the p and u losses on (the batch's targets zeros: the
# solver's replace them), float32 at (a)'s limits; its planted fault is
# the CG direction's exchange zeroed ("cg_direction"). (g) tog, float32,
# over dp 1 x sp 2 (a spawn of its own: a run's mesh holds every rank of
# its spawn), at (a)'s limits; its planted fault is the trunk one plane
# off its pooling factor's multiples ("misaligned").
SPT_WORLD, SPT_N, SPT_SEED, SPT_GEN_SEED = 4, 4, 17, 6
# (h) the exact route (window 0) over dp 1 x sp 4 on one sample of the
# 64^3 batch (slabs of 16 planes: G 27 takes planes from two ranks), its
# own horizon SPT_EXACT_N (the exact step costs ~30x a windowed one), at
# (a)'s limits; its planted fault the dropped adjoint.
SPT_EXACT_N = 2
SPT_BIG, SPT_BIG_B = 128, 2
SPT_F32 = dict(rtol=1e-5, rel_l2=GRAD_TOL)
SPT_RUNS = {
    "a_f32_sp4": dict(mesh=(1, 4), dtype="float32", batch="train",
                      limits=SPT_F32),
    "b_bf16_sp4": dict(mesh=(1, 4), dtype="bfloat16", batch="train",
                       limits=dict(rtol=3.7e-6, rel_l2=8.0e-3)),
    "c_bf16_dp2_sp2": dict(mesh=(2, 2), dtype="bfloat16", batch="train",
                           limits=dict(rtol=1.5e-6, rel_l2=5.4e-3)),
    "d_bf16_sp4_big": dict(mesh=(1, 4), dtype="bfloat16", batch="big",
                           limits=dict(rtol=3.4e-6, rel_l2=1.2e-2)),
    "e_f32_sp4_augment": dict(mesh=(1, 4), dtype="float32", batch="train",
                              kw=dict(augment_without_targets=True),
                              limits=dict(rtol=1e-5, rel_l2=4.4e-4)),
    "c_f32_dp2_sp2": dict(mesh=(2, 2), dtype="float32", batch="train",
                          limits=SPT_F32),
    "d_f32_sp4_big": dict(mesh=(1, 4), dtype="float32", batch="big",
                          limits=SPT_F32),
    "f_f32_sp4_pcg": dict(mesh=(1, 4), dtype="float32", batch="targets",
                          kw=dict(train_target_source="pcg",
                                  loss_p_lambda=1.0, loss_u_lambda=1.0),
                          fault="cg_direction", limits=SPT_F32),
    "g_f32_sp2_tog": dict(mesh=(1, 2), dtype="float32", batch="train",
                          kw=MODELS["tog"][0], fault="misaligned",
                          limits=SPT_F32),
    "h_f32_sp4_exact": dict(mesh=(1, 4), dtype="float32", batch="one",
                            kw=dict(advection_window=0), n=SPT_EXACT_N,
                            limits=SPT_F32),
}


def train_launches(n, exact=False):
    """Kernel launches of one 'full'-mode train_step at unroll horizon n:
    K1 fused n forward + n - 1 recomputed per direction; K1 unfused and K6
    (two per sweep) for the n - 1 steps whose input depends on the
    parameters (the first step's does not, and autograd skips its
    adjoint); K2's prologue 2(n - 1); its forces block once (the last,
    output_div, step). `exact` (window 0): K2's alone, the advection is
    plain PyTorch."""
    k2 = {"prologue": 2 * (n - 1), "forces_block": 1}
    if exact:
        return k2
    return {"mac_sweep_fwd": 2 * n - 1, "mac_sweep_bwd": 2 * n - 1,
            "mac_sweep_unfused_fwd": n - 1, "mac_sweep_unfused_bwd": n - 1,
            "warp_transpose": 4 * (n - 1), **k2}


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


def make_plume(dev, res=RES, flags=None):
    from fluidnet_tpu_torch.core.grids import FluidState, empty_domain
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs
    shape = (1, 1, res, res, res)
    state = FluidState(
        u=torch.zeros((1, 3) + shape[2:], device=dev),
        p=torch.zeros(shape, device=dev),
        flags=empty_domain(shape, True, device=dev) if flags is None
        else flags,
        density=torch.zeros(shape, device=dev))
    return state, create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)


def rolled_plume(dev, mconf, model, steps=12):
    """The 128^3 plume after `steps` ConvNet steps, and its bcs: the state
    the kernels are held and timed on (K3 on its flags and divergence)."""
    from fluidnet_tpu_torch.sim.simulate import rollout
    state, bcs = make_plume(dev)
    return rollout(state, mconf, steps, model, bcs), bcs


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


def plume_forces_args(state, bcs, dt):
    """K2's prologue arguments on the plume: bench.py's buoyancy (scale 2)
    and confinement (amp 3), no gravity, the plume's slab masks (the
    forces block takes the first 7)."""
    from fluidnet_tpu_torch.core.grids import get_dx
    dx = get_dx(state.flags)
    return (state.u, state.flags, state.density,
            [0.0, -(dx / 4.0) * 2.0, 0.0], [0.0] * 3, 3.0 * dx, dt,
            bcs.u_bc, bcs.u_bc_inv_mask)


def random_forces_args(rnd, dt):
    """K2's prologue arguments on random_case: buoyancy and gravity on
    every axis, slab masks."""
    return (rnd["u"], rnd["flags"], rnd["s"], [0.01, -0.2, 0.03],
            [0.0, -0.05, 0.02], 0.7, dt, rnd["u_bc"], rnd["u_inv"])


def kernels_phase(dev, mconf, model):
    from fluidnet_tpu_torch.core.celltype import is_fluid, is_obstacle
    from fluidnet_tpu_torch.core.grids import border_mask
    from fluidnet_tpu_torch.ops.cuda import forces_kernel, mac_sweep
    from fluidnet_tpu_torch.ops.divergence import velocity_divergence
    from fluidnet_tpu_torch.ops.forces import forces_block_xla
    from fluidnet_tpu_torch.solvers.cuda_jacobi import (
        device_limits, jacobi_cuda, jacobi_plain, jacobi_route)

    dt, strength, W = mconf.dt, mconf.maccormack_strength, 1
    state, bcs = rolled_plume(dev, mconf, model)
    plume = {"flags": state.flags, "u": state.u, "s": state.density,
             "div": velocity_divergence(state.u, state.flags),
             "pro_args": plume_forces_args(state, bcs, dt)}
    rnd = random_case(dev)
    rnd["pro_args"] = random_forces_args(rnd, dt)
    errs = {k: 0.0 for k in KERNELS}
    calls, k1_w2 = {}, {}
    for name, case in (("plume 1x128^3", plume), ("random 1x37x45x61", rnd)):
        log(f"kernels vs plain on {name}:")
        flags = case["flags"]
        m = is_fluid(flags).to(torch.float32)
        # K1 at the bench's window 1 and at 2 (the default window),
        # fused forward then backward, equal to the bit.
        k1 = {w: dict(zip(("mac_sweep_fwd", "mac_sweep_bwd"),
                          k1_fused_args(case, m, dt, strength, w)))
              for w in (W, 2)}
        for w, sweeps in k1.items():
            for key, args in sweeps.items():
                out = mac_sweep.advect_sweep_fused_ep(*args)
                ref = mac_sweep.sweep_fused_ep_plain(*args)
                torch.cuda.synchronize()
                for k in ref:
                    errs[key] = max(errs[key], bit_exact(
                        out[k], ref[k], f"K1 {key[10:]} W={w} {k}"))
                for z0 in Z_ORIGINS:
                    out = mac_sweep.advect_sweep_fused_ep(*args, z0=z0)
                    ref = mac_sweep.sweep_fused_ep_plain(*args, z0=z0)
                    torch.cuda.synchronize()
                    what = (f"K1 {key[10:]} W={w} at z origin {z0} ("
                            f"{mac_sweep.sweep_route(w, args[0].shape, z0)}"
                            f" route)")
                    for k in ref:
                        errs[key] = max(errs[key], bit_exact(
                            out[k], ref[k], f"{what} {k}", quiet=True))
                    log(f"  {what}: every channel bit-identical")
        if case is plume:
            k1_w2 = k1[2]
        fwd_args, bwd_args = k1[W].values()
        free = fwd_args[5]
        pro_args = case["pro_args"]
        ref_p = forces_kernel.prologue_plain(*pro_args)
        out_p = forces_kernel.prologue_cuda(*pro_args)
        fb_args = pro_args[:7]
        ref_fb = forces_block_xla(*fb_args)
        out_fb = forces_kernel.forces_block_cuda(*fb_args)
        jac_args = (flags, case["div"], 34)
        ref_j = jacobi_plain(*jac_args)
        out_j = jacobi_cuda(*jac_args)
        torch.cuda.synchronize()
        for i, what in enumerate(("u''", "div")):
            errs["prologue"] = max(errs["prologue"], bit_exact(
                out_p[i], ref_p[i], f"K2 prologue {what}"))
        errs["forces_block"] = max(errs["forces_block"], bit_exact(
            out_fb, ref_fb, "K2 forces block u'"))
        errs["jacobi"] = max(errs["jacobi"], bit_exact(
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
                    nbytes(case["u"], flags, case["s"], pro_args[7],
                           pro_args[8]) + 4 * 4 * m.numel(),
                    FLOPS_PER_CELL["prologue"] * m.numel()),
                "forces_block": (
                    forces_block_xla, forces_kernel.forces_block_cuda,
                    fb_args, nbytes(case["u"], flags, case["s"]) +
                    3 * 4 * m.numel(),
                    FLOPS_PER_CELL["forces_block"] * m.numel()),
            }
            # K3's timed cases: the jacobi-34 projection, the polish.
            jac_timed = {f"{RES}^3 {n} sweeps": (
                flags, case["div"], n, JACOBI_FLOPS_3D * n * active)
                for n in (34, 8)}
            errs["jacobi"] = max(errs["jacobi"], bit_exact(
                jacobi_cuda(flags, case["div"], 8),
                jacobi_plain(flags, case["div"], 8), "K3 p (8 sweeps)"))

    # K3 from a random p0 (border and obstacle cells not 0): on the plume
    # and on the slab the sharded jacobi-34 solve's rounds run on.
    rng = np.random.default_rng(16)
    slab_f = plume["flags"][:, :, :JACOBI_SLAB[2]].contiguous()
    slab_d = plume["div"][:, :, :JACOBI_SLAB[2]].contiguous()
    for label, (f, d) in ((f"{RES}^3", (plume["flags"], plume["div"])),
                          ("x".join(map(str, JACOBI_SLAB[2:])),
                           (slab_f, slab_d))):
        p0 = torch.tensor(rng.standard_normal(d.shape).astype(np.float32),
                          device=dev)
        for n in (1, 2, 3, 32):
            errs["jacobi"] = max(errs["jacobi"], bit_exact(
                jacobi_cuda(f, d, n, p0), jacobi_plain(f, d, n, p0),
                f"K3 p from p0 at {label} ({n} sweeps)"))
    active_s = ((~border_mask(slab_f.shape, True, 1, dev)) &
                ~is_obstacle(slab_f)).sum().item()
    jac_p0 = (slab_f, slab_d, 32, p0, JACOBI_FLOPS_3D * 32 * active_s)

    rng = np.random.default_rng(9)
    for shape2 in ((2, 1, 1, 45, 61), (1, 1, 1, RES2, RES2)):
        log(f"kernels vs plain on 2-D {'x'.join(map(str, shape2))} (K3):")
        flags2 = torch.tensor(random_flags(rng, shape2), device=dev)
        div2 = torch.tensor(rng.standard_normal(shape2).astype(np.float32),
                            device=dev)
        errs["jacobi"] = max(errs["jacobi"], bit_exact(
            jacobi_cuda(flags2, div2, 34), jacobi_plain(flags2, div2, 34),
            "K3 2-D p (34 sweeps)"))
    active2 = ((~border_mask(flags2.shape, False, 1, dev)) &
               ~is_obstacle(flags2)).sum().item()
    jac_timed[f"{RES2}^2 34 sweeps"] = (flags2, div2, 34,
                                         JACOBI_FLOPS_2D * 34 * active2)

    # Times at 128^3, in turns: plain, kernel, kernel, plain; the kernels
    # also replayed from CUDA graphs, the time they report (eager in
    # brackets). K1 with its tiling, and at W = 2 from graphs alone.
    times = {}
    for key, (plain, kern, args, nb, flops) in calls.items():
        p1 = cuda_ms(lambda: plain(*args), 5)
        k1 = cuda_ms(lambda: kern(*args), 50)
        k2 = cuda_ms(lambda: kern(*args), 50)
        p2 = cuda_ms(lambda: plain(*args), 5)
        kg = graph_ms(lambda: kern(*args), 20)
        b_ms, b_by = bound(nb, flops)
        times[key] = (kg, (p1 + p2) / 2, b_ms, b_by)
        extra = ""
        if key in k1_w2:
            w2 = graph_ms(lambda: kern(*k1_w2[key]), 20)
            extra = (f"; tiling {k1_tiling(args, True)._asdict()}; W=2 "
                     f"graph {w2:.5f} ms, tiling "
                     f"{k1_tiling(k1_w2[key], True)._asdict()}")
        log(f"time {key} at {RES}^3: graph {kg:.5f} ms [eager {k1:.4f} / "
            f"{k2:.4f} ms], plain {p1:.4f} / {p2:.4f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}: {nb / 1e6:.1f} MB, "
            f"{flops / 1e6:.0f} MFLOP){extra}")

    # K3 replayed from CUDA graphs (one launch a solve: the host's cost of
    # issuing it is not the kernel's), with the route each shape takes.
    limits = device_limits(dev.index)
    for label, (f, d, n, flops) in jac_timed.items():
        part = jacobi_route(d.shape, *limits)
        kg = graph_ms(lambda: jacobi_cuda(f, d, n), 20)
        pg = cuda_ms(lambda: jacobi_plain(f, d, n), 3)
        nb = nbytes(f, d) + 4 * d.numel()
        b_ms, b_by = bound(nb, flops)
        log(f"time jacobi {label}: route {part.route} ({part.blocks} blocks "
            f"of {part.rows_per_block} rows, {part.smem} B shared memory; "
            f"{limits[0]} co-resident): graph {kg:.5f} ms, plain {pg:.4f} "
            f"ms; bound {b_ms:.5f} ms ({b_by})")
        if label == f"{RES}^3 34 sweeps":
            times["jacobi"] = (kg, pg, b_ms, b_by)
    f, d, n, p0, flops = jac_p0
    part = jacobi_route(d.shape, *limits)
    kg = graph_ms(lambda: jacobi_cuda(f, d, n, p0), 20)
    pg = cuda_ms(lambda: jacobi_plain(f, d, n, p0), 3)
    b_ms, b_by = bound(nbytes(f, d, p0) + 4 * d.numel(), flops)
    times["jacobi_p0_slab"] = (kg, pg, b_ms, b_by)
    log(f"time jacobi from p0 at {'x'.join(map(str, d.shape[2:]))} (the "
        f"sharded jacobi-34's round-1 slab), {n} sweeps: route "
        f"{part.route} ({part.blocks} blocks of {part.rows_per_block} "
        f"rows): graph {kg:.5f} ms, plain {pg:.4f} ms; bound {b_ms:.5f} ms "
        f"({b_by})")
    return errs, times


def k1_fused_args(case, m, dt, strength, W):
    """K1's fused forward and backward arguments on a case (u, s, flags)
    at window W, 'Ours' with renormalisation as the bench; the backward's
    fwd_u, fwd_s from the plain forward."""
    from fluidnet_tpu_torch.ops.advect_fast import chebyshev_free_space
    from fluidnet_tpu_torch.ops.cuda import mac_sweep
    free = chebyshev_free_space(case["flags"], W + 1)
    fwd = (case["u"], case["s"], m, None, None, free, -dt, strength, W,
           True, True)
    ref = mac_sweep.sweep_fused_ep_plain(*fwd)
    bwd = (case["u"], case["s"], m, ref["u_w"].contiguous(),
           ref["s_val"].contiguous(), free, dt, strength, W, True, True)
    return fwd, bwd


def k1_tiling(args, fused):
    """The tiled route's grid (ops/cuda/mac_sweep.py::launch_tiling) of a
    K1 call's arguments, advect_sweep_fused_ep's or sweep_cuda's; None on
    the global route."""
    from fluidnet_tpu_torch.ops.cuda import mac_sweep
    W, ours, scalar, renorm = (args[8], args[9], True, args[10]) if fused \
        else args[7:11]
    if mac_sweep.sweep_route(W, args[0].shape) != "tiled":
        return None
    form = (int(args[3] is not None), int(ours), int(renorm and scalar),
            int(scalar), int(fused))
    return mac_sweep.launch_tiling(args[0], W, form)


def bit_exact(out, ref, what, quiet=False):
    """A kernel (K2, K3, K4) against its plain version: logged as max_err
    does (unless `quiet`), and equal to the bit, or it raises."""
    err = max_err(out, ref, what, quiet)
    if not torch.equal(out, ref):
        raise AssertionError(f"{what}: the kernel is not bit-identical to "
                             f"its plain version (max abs err {err})")
    return err


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
        if getattr(state, name) is not None and \
                not torch.isfinite(getattr(state, name)).all():
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

    def record(fields, px, py, pz, window, nearest=False, minmax=False,
               z0=0):
        if z0:
            raise AssertionError(f"K5 at z origin {z0} on the 2-D path")
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
        for z0 in (0, Z_ORIGINS[0]):
            field, (px, py, pz) = warp_3d_case(dev, (1, 1, 37, 45, 61), 1,
                                               2.0, 23)
            pz = pz + z0
            if nearest:
                px, py, pz = (torch.floor(p) + 0.5 for p in (px, py, pz))
            call = (field, px, py, pz, 1, nearest, minmax)
            ref = warp_group_plain(*call, z0=z0)
            out = warp_group(*call, z0=z0)
            torch.cuda.synchronize()
            worst = max(worst, bit_exact(
                out.flatten(1, 2), ref.flatten(1, 2),
                f"K5 3-D nearest={nearest} minmax={minmax} z origin {z0}"))

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
            "free": chebyshev_free_space(flags, 2),
            "free2": chebyshev_free_space(flags, 3)}


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
        # Every form at the recipe's window 1, the 'Ours' renormalised
        # pair also at 2; equal to the bit.
        for W, is_bwd, ours, with_scalar, renorm in (
                (1, False, True, True, True), (1, True, True, True, True),
                (1, False, False, True, False), (1, True, False, True, False),
                (1, False, True, False, False),
                (1, True, False, False, False),
                (2, False, True, True, True), (2, True, True, True, True)):
            free = c["free"] if W == 1 else c["free2"]
            fwd = None
            if is_bwd:
                fwd = mac_sweep.sweep_plain(c["u"], c["s"], c["m"], None,
                                            None, free, -dt, W, ours, True,
                                            renorm)
                fwd_s = fwd[:, 9:10].contiguous() if with_scalar else None
                fwd = fwd[:, 0:3].contiguous()
            args = (c["u"], None if is_bwd else c["s"],
                    c["m"] if with_scalar else None, fwd, fwd_s,
                    free if ours else None, dt if is_bwd else -dt, W,
                    ours, with_scalar, renorm)
            key = "mac_sweep_unfused_" + ("bwd" if is_bwd else "fwd")
            form = (f"K1 unfused {'bwd' if is_bwd else 'fwd'} W={W} "
                    f"ours={ours} scalar={with_scalar} renorm={renorm}")
            for z0 in (0, Z_ORIGINS[0]) if W == 1 else (0,):
                ref = mac_sweep.sweep_plain(*args, z0=z0)
                out = mac_sweep.sweep_cuda(*args, z0=z0)
                torch.cuda.synchronize()
                errs[key] = max(errs[key], bit_exact(
                    out, ref, f"{form} z origin {z0} ({ref.shape[1]} "
                    f"channels)"))
            if W == 1 and ours and with_scalar and renorm:
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
        # The u group's positions at a z origin (a slab's sweep VJP).
        z0 = Z_ORIGINS[0]
        cases.append((f"G=3 F=1 W=1 (u) z origin {z0}", g,
                      mac_sweep.positions_for_vjp(c["u"], c["free"], -dt, 1,
                                                  True, z0=z0), 1, False,
                      z0))
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
        for what, gg, pos, W, nearest, *z0 in cases:
            ref = warp_transpose_plain(gg, *pos, W, nearest, *z0)
            out = warp_transpose_cuda(gg, *pos, W, nearest, *z0)
            torch.cuda.synchronize()
            errs["warp_transpose"] = max(errs["warp_transpose"], max_abs(
                out, ref, f"K6 {what}"))
        calls["warp_transpose"] = (
            warp_transpose_plain, warp_transpose_cuda,
            (g, px, py, pz, 1, False), nbytes(g, px, py, pz, g),
            WARP_T_FLOPS * g.numel(), grid_sample_backward(g, px, py, pz))
        va = (c["u"], c["flags"], amp)
        ref_v = vorticity_confinement_xla(*va)
        errs["vorticity"] = max(errs["vorticity"], bit_exact(
            vorticity_cuda(*va), ref_v, "K4 vorticity confinement"))
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
            # K1 and K4 also replayed from CUDA graphs, the time they
            # report; K1 beside its tiling.
            kg = graph_ms(lambda: kern(*args), 20) if key != \
                "warp_transpose" else None
            b_ms, b_by = bound(nb, flops)
            if b == TRAIN_B:
                times[key] = ((k1 + k2) / 2 if kg is None else kg,
                              (p1 + p2) / 2, b_ms, b_by, lib_ms)
            log(f"time {key} at {at}: "
                + (f"graph {kg:.5f} ms, " if kg is not None else "")
                + f"kernel {k1:.4f} / {k2:.4f} ms, plain "
                f"{p1:.4f} / {p2:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
                f"{nb / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP)"
                + (f"; grid_sample backward {lib_ms:.4f} ms"
                   if lib_ms is not None else "")
                + (f"; tiling {k1_tiling(args, False)._asdict()}"
                   if key.startswith("mac_sweep") else ""))
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
        tee = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            state, _ = train_main(flags + ["-max_epochs", str(epochs),
                                           "-load_model", resume,
                                           "-resume_training", resume])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        prof = [ln for ln in tee.buf.getvalue().splitlines()
                if ln.startswith("==> Model FLOPs/frame @128: ")]
        if len(prof) != 1:
            raise AssertionError(f"train cli: startup profile lines {prof}")
        log(f"train cli: startup profile: {prof[0][4:]}")
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


class Tee(io.TextIOBase):
    """A text stream that writes to `out` and keeps a copy in `buf`."""

    def __init__(self, out):
        super().__init__()
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def loader_phase(dev, root):
    """Phase 19: cli/train.main on the host route against the device cache
    (one epoch each, one loader thread, deterministic cuDNN), then two
    epochs on the host route with 8 threads, the native frame reader
    against load_manta_file, and an epoch longer than the loader's queue.
    Returns (launches, numbers)."""
    from fluidnet_tpu_torch import native
    from fluidnet_tpu_torch.cli import train as train_cli
    from fluidnet_tpu_torch.data import dataset as dataset_mod
    from fluidnet_tpu_torch.ops.cuda import _build

    ds = dataset_mod.FluidDataset(root, "gen3d", "tr")
    n_te = len(dataset_mod.FluidDataset(root, "gen3d", "te"))
    order = np.random.default_rng(int(RECIPE[RECIPE.index("-seed") + 1])) \
        .permutation(len(ds))
    want = [ds.get_batch(order[i:i + TRAIN_B])
            for i in range(0, len(ds), TRAIN_B)]
    set_gb = sum(want[0][k].nbytes for k in ("p_div", "u_div", "flags",
                                             "density")) / TRAIN_B / 1e9 * \
        (len(ds) + n_te)
    flags = RECIPE + ["-data_dir", root, "-dataset", "gen3d", "-model_dir",
                      os.path.join(root, "loader_models"), "-profile",
                      "false", "-load_model", "false"]
    host = ["-device_data_cache_max_gb", str(set_gb / 2)]
    real_step, real_loader, real_feed = (train_cli.train_step,
                                         train_cli.PrefetchLoader,
                                         train_cli.DeviceFeed)
    launches, runs = {}, {}

    class Loader(real_loader):
        """Records each epoch's sample indices and queue waits."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.epochs = []
            run["loaders"].append(self)

        def epoch(self, *a, **k):
            got = []
            for batch, idx in super().epoch(*a, **k):
                got.append(idx)
                yield batch, idx
            self.epochs.append((got, list(self.waits)))

    class Feed(real_feed):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            run["feeds"].append(self)

    def train_step(state, batch, gen, mconf, nf, *a, **k):
        """train_step, its batch kept, its launches checked, timed."""
        run["batches"].append({key: v.clone() for key, v in batch.items()})
        if "init" not in run:
            run["init"] = [p.detach().clone() for p in state.params]
        torch.cuda.synchronize()
        before = dict(_build.launches)
        t0 = time.perf_counter()
        out = real_step(state, batch, gen, mconf, nf, *a, **k)
        torch.cuda.synchronize()
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        got = {key: v - before.get(key, 0)
               for key, v in _build.launches.items()
               if v - before.get(key, 0)}
        if got != train_launches(nf):
            raise AssertionError(f"loader: a train step at n={nf} launched "
                                 f"{got}, expected {train_launches(nf)}")
        run["horizons"].append(nf)
        run["rejected"] += float(out[1]["rejected"])
        return out

    def drive(name, argv):
        nonlocal run
        run = runs[name] = {"loaders": [], "feeds": [], "batches": [],
                            "ms": [], "horizons": [], "rejected": 0.0}
        torch.cuda.synchronize()
        _build.launches.clear()
        tee = Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            state, _ = train_cli.main(flags + argv)
        torch.cuda.synchronize()
        run["s"] = time.perf_counter() - t0
        run["state"] = state
        run["host_route"] = "==> Host route" in tee.buf.getvalue()
        for key, v in _build.launches.items():
            launches[key] = launches.get(key, 0) + v
        log(f"loader {name}: {run['s']:.3f} s, {state.step} steps at "
            f"horizons {run['horizons']}, train step ms "
            f"{[round(v, 3) for v in run['ms']]}")

    run = None
    train_cli.train_step, train_cli.PrefetchLoader, train_cli.DeviceFeed = \
        train_step, Loader, Feed
    torch.backends.cudnn.deterministic = True
    try:
        drive("host_1thread", host + ["-max_epochs", "1", "-num_data_threads",
                                      "1", "-model_filename", "host1"])
        drive("device_cache", ["-max_epochs", "1", "-model_filename",
                               "cache"])
        torch.backends.cudnn.deterministic = False
        drive("host_8threads", host + ["-max_epochs", "2",
                                       "-model_filename", "host8"])
    finally:
        torch.backends.cudnn.deterministic = False
        train_cli.train_step, train_cli.PrefetchLoader, \
            train_cli.DeviceFeed = real_step, real_loader, real_feed

    # (a) the same batches and params on both routes.
    a, b = runs["host_1thread"], runs["device_cache"]
    if not (a["host_route"] and not b["host_route"]):
        raise AssertionError("loader: the runs did not take the routes "
                             "asked for")
    for name, r in (("host_1thread", a), ("device_cache", b)):
        if len(r["batches"]) != len(want):
            raise AssertionError(f"loader {name}: {len(r['batches'])} train "
                                 f"steps, expected {len(want)}")
        for i, (got, ref) in enumerate(zip(r["batches"], want)):
            if name == "host_1thread" and \
                    sorted(got) != sorted(dataset_mod.HOST_KEYS):
                raise AssertionError(f"loader: the host route moved "
                                     f"{sorted(got)}")
            for key, v in got.items():
                if not np.array_equal(v.cpu().numpy(), ref[key]):
                    raise AssertionError(f"loader {name}: batch {i}'s {key} "
                                         "differs from the dataset's")
    if a["horizons"] != b["horizons"]:
        raise AssertionError(f"loader: horizons {a['horizons']} and "
                             f"{b['horizons']}")
    diff = max((x - y).abs().max().item() for x, y in
               zip(a["state"].params, b["state"].params))
    moved = max((x - y).abs().max().item() for x, y in
                zip(a["state"].params, a["init"]))
    # A rejected update leaves the params as they were: params equal
    # because nothing moved would prove nothing.
    if a["rejected"] or not moved > 0:
        raise AssertionError(f"loader: {a['rejected']} updates rejected, "
                             f"params moved {moved}")
    log(f"loader (a): {len(want)} batches equal to the bit to the dataset's "
        f"on both routes; params after the epoch (moved up to {moved:.3e} "
        f"from the initial ones): max abs difference {diff:.3e}")
    if diff != 0:
        raise AssertionError(f"loader: params differ by {diff} between the "
                             "routes")

    # (b) eight threads: every sample once an epoch, finite losses.
    c = runs["host_8threads"]
    tr_loader = c["loaders"][0]
    if tr_loader.num_threads != 8 or len(tr_loader.epochs) != 2:
        raise AssertionError(f"loader: {tr_loader.num_threads} threads, "
                             f"{len(tr_loader.epochs)} epochs")
    for idxs, _ in tr_loader.epochs:
        flat = [int(i) for idx in idxs for i in idx]
        if sorted(flat) != list(range(len(ds))):
            raise AssertionError(f"loader: an epoch delivered {flat}")
    from fluidnet_tpu_torch.utils.logger import read_log
    _, rows = read_log(os.path.join(root, "loader_models", "host8_log.tsv"))
    if len(rows) != 2 or not np.isfinite(rows).all():
        raise AssertionError(f"loader: host route log rows {rows}")
    out = {"set_gb": set_gb, "device_data_cache_max_gb": set_gb / 2,
           "params_max_abs_diff": diff}
    for name, r in runs.items():
        ms = sorted(r["ms"])
        entry = {"train_step_ms": r["ms"], "median_train_step_ms":
                 ms[len(ms) // 2], "horizons": r["horizons"], "s": r["s"]}
        if r["feeds"]:
            feed, ldr = r["feeds"][0], r["loaders"][0]
            st = feed.stats
            waits = [w for _, ws in ldr.epochs for w in ws]
            copy_ms = st["copy_s"] * 1e3 / st["batches"]
            entry.update({
                "threads": ldr.num_threads,
                "wait_ms_per_batch": [w * 1e3 for w in waits],
                "copy_ms_per_batch": copy_ms,
                "copy_mb_s": st["bytes"] / 1e6 / st["copy_s"],
                "mib_per_batch": st["bytes"] / 2**20 / st["batches"],
                "copy_share_of_step": copy_ms /
                entry["median_train_step_ms"]})
            log(f"loader {name}: {ldr.num_threads} threads; wait on the "
                f"loader {[round(w * 1e3, 3) for w in waits]} ms a batch; "
                f"copies {copy_ms:.3f} ms a batch on the main thread "
                f"({entry['mib_per_batch']:.1f} MiB, "
                f"{entry['copy_mb_s']:.1f} MB/s), "
                f"{entry['copy_share_of_step']:.4f} of the median step "
                f"{entry['median_train_step_ms']:.3f} ms")
        out[name] = entry

    # (c) the native library loads; its threaded frame reader (bound, not
    # wired: FluidDataset reads in NumPy) against load_manta_file on the
    # first batch's target and divergent frames.
    if native.get_lib() is None:
        raise AssertionError("loader: the native library is not loaded")
    from fluidnet_tpu_torch.data.manta_io import load_manta_file
    paths = []
    for i in order[:TRAIN_B]:
        rd, fname = ds.samples[i]
        paths += [os.path.join(rd, fname),
                  os.path.join(rd, fname[:-4] + "_divergent.bin")]
    t0 = time.perf_counter()
    got = native.read_manta_frames_native(paths, *ds.shape_zyx, ds.is_3d)
    times = {"native": (time.perf_counter() - t0) * 1e3}
    t0 = time.perf_counter()
    frames = [load_manta_file(f) for f in paths]
    times["numpy"] = (time.perf_counter() - t0) * 1e3
    for key, mine in (("U", "u_div_or_target"), ("p", "p"),
                      ("flags", "flags"), ("density", "density")):
        if not np.array_equal(got[mine], np.concatenate(
                [fr[key] for fr in frames])):
            raise AssertionError(f"loader: the native reader's {mine} "
                                 "differs from load_manta_file's")
    log(f"loader (c): {len(paths)} frames read natively in "
        f"{times['native']:.3f} ms, in NumPy {times['numpy']:.3f} ms; equal")
    out["frame_read_ms"] = times

    # (d) an epoch three times the loader's queue: batch 1 over the
    # training set, 8 threads, through DeviceFeed; every sample once, each
    # batch equal to the bit to get_batch(idx).
    feed = dataset_mod.DeviceFeed(
        dataset_mod.PrefetchLoader(ds, 1, 8, seed=5), dev)
    fed = list(feed.epoch())
    if sorted(int(i) for _, idx in fed for i in idx) != \
            list(range(len(ds))):
        raise AssertionError("loader (d): an epoch did not deliver every "
                             "sample once")
    for batch, idx in fed:
        host = ds.get_batch(idx)
        for key, v in batch.items():
            if not np.array_equal(v.cpu().numpy(), host[key]):
                raise AssertionError(f"loader (d): sample {list(idx)}'s "
                                     f"{key} differs from get_batch's")
    waits = [w * 1e3 for w in feed.loader.waits]
    log(f"loader (d): {len(fed)} batches of 1 (queue of "
        f"{feed.loader.depth}), 8 threads, each equal to get_batch; wait on "
        f"the loader {[round(w, 3) for w in waits]} ms; {feed.report()}")
    out["long_epoch"] = {"batches": len(fed), "wait_ms_per_batch": waits,
                         "copy_ms_per_batch": feed.stats["copy_s"] * 1e3 /
                         len(fed)}

    # The recorders' classes and closures form reference cycles: drop the
    # batches and states they hold now, or the later phases' peak memory
    # would count them.
    for r in runs.values():
        r.clear()
    return launches, out


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


def models_phase(dev, batch):
    """Phase 18: the tog model and the mres + batch norm + skip model on
    the generic stage path at RES^3 with bench.py's knobs, then one tog
    train step at TRAIN_B x TRAIN_RES^3, n = 4."""
    from fluidnet_tpu_torch.models.fluidnet import random_model
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.sim.simulate import rollout
    from fluidnet_tpu_torch.train.train import init_train_state, train_step
    from fluidnet_tpu_torch.utils.checkpoint import load_mconf

    base = load_mconf(BUNDLED).replace(**BENCH_KNOBS)
    launches, out = {}, {}

    def count():
        for k, v in _build.launches.items():
            launches[k] = launches.get(k, 0) + v

    for name, (kw, reps) in MODELS.items():
        mconf = base.replace(**kw)
        model = random_model(mconf, MODEL_SEED, dev)
        what = f"models {name} ({RES}^3)"
        state, bcs = make_plume(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        n = MODEL_WARMUP
        state = rollout(state, mconf, n, model, bcs)
        torch.cuda.synchronize()
        rep_s = []
        for _ in range(reps):
            t0 = time.perf_counter()
            state = rollout(state, mconf, MODEL_STEPS, model, bcs)
            torch.cuda.synchronize()
            rep_s.append(time.perf_counter() - t0)
            n += MODEL_STEPS
        check_launches(dict(_build.launches), n, {"prologue": 1}, what)
        count()
        ms = [s / MODEL_STEPS * 1e3 for s in rep_s]
        if ms:
            log(f"{what}: ms/step of {reps} x {MODEL_STEPS} steps "
                f"{[round(v, 3) for v in ms]}, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        div = final_check(state, what)
        kernels_vs_plain_rollout(state, mconf, model, bcs, what)
        out[name] = {"ms_per_step": ms, "final_div_l2": div, "steps": n}

    mconf = recipe_mconf().replace(**MODELS["tog"][0])
    state = init_train_state(17, mconf, dev)
    for i in range(2):                  # a warm-up step, then the timed one
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        t0 = time.perf_counter()
        state, terms = train_step(state, batch,
                                  torch.Generator().manual_seed(i), mconf, 4)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = dict(_build.launches)
        count()
        if got != train_launches(4):
            raise AssertionError(f"models tog train step: launches {got}, "
                                 f"expected {train_launches(4)}")
    vals = {k: float(v) for k, v in terms.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"models tog train step n=4 at {TRAIN_B}x{TRAIN_RES}^3: {ms:.3f} "
        f"ms, peak memory {peak:.3f} GiB, loss {vals['total']:.6e}, "
        f"grad_norm {vals['grad_norm']:.6e}, launches {got}")
    if not all(np.isfinite(list(vals.values()))):
        raise AssertionError(f"models tog train step: terms {vals}")
    out["tog_train_step"] = {"ms": ms, "peak_gib": peak,
                             "loss": vals["total"],
                             "grad_norm": vals["grad_norm"]}
    return launches, out


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
    native_checks(obj, binvox, vox)
    n_obst = int(((state.flags & 2) > 0).sum().item())
    border = RES ** 3 - (RES - 2) ** 3
    log(f"sim3d scene: {int(vox['data'].sum())} voxels at {VOX_DIM}^3 in "
        f"{time.perf_counter() - t0:.3f} s; {n_obst - border} obstacle "
        f"cells inside the {RES}^3 domain (plus its {border} border cells)")
    if not n_obst > border:
        raise AssertionError("sim3d scene: the obstacle is empty")
    return binvox, state, bcs, n_obst


def native_checks(obj, binvox_path, vox):
    """Phase 19 (c) on phase 16's obstacle: the voxelization's native
    flood fill against the NumPy dilation, and the .binvox read back by the
    native decoder against the NumPy decoder's cells."""
    from fluidnet_tpu_torch import native
    from fluidnet_tpu_torch.io import binvox, voxelize
    if native.get_lib() is None:
        raise AssertionError("native: the library is not loaded")
    surface = voxelize._surface_voxels(*voxelize.load_obj(obj), VOX_DIM)
    filled = voxelize._fill_interior(surface)
    if not np.array_equal(filled, voxelize._fill_interior_dilation(surface)) \
            or not np.array_equal(filled, vox["data"] > 0.5):
        raise AssertionError("native: the flood fill differs from the "
                             "dilation")
    with open(binvox_path, "rb") as f:
        raw = f.read().split(b"data\n", 1)[1]
    n = VOX_DIM ** 3
    cells = native.binvox_decode_native(raw, n)
    if not np.array_equal(cells, binvox._decode_rle_numpy(raw, n)) or \
            not np.array_equal(binvox.load_binvox(binvox_path)["data"],
                               vox["data"]):
        raise AssertionError("native: the binvox decoders differ")
    log(f"native: {int(filled.sum())} solid cells of the {VOX_DIM}^3 "
        f"voxelization by the flood fill, equal to the dilation's; .binvox "
        f"decoded natively ({int(cells.sum())} cells) equal to NumPy's")


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


def exact_phase(dev, model, scene, batch):
    """The exact advection route (advection_window 0) on the sim3d scene:
    16 ConvNet frames (finite, K1 not launched, K2's prologue once a
    step), ms/frame and peak memory; then one exact advect_scalar and one
    advect_vel (maccormackOurs) at 64^3 with 15% obstacles on the card
    against the same calls on the CPU: relative L2 at most 1e-4, and the
    cells off by more than 1e-4 counted; then its training gradient
    (exact_train)."""
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
    train_launches_, train_out = exact_train(dev, batch)
    for k, v in train_launches_.items():
        launches[k] = launches.get(k, 0) + v
    return launches, {"ms_per_frame": ms, "peak_gib": peak,
                      "final_div_l2": div, "card_vs_cpu": vs,
                      "train": train_out}


def exact_train(dev, batch):
    """The exact route's training gradient: m3d_v5's recipe at
    advection_window 0 with float32 convolutions, EXACT_TRAIN_N, on
    phase 10's first sample, the reject guard off. One train_step on the
    card (finite terms and grad_norm; K1 and K6 not launched); loss_fn's
    gradients on the card (deterministic cuDNN) against the same loss_fn
    on the CPU: every parameter's gradient finite and within
    EXACT_GRAD_TOL relative L2 of the CPU's, whose torch.sqrt is not
    correctly rounded (a ray's length may differ by an ulp)."""
    from fluidnet_tpu_torch.ops.cuda import _build
    from fluidnet_tpu_torch.train.train import (draw, init_train_state,
                                                loss_fn, train_step)
    m = recipe_mconf().replace(advection_window=0,
                               conv_compute_dtype="float32",
                               loss_reject_threshold=0.0)
    one = {k: v[:1] for k, v in batch.items()}
    draws = draw(torch.Generator().manual_seed(4), m)._replace(
        b_scale=torch.tensor(2.0), g_scale=torch.tensor(0.0),
        v_amp=torch.tensor(3.0))
    torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    state, terms = train_step(init_train_state(17, m, dev), one, None, m,
                              EXACT_TRAIN_N, draws=draws)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.launches)
    vals = {k: float(v) for k, v in terms.items()}
    if not all(np.isfinite(list(vals.values()))):
        raise AssertionError(f"exact train step: terms {vals}")
    if any(k.startswith(("mac_sweep", "warp")) for k in launches):
        raise AssertionError(f"exact train step: launches {launches}")
    grads = {}
    torch.backends.cudnn.deterministic = True
    try:
        for tag, d in (("card", dev), ("cpu", torch.device("cpu"))):
            net = init_train_state(17, m, d).model
            t1 = time.perf_counter()
            total, _ = loss_fn(net, {k: v.to(d) for k, v in one.items()},
                               None, m, EXACT_TRAIN_N, draws=draws)
            g = torch.autograd.grad(total, [p for _, p in
                                            net.jax_named_parameters()])
            grads[tag] = ([total.detach().cpu()] + [x.cpu() for x in g],
                          (time.perf_counter() - t1) * 1e3)
    finally:
        torch.backends.cudnn.deterministic = False
    names = ["loss"] + [k for k, _ in net.jax_named_parameters()]
    per = {n: rel_l2(a, b) for n, a, b in zip(names, grads["card"][0],
                                               grads["cpu"][0])}
    bad = [n for n, a in zip(names, grads["card"][0])
           if not torch.isfinite(a).all()]
    worst = max(per, key=per.get)
    out = {"n": EXACT_TRAIN_N, "shape": list(one["u_div"].shape),
           "step_ms": step_ms, "launches": launches, "terms": vals,
           "loss_grad_card_ms": grads["card"][1],
           "loss_grad_cpu_ms": grads["cpu"][1],
           "grads_rel_l2_max": per[worst], "grads_worst": worst,
           "limit": EXACT_GRAD_TOL}
    log(f"exact train step (window 0, n = {EXACT_TRAIN_N}, "
        f"{'x'.join(map(str, out['shape']))}, float32): {step_ms:.1f} ms, "
        f"loss {vals['total']:.6e}, grad_norm {vals['grad_norm']:.6e}, "
        f"launches {launches}; loss_fn gradients card vs CPU: worst "
        f"relative L2 {per[worst]:.3e} ({worst}; limit {EXACT_GRAD_TOL}), "
        f"all finite; card {grads['card'][1]:.1f} ms, CPU "
        f"{grads['cpu'][1]:.1f} ms")
    if bad or not per[worst] <= EXACT_GRAD_TOL:
        raise AssertionError(f"exact train gradients: non-finite {bad}; "
                             f"card vs CPU {per}")
    return launches, out


# --- phase 20: the scale-out paths -------------------------------------------


def spawn_backend(world):
    """The backend of a spawn of `world` ranks: NCCL, a card a rank, when
    the machine has a card for every rank; else gloo, the ranks sharing
    the card (every exchange staged through the host)."""
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def rank_transport(rep):
    """A rank report's transport (its runs', where it has runs)."""
    if "transport" in rep:
        return rep["transport"]
    return next(iter(rep["runs"].values()))["transport"]


def spawn_ranks(args, world, what):
    """scripts/torch_parallel_rank.spawn_local in PAR_ROOT: `world` ranks
    under spawn_backend(world), which prints the backend, each rank's card
    and transport. Fails if a rank fails or the spawn runs past
    PAR_TIMEOUT (a failed NCCL spawn fails: it is not retried under
    gloo), or if an NCCL rank is not on a card of its own."""
    backend = spawn_backend(world)
    reports, saved, secs = load_script("torch_parallel_rank").spawn_local(
        args, world, PAR_ROOT, PAR_TIMEOUT, what, backend)
    cards = [r["device"] for r in reports]
    transports = sorted({rank_transport(r) for r in reports})
    log(f"{what}: {world} ranks under {backend}, cards {cards}, transport "
        f"{', '.join(transports)}")
    for rank, r in enumerate(reports):
        if r["backend"] != backend or (backend == "nccl" and (
                r["device"] != f"cuda:{rank}" or
                rank_transport(r) != "nccl")):
            raise AssertionError(f"{what}: rank {rank} ran {r['backend']} "
                                 f"on {r['device']} ({rank_transport(r)}), "
                                 f"expected {backend}"
                                 + (f" on cuda:{rank}" if backend == "nccl"
                                    else ""))
    return reports, saved, secs


def planted_faults(rs, u, d, f, W, dt, method, strength):
    """The gathered shards of the sharded step with each PAR_FAULTS fault
    planted in its exchange (every slab's halos zeros, or its lower and
    upper halos swapped), computed in this process: {fault: (u', density')}
    on the host."""
    from fluidnet_tpu_torch.parallel.advect_sharded import advect_slab
    H, Z = 2 * W + 2, f.shape[2]
    out = {}
    for fault in PAR_FAULTS:
        shards = []
        for rank in range(PAR_SP):
            ext = []
            for t in (u, d, f):
                e = rs.cut_slab(t, PAR_SP, rank, H)
                lo, hi = e[:, :, :H], e[:, :, -H:]
                lo, hi = (torch.zeros_like(lo), torch.zeros_like(hi)) \
                    if fault == "zero_halo" else (hi, lo)
                ext.append(torch.cat([lo, e[:, :, H:-H], hi], dim=2))
            shards.append([x.cpu() for x in advect_slab(
                dt, ext[0], ext[1], ext[2], Z, rank * (Z // PAR_SP) - H,
                method, strength, W)])
        out[fault] = tuple(torch.cat(x, dim=2) for x in zip(*shards))
    return out


def shard_err(a, b):
    """(max |a - b|, the share of cells with |a - b| > PAR_ROUND x max
    |b|), both over max |b|."""
    scale = b.abs().max().clamp_min(1e-30)
    err = (a - b).abs() / scale
    return err.max().item(), (err > PAR_ROUND).double().mean().item()


def parallel_phase(dev, mconf, model, batch):
    """Phase 20: the port's parallel/ in ranks (spawn_backend: NCCL, a
    card a rank, or gloo sharing the card with host-staged exchanges):
    (a) advect_step_z_sharded at PAR_RES^3 over PAR_SP ranks, (b)
    halo_jacobi_solve on the 128^3 plume, (c)
    train_step(group=) on PAR_DP ranks. Returns (the ranks' summed kernel
    launches, the result line's entries)."""
    from fluidnet_tpu_torch.core.celltype import CellType
    from fluidnet_tpu_torch.core.grids import empty_domain
    from fluidnet_tpu_torch.ops.advect_fast import (advect_scalar_fast,
                                                    advect_vel_fast)
    from fluidnet_tpu_torch.ops.divergence import velocity_divergence
    from fluidnet_tpu_torch.sim.simulate import rollout
    from fluidnet_tpu_torch.solvers.cuda_jacobi import (jacobi_cuda,
                                                        jacobi_plain)
    from fluidnet_tpu_torch.train.train import init_train_state, train_step

    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    os.makedirs(PAR_ROOT)
    launches, out = {}, {}

    def count(reports, key):
        """Adds the ranks' launches (the phase's own stay uncounted)."""
        for rep in reports:
            for k, v in rep[key].items():
                launches[k] = launches.get(k, 0) + v

    # (a) + (b): the inputs, the whole-grid and per-slab references.
    shape = (1, 1, PAR_RES, PAR_RES, PAR_RES)
    flags = empty_domain(shape, True, device=dev)
    c = PAR_RES // 2                  # a box across the middle z cut
    flags[..., c - 16:c + 16, c - 28:c + 4, c - 28:c - 4] = \
        int(CellType.TypeObstacle)
    state, bcs = make_plume(dev, PAR_RES, flags)
    state = rollout(state, mconf, PAR_ROLL, model, bcs)
    u, d, f = state.u, state.density, state.flags
    umax = u.abs().max().item()
    # dt per window: the fastest cell moves W + 0.5 cells, past the clip.
    cases = [(W, (W + 0.5) / umax) for W in PAR_WINDOWS]
    method, strength = mconf.advection_method, mconf.maccormack_strength
    jstate, _ = rolled_plume(dev, mconf, model)
    jflags, jdiv = jstate.flags, velocity_divergence(jstate.u, jstate.flags)
    in_path = os.path.join(PAR_ROOT, "sharded.pt")
    torch.save({"u": u.cpu(), "density": d.cpu(), "flags": f.cpu(),
                "cases": cases, "method": method, "strength": strength,
                "jacobi": {"flags": jflags.cpu(), "div": jdiv.cpu(),
                           "n_iter": PAR_JACOBI}}, in_path)
    rs = load_script("torch_parallel_rank")
    refs = {"u": u.cpu()}
    for W, dt in cases:
        whole = (advect_vel_fast(dt, u, f, method, strength, W).cpu(),
                 advect_scalar_fast(dt, d, u, f, method, False, strength,
                                    W).cpu())
        slabs = {p: [[x.cpu() for x in rs.slab_reference(
            dt, u, d, f, PAR_SP, r, method, strength, W, plain=p)]
            for r in range(PAR_SP)] for p in (False, True)}
        refs[W] = (whole, slabs, planted_faults(rs, u, d, f, W, dt, method,
                                                strength))
    j_plain = jacobi_plain(jflags, jdiv, PAR_JACOBI).cpu()
    j_k3 = jacobi_cuda(jflags, jdiv, PAR_JACOBI).cpu()
    k3_ms = cuda_ms(lambda: jacobi_cuda(jflags, jdiv, PAR_JACOBI), PAR_REPS)
    del state, u, d, f, jstate, jflags, jdiv
    torch.cuda.empty_cache()
    log(f"parallel (a) sharded advection: {PAR_RES}^3 plume ({PAR_ROLL} "
        f"ConvNet steps, a box across the middle cut), max |u| {umax:.6f},"
        f" {method}, strength {strength}; (b) halo Jacobi {PAR_JACOBI} "
        f"sweeps on the {RES}^3 plume's divergence; {PAR_SP} ranks on "
        f"{torch.cuda.get_device_name(0)}")
    reports, saved, secs = spawn_ranks(
        ["--case", "sharded", "--inputs", in_path, "--reps",
         str(PAR_REPS)], PAR_SP, "sharded")
    log(f"parallel: {PAR_SP} ranks ran in {secs:.2f} s; transport "
        f"{reports[0]['transport']}; slabs {reports[0]['slab']}")
    H = 2 * cases[0][0] + 2
    for rank, s in enumerate(saved):
        lo, hi = s["halo"]
        want = rs.cut_slab(refs["u"], PAR_SP, rank, H)
        if not (torch.equal(lo, want[:, :, :H]) and
                torch.equal(hi, want[:, :, -H:])):
            raise AssertionError(f"parallel (a): rank {rank}'s exchanged "
                                 f"planes differ from its neighbours'")
    adv = {}

    def within(errs):
        return all(m <= PAR_MAX and f <= PAR_FRAC for m, f in errs.values())

    for W, dt in cases:
        (u_ref, d_ref), slabs, faults = refs[W]
        got_u = torch.cat([s[W][0] for s in saved], dim=2)
        got_d = torch.cat([s[W][1] for s in saved], dim=2)
        errs = {"u": shard_err(got_u, u_ref),
                "density": shard_err(got_d, d_ref)}
        plain_err, plain_same = 0.0, True
        for rank, s in enumerate(saved):
            if not (torch.equal(s[W][0], slabs[False][rank][0]) and
                    torch.equal(s[W][1], slabs[False][rank][1])):
                raise AssertionError(f"parallel (a) W={W}: rank {rank}'s "
                                     f"slab differs from the same slab "
                                     f"advected in one process")
            for got, ref, what in zip(s[W], slabs[True][rank],
                                      ("u", "density")):
                plain_err = max(plain_err, max_err(
                    got, ref, f"parallel (a) W={W} rank {rank} {what} vs "
                    f"plain", quiet=True))
                plain_same = plain_same and torch.equal(got, ref)
        if not within(errs):
            raise AssertionError(f"parallel (a) W={W}: gathered shards vs "
                                 f"the whole grid (max, share over "
                                 f"{PAR_ROUND}) {errs}, limits {PAR_MAX}, "
                                 f"{PAR_FRAC}")
        fault_errs = {k: {"u": shard_err(fu, u_ref),
                          "density": shard_err(fd, d_ref)}
                      for k, (fu, fd) in faults.items()}
        for k, e in fault_errs.items():
            if within(e):
                raise AssertionError(f"parallel (a) W={W}: the planted "
                                     f"fault {k} passes the limits: {e}")
        per = [r["cases"][str(W)] for r in reports]
        for rank, p in enumerate(per):
            if p["launches_per_step"] != PAR_STEP:
                raise AssertionError(f"parallel (a) W={W}: rank {rank} "
                                     f"launched {p['launches_per_step']} a "
                                     f"step, expected {PAR_STEP}")
        step_ms = [float(np.median(p["step_ms"])) for p in per]
        exch_ms = [float(np.median(p["exchange_ms"])) for p in per]
        adv[W] = {"dt": dt, "vs_whole_max_and_share": errs,
                  "bit_equal_to_slabs": True,
                  "vs_plain_slabs_max_abs_err": plain_err,
                  "identical_to_plain_slabs": plain_same,
                  "planted_faults_max_and_share": fault_errs,
                  "identical_to_whole": bool(torch.equal(got_u, u_ref) and
                                             torch.equal(got_d, d_ref)),
                  "launches_per_step": PAR_STEP,
                  "step_ms_per_rank": step_ms,
                  "exchange_ms_per_rank": exch_ms}
        log(f"parallel (a) W={W}, dt {dt:.6f}: slabs equal to the bit to "
            f"one process's; against the plain versions' slabs max abs err "
            f"{plain_err:.3e} (limit {TOL} of the field's max"
            f"{'; bit-identical' if plain_same else ''}); gathered vs whole "
            f"grid, max error over the field's max and the share of cells "
            f"past {PAR_ROUND}: u {errs['u'][0]:.3e}, {errs['u'][1]:.3e}; "
            f"density {errs['density'][0]:.3e}, {errs['density'][1]:.3e} "
            f"(limits {PAR_MAX}, {PAR_FRAC}); planted faults, failing them: "
            + "; ".join(f"{k} u {e['u'][0]:.3e}, {e['u'][1]:.3e}, density "
                        f"{e['density'][0]:.3e}, {e['density'][1]:.3e}"
                        for k, e in fault_errs.items()) + f"; launches a step per rank {PAR_STEP};"
            f" ms a sharded step per rank {[round(v, 3) for v in step_ms]}, "
            f"exchange {[round(v, 3) for v in exch_ms]}")
    got_p = torch.cat([s["jacobi"] for s in saved], dim=2)
    for what, ref in (("jacobi_plain", j_plain), ("K3", j_k3)):
        if not torch.equal(got_p, ref):
            raise AssertionError(f"parallel (b): halo Jacobi differs from "
                                 f"{what} by {(got_p - ref).abs().max()}")
    jac_ms = [float(np.median(r["jacobi"]["ms"])) for r in reports]
    log(f"parallel (b) halo Jacobi {PAR_JACOBI} sweeps at {RES}^3 over "
        f"{PAR_SP} ranks: equal to the bit to jacobi_plain and K3 on the "
        f"whole grid; ms per rank {[round(v, 3) for v in jac_ms]}, K3 "
        f"{k3_ms:.4f} ms")
    for r in reports:
        if r["jacobi"]["launches"]:
            raise AssertionError(f"parallel (b): the halo Jacobi launched "
                                 f"{r['jacobi']['launches']}")
    count(reports, "launches_total")
    out["sharded_advection"] = {"res": PAR_RES, "sp": PAR_SP,
                                "transport": reports[0]["transport"],
                                "windows": adv, "spawn_s": secs,
                                "peak_gib_per_rank": [r["peak_gib"] for r in
                                                      reports]}
    out["halo_jacobi"] = {"res": RES, "sweeps": PAR_JACOBI,
                          "bit_equal_to_plain_and_k3": True,
                          "ms_per_rank": jac_ms, "k3_ms": k3_ms}

    # (c) data-parallel training against one process on the whole batch,
    # the reject guard off so that the update always lands.
    mconf_t = recipe_mconf().replace(loss_reject_threshold=0.0)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        st = init_train_state(17, mconf_t, dev)
        init = [p.detach().to("cpu", copy=True) for p in st.params]
        st, terms = train_step(st, batch,
                               torch.Generator().manual_seed(PAR_GEN_SEED),
                               mconf_t, 4)
        ref_loss = float(terms["total"])
        ref_params = [p.detach().to("cpu", copy=True) for p in st.params]
        moved = max((a - b).abs().max().item()
                    for a, b in zip(ref_params, init))
        if not moved > 0:
            raise AssertionError("parallel (c): the step left the params")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(st, batch, torch.Generator().manual_seed(PAR_GEN_SEED),
                   mconf_t, 4)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        in_path = os.path.join(PAR_ROOT, "train.pt")
        torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                    "mconf": mconf_t, "model_seed": 17,
                    "gen_seed": PAR_GEN_SEED, "n": 4}, in_path)
        reports, saved, secs = spawn_ranks(
            ["--case", "train", "--inputs", in_path], PAR_DP, "train")
    finally:
        torch.backends.cudnn.deterministic = False
    worst = 0.0
    for rank, (r, s) in enumerate(zip(reports, saved)):
        if r["launches"] != train_launches(4):
            raise AssertionError(f"parallel (c): rank {rank} launched "
                                 f"{r['launches']}, expected "
                                 f"{train_launches(4)}")
        loss = s["terms"]["total"]
        if not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss):
            raise AssertionError(f"parallel (c): rank {rank} loss {loss} vs "
                                 f"one process {ref_loss}")
        for i, (a, b) in enumerate(zip(s["params"], ref_params)):
            rel = (torch.linalg.norm(a - b) /
                   torch.linalg.norm(b).clamp_min(1e-30)).item()
            if not rel <= GRAD_TOL:
                raise AssertionError(f"parallel (c): rank {rank} param {i} "
                                     f"relative L2 {rel}")
            worst = max(worst, rel)
    count(reports, "launches_total")
    rank_ms = [r["step_ms"][0] for r in reports]
    log(f"parallel (c) train step n=4, {TRAIN_B}x{TRAIN_RES}^3 over "
        f"{PAR_DP} ranks of {reports[0]['local_batch'][0]} samples "
        f"(transport {reports[0]['transport']}): loss "
        f"{[r['terms']['total'] for r in reports]} vs one process "
        f"{ref_loss} (rtol 1e-5); params worst relative L2 {worst:.3e} "
        f"(limit {GRAD_TOL}; the step moved them up to {moved:.3e}); "
        f"launches per rank {reports[0]['launches']}; ms a step per rank "
        f"{[round(v, 3) for v in rank_ms]}, one process {one_ms:.3f}")
    out["dp_train"] = {"ranks": PAR_DP, "loss": ref_loss,
                       "rank_losses": [r["terms"]["total"] for r in reports],
                       "params_rel_l2_max": worst, "params_moved": moved,
                       "transport": reports[0]["transport"],
                       "step_ms_per_rank": rank_ms, "one_process_ms": one_ms,
                       "spawn_s": secs}
    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    return launches, out


# --- phase 21: the z-sharded rollout ----------------------------------------


def step_err(a, b):
    """(max |a - b|, the share of cells with |a - b| > STEP_ROUND x max
    |b|), both over max |b|."""
    scale = b.abs().max().clamp_min(1e-30)
    err = (a - b).abs() / scale
    return err.max().item(), (err > STEP_ROUND).double().mean().item()


@contextlib.contextmanager
def cg_iterations():
    """Counts the CG iterations of each solve of sim.simulate's PCG step
    while entered, by solvers.cg's dot products (2 before its loop, 3 an
    iteration). Yields the list of counts, one a solve."""
    from fluidnet_tpu_torch.sim import simulate as sim
    from fluidnet_tpu_torch.solvers import cg
    real, real_solve, calls, out = cg._bdot, sim.solve_pcg, [0], []

    def counting(a, b):
        calls[0] += 1
        return real(a, b)

    def solve(*a, **kw):
        before = calls[0]
        p = real_solve(*a, **kw)
        out.append((calls[0] - before - 2) // 3)
        return p
    cg._bdot, sim.solve_pcg = counting, solve
    try:
        yield out
    finally:
        cg._bdot, sim.solve_pcg = real, real_solve


def sharded_step_phase(dev, mconf, model):
    """Phase 21: rollout_z_sharded in STEP_SP ranks (NCCL or gloo, as
    phase 20's), each run of STEP_RUNS against one
    process's rollout with the kernels on the same state, and on every
    rank against the same slab's rollout with the kernels' plain versions
    (equal to the bit). Returns (the ranks' summed kernel launches, the
    result line's entry)."""
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.models.fluidnet import random_model
    from fluidnet_tpu_torch.sim.simulate import rollout
    from fluidnet_tpu_torch.solvers.components import connected_components

    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    os.makedirs(PAR_ROOT)
    rs = load_script("torch_parallel_rank")
    rolled, _ = rolled_plume(dev, mconf, model)
    states = {"rolled": {k: getattr(rolled, k).cpu()
                         for k in ("u", "p", "flags", "density")}}
    del rolled
    runs, refs = [], {}
    for name, run in STEP_RUNS.items():
        m = mconf.replace(conv_compute_dtype=run["dtype"], **run["kw"])
        runs.append({"name": name, "mconf": m, "state": run["state"],
                     "steps": run["steps"], "fault": run["fault"],
                     "model_seed": run["seed"],
                     "drop_density": run["drop_density"],
                     "u_z_add": run["u_z_add"]})
        if run["ref"] != name:
            continue
        state, bcs = rs.plume(states, run["state"], run)
        state = FluidState(**{k: None if getattr(state, k) is None else
                              getattr(state, k).to(dev)
                              for k in ("u", "p", "flags", "density")})
        bcs = None if bcs is None else type(bcs)(**{
            k: None if v is None else v.to(dev) for k, v in vars(bcs).items()})
        net = rec = None
        if m.sim_method == "convnet":
            net = random_model(m, run["seed"], dev) \
                if run["seed"] is not None else model \
                if run["dtype"] == mconf.conv_compute_dtype else \
                retyped_model(model, m, dev)
            rec = rs.InputScale(rs.FirstInput(net))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with cg_iterations() as iters:
            out = rollout(state, m, run["steps"], rec, bcs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        rollout(state, m, run["steps"], net, bcs)
        torch.cuda.synchronize()
        refs[name] = {
            "labels": connected_components(state.flags).cpu()
            if m.sim_method == "pcg" else None,
            "cg_iterations": iters,
            "out": {k: getattr(out, k).cpu() for k in ("u", "p", "density")
                    if getattr(out, k) is not None},
            "div": final_check(out, f"sharded step ({name}), one process"),
            "ms": (time.perf_counter() - t0) / run["steps"] * 1e3,
            "peak_gib": peak,
            "scales": [] if rec is None else [s.cpu() for s in rec.seen],
            "first": None if rec is None else [
                rec.model.seen.cpu(),
                None if rec.model.div is None else rec.model.div.cpu()]}
        del state, bcs, out, net, rec
        torch.cuda.empty_cache()
    for r in runs:
        if STEP_RUNS[r["name"]]["fed"]:
            r["scales"] = refs[STEP_RUNS[r["name"]]["ref"]]["scales"]
    in_path = os.path.join(PAR_ROOT, "step.pt")
    torch.save({"states": states, "runs": runs, "model": BUNDLED}, in_path)
    log(f"sharded step: the bench's plume at {RES}^3 (12 ConvNet steps in), "
        f"{STEP_N} steps a run, and the empty plume at {STEP_BIG}^3, "
        f"{STEP_BIG_N} steps, z-sharded over {STEP_SP} ranks on "
        f"{torch.cuda.get_device_name(0)}")
    reports, saved, secs = spawn_ranks(
        ["--case", "step", "--inputs", in_path, "--reps", str(PAR_REPS)],
        STEP_SP, "step")
    launches, out = {}, {"sp": STEP_SP, "res": RES, "steps": STEP_N,
                         "big_res": STEP_BIG, "big_steps": STEP_BIG_N,
                         "transport": reports[0]["runs"][runs[0]["name"]][
                             "transport"],
                         "spawn_s": secs, "runs": {}}
    for rep in reports:
        for k, v in rep["launches_total"].items():
            launches[k] = launches.get(k, 0) + v
    for name, run in STEP_RUNS.items():
        ref, held, n = refs[run["ref"]], run["held"], run["steps"]
        want = ref["out"]
        got = {k: torch.cat([s[name][k] for s in saved], dim=2)
               for k in want}
        errs = {k: step_err(got[k], want[k]) for k in got}
        # Every rank's own planes through the advection (at the slab's z
        # origin) and K2 are the whole grid's to the bit: the first step's
        # model inputs, and jacobi-34's whole rollout.
        if ref["first"] is not None:
            # Without density the model takes no divergence from K2.
            firsts = [(k, torch.cat([s[name][f"first_{k}"] for s in saved],
                                    dim=2), b)
                      for k, b in zip(("u", "div"), ref["first"])
                      if b is not None]
            bits = [k for k, a, b in firsts if not torch.equal(a, b)]
            bits_what = (f"the first step's model inputs "
                         f"({', '.join(k for k, _, _ in firsts)})")
        elif ref["labels"] is not None:
            # PCG's dot products and component sums add in another order:
            # its labels are the whole grid's to the bit.
            labels = torch.cat([s[name]["labels"] for s in saved], dim=2)
            bits = [] if torch.equal(labels, ref["labels"]) else ["labels"]
            bits_what = "the connected components' labels"
        else:
            bits = [k for k in got if not torch.equal(got[k], want[k])]
            bits_what = f"the {n}-step rollout (u, p, density)"
        if bits:
            raise AssertionError(f"sharded step ({name}): the ranks' own "
                                 f"planes of {bits_what} differ from one "
                                 f"process's in {bits}")
        recs = [r["runs"][name] for r in reports]
        expect = {k: v * n for k, v in run["launches"].items()}
        for rank, r in enumerate(recs):
            if r["launches"] != expect:
                raise AssertionError(f"sharded step ({name}): rank {rank} "
                                     f"launched {r['launches']}, expected "
                                     f"{expect}")
            if not r["plain_equal"]:
                raise AssertionError(f"sharded step ({name}): rank {rank}'s "
                                     f"slab with the kernels differs from "
                                     f"its plain versions' by "
                                     f"{r['plain_max_abs']}")
            if not r.get("halo_equal", True):
                raise AssertionError(f"sharded step ({name}): rank {rank}'s "
                                     f"slab on the per-sweep halo Jacobi "
                                     f"differs from K3's rounds")
            if not r.get("rerun_equal", True):
                raise AssertionError(f"sharded step ({name}): rank {rank}'s "
                                     f"rerun differs from its first run")
            if r.get("cg") != recs[0].get("cg"):
                raise AssertionError(f"sharded step ({name}): the ranks' CG "
                                     f"(iterations, residual) differ: rank "
                                     f"0 {recs[0]['cg']}, rank {rank} "
                                     f"{r['cg']}")
        flags = (states["rolled"]["flags"] if run["state"] == "rolled" else
                 rs.plume({}, run["state"])[0].flags)
        gstate = FluidState(u=got["u"].to(dev), p=got["p"].to(dev),
                            flags=flags.to(dev),
                            density=got["density"].to(dev)
                            if "density" in got else None)
        div = final_check(gstate, f"sharded step ({name}), gathered")
        del gstate
        div_rel = abs(div - ref["div"]) / max(ref["div"], 1e-30)
        within = all(e[0] <= STEP_MAX and e[1] <= STEP_FRAC
                     for e in errs.values())
        div_ok = div_rel <= STEP_DIV_REL
        u_ok = errs["u"][0] <= STEP_PCG_U
        # A rollout's collectives: the flags' exchange and PCG's labelling
        # at its start, then each step's.
        labelling = recs[0].get("label_comms", {})
        per_step = {k: (v - (k == "exchanges") - labelling.get(k, 0)) / n
                    for k, v in recs[0]["comms"].items()}
        res = {"held": held, "max_and_share": errs, "div_l2": div,
               "div_l2_one_process": ref["div"], "div_rel": div_rel,
               "launches_per_rank": recs[0]["launches"],
               "collectives_per_step_rank0": per_step,
               "plain_equal_all_ranks": True,
               "bit_equal_to_one_process": bits_what}
        what = (f"gathered vs one process (max over the field's max, share "
                f"past {STEP_ROUND}): " + ", ".join(
                    f"{k} {e[0]:.3e} {e[1]:.3e}" for k, e in errs.items()) +
                f"; ||div||_2 {div:.6f} vs {ref['div']:.6f}, relative "
                f"{div_rel:.3e}; each rank's slab equal to the bit to its "
                f"plain versions'; every rank's own planes of {bits_what} "
                f"equal to one process's to the bit")
        if held == "limits" and not within:
            raise AssertionError(f"sharded step ({name}): {what}; limits "
                                 f"{STEP_MAX}, {STEP_FRAC}")
        if held == "div" and not div_ok:
            raise AssertionError(f"sharded step ({name}): {what}; limit "
                                 f"{STEP_DIV_REL}")
        if held == "fails_limits" and within:
            raise AssertionError(f"sharded step ({name}): the planted ghost "
                                 f"fault passes the limits: {what}")
        if held == "fails_div" and div_ok:
            raise AssertionError(f"sharded step ({name}): the planted ghost "
                                 f"fault passes the ||div||_2 limit "
                                 f"{STEP_DIV_REL}: {what}")
        if held == "u_limit" and not u_ok:
            raise AssertionError(f"sharded step ({name}): {what}; u limit "
                                 f"{STEP_PCG_U}")
        if held == "fails_u_limit" and u_ok:
            raise AssertionError(f"sharded step ({name}): the planted CG "
                                 f"direction fault passes the u limit "
                                 f"{STEP_PCG_U}: {what}")
        if "cg" in recs[0]:
            its = [c[0] for c in recs[0]["cg"]]
            res.update({
                "cg_iterations_per_step": its,
                "cg_residual_per_step": [c[1] for c in recs[0]["cg"]],
                "one_process_cg_iterations": ref["cg_iterations"],
                "label_sweeps": recs[0]["label_sweeps"],
                "label_ms_per_rank": [r["label_ms"] for r in recs],
                "label_collectives_rank0": labelling})
            what += (f"; CG iterations a step {its} on every rank (one "
                     f"process: {ref['cg_iterations']}), residuals "
                     f"{[f'{c[1]:.3e}' for c in recs[0]['cg']]}; labels in "
                     f"{recs[0]['label_sweeps']} sweeps, ms per rank "
                     f"{rounded(res['label_ms_per_rank'])}, collectives "
                     f"{labelling}")
        if "cg_exchange_ms" in recs[0]:
            ex, ar = ([float(np.median(r[k])) for r in recs]
                      for k in ("cg_exchange_ms", "cg_all_reduce_ms"))
            res.update(rerun_equal_all_ranks=True,
                       cg_collective_ms_per_rank={"exchange": ex,
                                                  "all_reduce": ar})
            what += (f"; each rank's rerun equal to the bit; a CG "
                     f"iteration's collectives alone, ms per rank: an "
                     f"exchange of one plane {rounded(ex)}, an all_reduce "
                     f"of the dots {rounded(ar)}")
        if run["fault"]:
            out["runs"][name] = res
            planted = {"cg_direction": "the CG direction's exchange zeroed",
                       "misaligned": "the trunk one plane off its pooling "
                       "factor's multiples"}.get(
                run["fault"], "ghost planes of step 2's exchange zeroed")
            log(f"sharded step ({name}): {planted}; {what}: fails the "
                f"{held[len('fails_'):].replace('_', ' ')}, as it must")
            continue
        if held == "report":
            zl = got["u"].shape[2] // STEP_SP
            res["own_planes_cells_differing_per_rank"] = {
                k: [int((got[k][:, :, r * zl:(r + 1) * zl] !=
                         want[k][:, :, r * zl:(r + 1) * zl]).sum())
                    for r in range(STEP_SP)] for k in got}
            res["own_planes_cells"] = got["p"][:, :, :zl].numel()
            one = ref["scales"][0].flatten()
            res["first_scale"] = {
                "one_process": one.tolist(),
                "ranks": [r["scales"][0] for r in recs],
                "max_rel_diff": max(
                    (torch.tensor(r["scales"][0]) - one).abs().max().item() /
                    one.abs().max().item() for r in recs)}
            what += (f"; each rank's own planes: cells differing "
                     f"{res['own_planes_cells_differing_per_rank']} of "
                     f"{res['own_planes_cells']} a field; first input "
                     f"scale relative to one process's "
                     f"{res['first_scale']['max_rel_diff']:.3e}"
                     f"{' (fed)' if run['fed'] else ''}")
        step_ms = [r["step_ms"][0] for r in recs]
        exch_ms = [float(np.median(r["exchange_ms"])) for r in recs]
        if run["kw"].get("advection_window", 1) == 0:
            res.update(ghost_per_step=recs[0]["ghost_per_step"],
                       ranks_reached_a_side_per_step=recs[0][
                           "hops_per_step"])
            what += (f"; the ghost zone a step {recs[0]['ghost_per_step']} "
                     f"planes, from {recs[0]['hops_per_step']} ranks a "
                     f"side")
        res.update({
            "slab": recs[0]["slab"], "ghost": recs[0]["ghost"],
            "exchange_mib_each_way": recs[0]["exchange_mib"],
            "step_ms_per_rank": step_ms, "exchange_ms_per_rank": exch_ms,
            "one_process_step_ms": ref["ms"],
            "step_ratio": max(step_ms) / ref["ms"],
            "peak_gib_per_rank": [r["peak_gib"] for r in recs],
            "one_process_peak_gib": ref["peak_gib"]})
        if "halo_step_ms" in recs[0]:
            res["halo_step_ms_per_rank"] = [r["halo_step_ms"][0]
                                            for r in recs]
            res["halo_collectives_per_step_rank0"] = {
                k: (v - (k == "exchanges")) / n
                for k, v in recs[0]["halo_comms"].items()}
            what += (f"; on the per-sweep halo Jacobi (same bits): ms a step "
                     f"per rank {rounded(res['halo_step_ms_per_rank'])}, "
                     f"collectives a step "
                     f"{res['halo_collectives_per_step_rank0']}")
        what += f"; collectives a step {per_step}"
        out["runs"][name] = res
        log(f"sharded step ({name}, held: {held}): slab {recs[0]['slab']}, "
            f"ghost {recs[0]['ghost']} planes "
            f"({recs[0]['exchange_mib']:.3f} MiB each way); {what}; "
            f"launches a rank {recs[0]['launches']} in {n} steps; ms a step "
            f"per rank {[round(v, 3) for v in step_ms]}, one process "
            f"{ref['ms']:.3f}; exchange {[round(v, 3) for v in exch_ms]}; "
            f"peak GiB per rank {rounded(res['peak_gib_per_rank'])}, one "
            f"process {ref['peak_gib']:.3f}")
    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    return launches, out


# --- phase 22: sp-sharded training -----------------------------------------


def rounded(values):
    return [round(v, 3) for v in values]


def rel_l2(a, b):
    return (torch.linalg.norm((a - b).double()) /
            torch.linalg.norm(b.double()).clamp_min(1e-30)).item()


def sharded_train_phase(dev, mconf, model, batch):
    """Phase 22: train_step(mesh=) in SPT_WORLD ranks (NCCL or gloo, as
    phase 20's), each run of SPT_RUNS against one
    process's loss_fn gradients and train_step on the whole batch, and on
    every rank against its rerun with the kernels' plain versions (equal
    to the bit). Returns (the ranks' summed kernel launches, the result
    line's entry)."""
    from fluidnet_tpu_torch.parallel.train_sharded import model_ghost
    from fluidnet_tpu_torch.train.train import (_data_augmentation, draw,
                                                init_train_state, loss_fn,
                                                train_step)

    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    os.makedirs(PAR_ROOT)
    rolled, _ = rolled_plume(dev, mconf, model)
    later = rolled_plume(dev, mconf, model, 24)[0]
    big = {"u_div": torch.cat([rolled.u, later.u]),
           "p_div": torch.cat([rolled.p, later.p]),
           "flags": torch.cat([rolled.flags, later.flags]),
           "density": torch.cat([rolled.density, later.density])}
    big = {k: v[:SPT_BIG_B] for k, v in big.items()}
    del rolled, later
    batches = {"train": batch, "big": big,
               "one": {k: v[:1] for k, v in batch.items()},
               "targets": dict(batch, p_target=torch.zeros_like(
                   batch["p_div"]), u_target=torch.zeros_like(
                   batch["u_div"]))}
    base = recipe_mconf().replace(loss_reject_threshold=0.0)
    draws = draw(torch.Generator().manual_seed(SPT_GEN_SEED), base)._replace(
        b_scale=torch.tensor(2.0), g_scale=torch.tensor(0.0),
        v_amp=torch.tensor(3.0))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    refs, runs = {}, []
    try:
        for name, run in SPT_RUNS.items():
            m = base.replace(conv_compute_dtype=run["dtype"],
                             **run.get("kw", {}))
            runs.append({"name": name, "mesh": run["mesh"], "mconf": m,
                         "batch": run["batch"], "fault": run.get("fault"),
                         "n": spt_n(run)})
            key = spt_ref_key(run)
            if key in refs:
                continue
            b = batches[run["batch"]]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            net = init_train_state(SPT_SEED, m, dev).model
            with bias_cotangents(net) as cots:
                total, terms = loss_fn(net, b, None, m, spt_n(run),
                                       draws=draws)
                grads = torch.autograd.grad(total, [
                    p for _, p in net.jax_named_parameters()])
            st = init_train_state(SPT_SEED, m, dev)
            ms = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = train_step(st, b, None, m, spt_n(run), draws=draws)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            refs[key] = {
                "terms": {k: float(v.detach()) for k, v in terms.items()},
                "grads": [g.cpu() for g in grads],
                "params": [p.detach().cpu() for p in st.params],
                "names": [k for k, _ in net.jax_named_parameters()],
                "ms": ms[-1], "peak_gib":
                    torch.cuda.max_memory_allocated() / 2**30,
                # 0/0 is a channel the ReLUs cut off: no gradient.
                "cancel": {k: (v["abs"] / v["sum"].abs()).nan_to_num(
                    nan=0.0, posinf=float("inf")).max().item()
                           for k, v in cots.items()}}
            if m.augment_without_targets:
                with torch.no_grad():
                    refs[key]["aug_u"] = _data_augmentation(
                        b["u_div"], b["flags"], b["density"], m,
                        draws).cpu()
            del net, grads, st
    finally:
        torch.backends.cudnn.deterministic = False
    in_path = os.path.join(PAR_ROOT, "train_sp.pt")
    torch.save({"batches": {k: {f: v.cpu() for f, v in b.items()}
                            for k, b in batches.items()},
                "runs": runs, "draws": draws, "n": SPT_N,
                "model_seed": SPT_SEED}, in_path)
    del big, batches
    torch.cuda.empty_cache()
    # A spawn a world size: every run's mesh holds every rank of its spawn.
    spawns = {}
    for world in sorted({a * b for a, b in (r["mesh"] for r in runs)},
                        reverse=True):
        log(f"sharded train: m3d_v5's recipe, n = {SPT_N}, {TRAIN_B}x"
            f"{TRAIN_RES}^3 and {SPT_BIG_B}x{SPT_BIG}^3, {world} ranks on "
            f"{torch.cuda.get_device_name(0)}")
        spawns[world] = spawn_ranks(
            ["--case", "train_sp", "--inputs", in_path, "--reps",
             str(PAR_REPS)], world, f"train_sp{world}")
    launches, out = {}, {"world": SPT_WORLD, "n": SPT_N,
                         "transport": spawns[SPT_WORLD][0][0]["runs"][
                             runs[0]["name"]]["transport"],
                         "spawn_s": {w: v[2] for w, v in spawns.items()},
                         "runs": {}}
    for reports, _, _ in spawns.values():
        for rep in reports:
            for k, v in rep["launches_total"].items():
                launches[k] = launches.get(k, 0) + v
    failed = []
    for name, run in SPT_RUNS.items():
        reports, saved, _ = spawns[run["mesh"][0] * run["mesh"][1]]
        ref = refs[spt_ref_key(run)]
        lim = run["limits"]
        want_launches = dict(train_launches(
            spt_n(run), run.get("kw", {}).get("advection_window", 1) == 0))
        kw = run.get("kw", {})
        if kw.get("augment_without_targets") or \
                kw.get("train_target_source", "manta") != "manta":
            # The augmentation: K4 once a step.
            want_launches["vorticity"] = 1
        recs = [r["runs"][name] for r in reports]
        worst = {"terms": 0.0, "grads": 0.0, "params": 0.0, "fault": 0.0}
        for rank, (r, s) in enumerate(zip(recs, saved)):
            if r["launches"] != want_launches:
                raise AssertionError(f"sharded train ({name}): rank {rank} "
                                     f"launched {r['launches']}, expected "
                                     f"{want_launches}")
            if not r["plain_equal"]:
                raise AssertionError(f"sharded train ({name}): rank {rank}'s "
                                     f"gradients with the kernels differ "
                                     f"from its plain versions' by "
                                     f"{r['plain_max_abs']}")
            for k, v in ref["terms"].items():
                err = abs(r["terms"][k] - v) / max(abs(v), 1e-30)
                worst["terms"] = max(worst["terms"], err if v else
                                     abs(r["terms"][k]))
            s = s[name]
            if s["aug_u"] is not None:
                # The augmented u the first model call got: the whole
                # batch's, on this rank's samples and grown planes.
                n_dp, n_sp = run["mesh"]
                B, Z = ref["aug_u"].shape[0] // n_dp, ref["aug_u"].shape[2]
                zl, gm = Z // n_sp, model_ghost(next(
                    x["mconf"] for x in runs if x["name"] == name))
                z0, b0 = (rank % n_sp) * zl, (rank // n_sp) * B
                want = ref["aug_u"][b0:b0 + B, :, max(z0 - gm, 0):
                                    min(z0 + zl + gm, Z)]
                if not torch.equal(s["aug_u"], want):
                    raise AssertionError(
                        f"sharded train ({name}): rank {rank}'s augmented "
                        f"u differs from the whole batch's by "
                        f"{(s['aug_u'] - want).abs().max().item()}")
                worst["aug_u_equal"] = True
            per = [rel_l2(a, b) for a, b in zip(s["grads"], ref["grads"])]
            if max(per) >= worst["grads"]:
                worst["grads_param"] = ref["names"][int(np.argmax(per))]
                worst["grads_all_params"] = rel_l2(
                    torch.cat([g.flatten() for g in s["grads"]]),
                    torch.cat([g.flatten() for g in ref["grads"]]))
            worst["grads"] = max(worst["grads"], max(per))
            worst["params"] = max(worst["params"], max(
                rel_l2(a, b) for a, b in zip(s["params"], ref["params"])))
            worst["fault"] = max(worst["fault"], max(
                rel_l2(a, b) for a, b in zip(s["fault"], ref["grads"])))
        cancel = ref["cancel"].get(worst["grads_param"])
        res = {"mesh": run["mesh"], "dtype": run["dtype"],
               "slab": recs[0]["slab"], "ghost": recs[0]["ghost"],
               "limits": lim, "terms_rel_max": worst["terms"],
               "grads_rel_l2_max": worst["grads"],
               "grads_worst_param": worst["grads_param"],
               "worst_param_cancellation": cancel,
               "augmented_u_equal_all_ranks": worst.get("aug_u_equal"),
               "grads_rel_l2_all_params": worst["grads_all_params"],
               "params_rel_l2_max": worst["params"],
               "fault_grads_rel_l2_max": worst["fault"],
               "fault_margin": worst["fault"] / lim["rel_l2"],
               "terms": recs[0]["terms"], "one_process_terms": ref["terms"],
               "launches_per_rank": recs[0]["launches"],
               "comms_per_rank": recs[0]["comms"],
               "plain_equal_all_ranks": True,
               "step_ms_per_rank": [r["step_ms"][-1] for r in recs],
               "first_step_ms_per_rank": [r["step_ms"][0] for r in recs],
               "one_process_step_ms": ref["ms"],
               "exchange_ms_per_rank": [float(np.median(r["exchange_ms"]))
                                        for r in recs],
               "adjoint_ms_per_rank": [float(np.median(r["adjoint_ms"]))
                                       for r in recs],
               "exchange_mib_each_way": recs[0]["exchange_mib"],
               "peak_gib_per_rank": [r["peak_gib"] for r in recs],
               "one_process_peak_gib": ref["peak_gib"]}
        out["runs"][name] = res
        aug_note = ("each rank's augmented u equal to the bit to the whole "
                    "batch's; " if worst.get("aug_u_equal") else "")
        log(f"sharded train ({name}): mesh dp x sp {run['mesh']}, "
            f"{run['dtype']}, slab {res['slab']} + {res['ghost']} ghost "
            f"planes ({res['exchange_mib_each_way']:.3f} MiB each way); vs "
            f"one process: loss terms worst relative {worst['terms']:.3e} "
            f"(limit {lim['rtol']}), gradients worst relative L2 "
            f"{worst['grads']:.3e} ({worst['grads_param']}; all parameters "
            f"{worst['grads_all_params']:.3e}"
            + ("" if cancel is None else
               f"; one process's gradient of {worst['grads_param']} "
               f"cancels: sum of |terms| / |sum| up to {cancel:.3e}, x "
               f"float32's eps {cancel * 2.0 ** -24:.3e}")
            + f"), params after 2 steps "
            f"{worst['params']:.3e}"
            f" (limit {lim['rel_l2']}); planted fault's gradients "
            f"{worst['fault']:.3e} (must fail; {res['fault_margin']:.3f}x "
            f"the limit); {aug_note}each rank's gradients equal "
            f"to the bit to its plain versions'; launches a rank "
            f"{recs[0]['launches']}; collectives a rank {recs[0]['comms']}; "
            f"ms a step per rank {rounded(res['step_ms_per_rank'])} (first "
            f"{rounded(res['first_step_ms_per_rank'])}), one process "
            f"{ref['ms']:.3f}; exchange "
            f"{rounded(res['exchange_ms_per_rank'])}, adjoint "
            f"{rounded(res['adjoint_ms_per_rank'])}; peak GiB per rank "
            f"{rounded(res['peak_gib_per_rank'])}, one process "
            f"{ref['peak_gib']:.3f}")
        if worst["terms"] > lim["rtol"] or worst["grads"] > lim["rel_l2"] \
                or worst["params"] > lim["rel_l2"]:
            failed.append(f"{name}: past its limits {lim}: {worst}")
        if not worst["fault"] > lim["rel_l2"]:
            failed.append(f"{name}: the planted fault "
                          f"({run.get('fault', 'dropped adjoint')}) passes "
                          f"the limit {lim['rel_l2']}: {worst['fault']}")
    if failed:
        raise AssertionError("sharded train: " + "; ".join(failed))
    shutil.rmtree(PAR_ROOT, ignore_errors=True)
    return launches, out


@contextlib.contextmanager
def bias_cotangents(net):
    """While entered, every float32 convolution of net's fast trunk keeps
    the sums over its cells (and samples) of its output's cotangent, and
    of that cotangent's magnitude, per channel and by its bias's name:
    the bias's gradient, and how much the sum that forms it cancels
    (sum |terms| / |sum|: float32 rounding of a reordered sum moves the
    gradient by up to about that times 2^-24 of itself)."""
    import torch.nn.functional as F
    names = {id(p): n[:-1] + "b" for n, p in net.jax_named_parameters()
             if n.endswith("/w")}
    sums, real = {}, F.conv3d

    def conv3d(x, weight, *a, **kw):
        out = real(x, weight, *a, **kw)
        name = names.get(id(weight))
        if name is not None and out.requires_grad and \
                out.dtype == torch.float32:
            def keep(g):
                acc = sums.setdefault(name, {"abs": 0.0, "sum": 0.0})
                acc["abs"] = acc["abs"] + g.abs().sum((0, 2, 3, 4))
                acc["sum"] = acc["sum"] + g.sum((0, 2, 3, 4))
            out.register_hook(keep)
        return out
    F.conv3d = conv3d
    try:
        yield sums
    finally:
        F.conv3d = real


def spt_ref_key(run):
    """The one-process reference a phase 22 run is held against: its
    dtype, batch and mconf changes."""
    return (run["dtype"], run["batch"],
            tuple(sorted(run.get("kw", {}).items())), spt_n(run))


def spt_n(run):
    """A phase 22 run's unroll horizon."""
    return run.get("n", SPT_N)


def retyped_model(model, mconf, dev):
    """A FluidNet of `mconf` (another conv dtype) holding model's
    weights."""
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    net = FluidNet(mconf, device=dev)
    net.load_state_dict(model.state_dict())
    return net


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
    from fluidnet_tpu_torch import native
    t0 = time.perf_counter()
    native.build_native(force=True)
    if native.get_lib() is None:
        raise AssertionError("build: the native host library did not load")
    log(f"build: g++ native host library, {time.perf_counter() - t0:.2f} s "
        f"-> {os.path.relpath(native.LIB_PATH)}")

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
        loader_launches, loader_out = loader_phase(dev, TRAIN_ROOT)
        batch = train_batch(dev, TRAIN_ROOT)
        stats_means = stats_phase(TRAIN_ROOT)
    finally:
        shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    step_launches, per_n = train_steps_phase(dev, batch)
    grad_rel = train_grad_phase(dev, batch)
    model_launches, model_out = models_phase(dev, batch)
    par_launches, par_out = parallel_phase(dev, mconf, model, batch)
    t0 = time.perf_counter()
    shard_launches, step_out = sharded_step_phase(dev, mconf, model)
    step_out["phase_s"] = time.perf_counter() - t0
    step_out["k3_from_p0_at_slab"] = dict(zip(
        ("ms", "plain_ms", "bound_ms", "bound_by"), times["jacobi_p0_slab"]),
        shape=list(JACOBI_SLAB), sweeps=32)
    t0 = time.perf_counter()
    spt_launches, spt_out = sharded_train_phase(dev, mconf, model, batch)
    spt_out["phase_s"] = time.perf_counter() - t0
    log(f"phases 21-22: {step_out['phase_s']:.1f} s and "
        f"{spt_out['phase_s']:.1f} s")

    shutil.rmtree(SIM3D_ROOT, ignore_errors=True)
    try:
        sim3d_launches, sim3d_out, scene = sim3d_phase(dev, model)
        exact_launches, exact_out = exact_phase(dev, model, scene, batch)
    finally:
        shutil.rmtree(SIM3D_ROOT, ignore_errors=True)

    total = dict(launches)
    for per in list(cert_launches.values()) + [serve_launches,
                                               cert2_launches, cli_launches,
                                               step_launches, probe_launches,
                                               sim3d_launches,
                                               exact_launches,
                                               model_launches,
                                               loader_launches,
                                               par_launches,
                                               shard_launches,
                                               spt_launches]:
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
    log(json.dumps({"loader": loader_out}))
    log(json.dumps({"models": {"res": RES, "train_shape": [
        TRAIN_B, TRAIN_RES, TRAIN_RES, TRAIN_RES], **model_out}}))
    log(json.dumps({"parallel": par_out}))
    log(json.dumps({"sharded_step": step_out}))
    log(json.dumps({"sharded_train": spt_out}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
