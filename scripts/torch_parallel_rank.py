#!/usr/bin/env python3
"""One rank of the port's scale-out paths (fluidnet_tpu_torch/parallel/),
started by torchrun or by chip_smoke.py's phase 20 with torchrun's
variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_WORLD_SIZE):

    torchrun --nproc_per_node N scripts/torch_parallel_rank.py \\
        --case sharded|train|step|train_sp|jacobi --inputs <in.pt> \
        --out <dir> [--backend nccl]

  --case sharded: the inputs hold a global state (u, density, flags) and
      the advection cases [(window, dt)]. On a 1 x WORLD_SIZE ('dp', 'sp')
      mesh each rank takes its z-slab and runs advect_step_z_sharded
      (K1's unfused sweeps, K5) once with its launches counted, then
      --reps timed steps and --reps timed exchanges of the step's halos;
      then halo_jacobi_solve on the inputs' jacobi flags and div.
  --case train: the inputs hold a host batch, the mconf, the model and
      generator seeds and the horizon. On make_global_mesh(n_dp =
      LOCAL_WORLD_SIZE) each rank takes its samples (shard_host_batch) and
      runs train_step(group=) twice, deterministic cuDNN; the first step's
      terms, params and launches are kept, the second is timed.
  --case step: the inputs hold global plume states and the runs [{name,
      mconf, state, steps, fault, scales}] (`state`: a key of the inputs'
      states, or a resolution for the empty plume from zeros; `scales`,
      optional: the whole grid's input scale of each step, fed to the
      model in place of the slab's). On a 1 x WORLD_SIZE mesh each rank
      takes its slab of the state and its plume BC masks (shard_state,
      shard_bcs) and runs rollout_z_sharded with the bundled model
      (mconf's conv dtype; none for jacobi) once with its launches and
      collectives counted (`fault`: "ghosts" plants zeroed_ghosts,
      "cg_direction" zeroed_d_ghosts), once with every kernel's plain
      version (use_kernels=False) on the same slab, its difference to the
      first reported, then once more timed, and --reps timed exchanges of
      the step's fields. A jacobi-n run is also rerun and timed on the
      per-sweep halo Jacobi (`halo_solve`), which must give the same bits.
      A PCG run keeps each step's CG iteration count and residual
      (`cg_solves`), its slab's labels (connected_components_z_sharded,
      timed, its sweeps and collectives kept), times its rerun with the
      kernels, which must give the same bits, and --reps of a CG
      iteration's collectives alone (an exchange of one plane, an
      all_reduce of two per-sample dots).
  --case train_sp: the inputs hold host batches, the draws, the model
      seed, the horizon n and the runs [{name, mesh (n_dp, n_sp), mconf,
      batch}]. On each run's mesh each rank takes its part of the batch
      (shard_batch: samples over 'dp', z over 'sp'), deterministic cuDNN,
      and runs the sharded loss (parallel/train_sharded.py) with its
      gradients: once with its launches and collectives counted, once
      with every kernel's plain version (the gradients must be the same
      bits), once with the exchanges' adjoint dropping the ghost planes'
      cotangents (`dropped_adjoint`, the planted fault; a run with
      `fault` "cg_direction" plants zeroed_d_ghosts instead); each reduced
      over the mesh as train_step(mesh=) reduces them. Then two timed
      train_step(mesh=) and --reps timed forward and adjoint exchanges of
      a step's fields. With augment_without_targets, the u the first
      model call gets (the augmented slab grown by model_ghost) is kept.
  --case jacobi: the inputs hold a global flags and div and the sweep
      counts n_iters. On a 1 x WORLD_SIZE mesh each rank takes its slabs
      and runs slab_jacobi_solve for each n with its launches and
      exchanges counted, then with K3's plain version (use_kernels=False),
      then --reps timed solves of it and of halo_jacobi_solve.

Each rank writes rank<r>.pt (its slabs, the halo planes its first
exchange received, or its params) and rank<r>.json (its transport,
launches a step, all its launches, times) under --out. gloo on the card
stages each exchange through the host and lets several ranks share one
card; NCCL needs a card a rank. Failures raise: the exit code is then not
0. `spawn_local` starts the ranks of one host without torchrun (what
chip_smoke.py's phase 20 and tests/test_torch_cuda.py do);
`slab_reference` computes a rank's slab in one process, the reference
those and tests/test_torch_parallel.py hold the ranks against.
"""

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fluidnet_tpu_torch.ops.cuda import _build  # noqa: E402
from fluidnet_tpu_torch.parallel.mesh import (  # noqa: E402
    data_parallel_group, local_part, make_mesh, mesh_device,
    spatial_sharding, transport)
from fluidnet_tpu_torch.parallel.multihost import (  # noqa: E402
    init_multihost, make_global_mesh, shard_host_batch)


def cut_slab(x, n, rank, h):
    """Rank `rank`'s (of n along z) slab of the whole-grid tensor x with
    h planes of each neighbour, zeros past the grid's ends: what the
    exchange extends that rank's slab to."""
    zl = x.shape[2] // n
    pad = torch.nn.functional.pad(x, [0, 0, 0, 0, h, h])
    return pad[:, :, rank * zl:rank * zl + zl + 2 * h].contiguous()


def slab_reference(dt, u, d, f, n, rank, method, strength, window,
                   plain=False):
    """What advect_step_z_sharded gives rank `rank` of n on the whole
    grid (u, d, f), computed in this process: the rank's halo-extended
    slab cut from the grid and advected by advect_sharded.advect_slab
    (`plain=True`: the kernels' plain versions). (u', density')."""
    from fluidnet_tpu_torch.parallel.advect_sharded import advect_slab
    H = 2 * int(window) + 2
    Z = f.shape[2]
    ue, de, fe = (cut_slab(t, n, rank, H) for t in (u, d, f))
    return advect_slab(dt, ue, de, fe, Z, rank * (Z // n) - H, method,
                       strength, window, plain=plain)


@contextlib.contextmanager
def zeroed_ghosts(at_call, rank):
    """Plants the fault the sharded step's checks must catch: the ghost
    planes that call `at_call` of simulate_sharded.exchange_ghost returns
    (call 0 extends the flags and BC masks at a rollout's start, then one
    a step) are zeroed on rank `rank` of the 'sp' group."""
    from fluidnet_tpu_torch.parallel import simulate_sharded as ss
    real, calls = ss.exchange_ghost, []

    def faulty(xs, g, group):
        ext = real(xs, g, group)
        calls.append(g)
        if len(calls) - 1 != at_call:
            return ext
        lo = g * (rank > 0)
        return [torch.cat([torch.zeros_like(e[:, :, :lo]),
                           e[:, :, lo:lo + x.shape[2]],
                           torch.zeros_like(e[:, :, lo + x.shape[2]:])],
                          dim=2) for e, x in zip(ext, xs)]
    ss.exchange_ghost = faulty
    try:
        yield
    finally:
        ss.exchange_ghost = real


@contextlib.contextmanager
def zeroed_d_ghosts():
    """Plants the fault the sharded PCG's checks must catch: every
    floating-point exchange of parallel/pcg_sharded.py (the CG direction
    d, one plane a CG iteration) returns zeros in place of the
    neighbours' planes, so each slab's apply_A sees p = 0 across the
    cuts. The labels' and the flags' exchanges (int32) are left alone."""
    from fluidnet_tpu_torch.parallel import pcg_sharded as ps
    real = ps.exchange_ghost

    def faulty(xs, g, group):
        ext = real(xs, g, group)
        if not xs[0].is_floating_point():
            return ext
        lo = g * (dist.get_rank(group) > 0)
        return [torch.cat([torch.zeros_like(e[:, :, :lo]),
                           e[:, :, lo:lo + x.shape[2]],
                           torch.zeros_like(e[:, :, lo + x.shape[2]:])],
                          dim=2) for e, x in zip(ext, xs)]
    ps.exchange_ghost = faulty
    try:
        yield
    finally:
        ps.exchange_ghost = real


@contextlib.contextmanager
def cg_solves():
    """Keeps (CG iterations, residual) of every sharded PCG solve of
    parallel/simulate_sharded.py's step while entered. Yields the list."""
    from fluidnet_tpu_torch.parallel import simulate_sharded as ss
    real, out = ss.solve_pcg_z_sharded, []

    def kept(*a, **kw):
        p, res, it = real(*a, **kw)
        out.append((it, res.item()))
        return p, res, it
    ss.solve_pcg_z_sharded = kept
    try:
        yield out
    finally:
        ss.solve_pcg_z_sharded = real


def planted(fault, rank):
    """The context of a run's planted fault: none (False or None),
    zeroed_ghosts of step 2's exchange (True or "ghosts") or
    zeroed_d_ghosts ("cg_direction")."""
    if not fault:
        return contextlib.nullcontext()
    if fault == "cg_direction":
        return zeroed_d_ghosts()
    return zeroed_ghosts(2, rank)


@contextlib.contextmanager
def halo_solve():
    """Runs the sharded jacobi-n step on the per-sweep halo Jacobi (plain
    PyTorch, one exchange a sweep) in place of slab_jacobi_solve's rounds
    on K3, so that one call can time both steps."""
    from fluidnet_tpu_torch.parallel import simulate_sharded as ss
    from fluidnet_tpu_torch.parallel.halo import halo_jacobi_solve
    real = ss.slab_jacobi_solve

    def old(flags_l, div_l, mesh, n_iter, use_kernels=True, flags_ext=None):
        return halo_jacobi_solve(flags_l, div_l, mesh, n_iter)
    ss.slab_jacobi_solve = old
    try:
        yield
    finally:
        ss.slab_jacobi_solve = real


@contextlib.contextmanager
def dropped_adjoint():
    """Plants the fault the sharded training's checks must catch: the
    exchanges' adjoint drops the cotangents of the ghost planes (no rank
    sends them, so no rank's own planes get them)."""
    from fluidnet_tpu_torch.parallel import halo
    real = halo.planes_adjoint

    def dropped(shapes, grads, h, group, like):
        return [torch.zeros(s, dtype=like.dtype, device=like.device)
                for s in shapes]
    halo.planes_adjoint = dropped
    try:
        yield
    finally:
        halo.planes_adjoint = real


class FirstInput(torch.nn.Module):
    """`model`, keeping in `seen` the u it is given at its first call and
    in `div` the divergence it is handed then (K2's, on a ConvNet step),
    if any."""

    def __init__(self, model):
        super().__init__()
        self.model, self.seen, self.div = model, None, None

    def forward(self, p, u, flags, **kw):
        if self.seen is None:
            self.seen = u.detach().clone()
            div = kw.get("precomputed_div")
            self.div = None if div is None else div.detach().clone()
        return self.model(p, u, flags, **kw)


class InputScale(torch.nn.Module):
    """`model` with the input scale of each call kept in `seen` (the
    caller's `input_scale`, else models.fluidnet._input_scale), or, with
    `fed`, replaced by fed[i % len(fed)] at its i-th call: a slab fed the
    whole grid's scales."""

    def __init__(self, model, fed=None):
        super().__init__()
        self.model, self.fed, self.seen = model, fed, []

    def forward(self, p, u, flags, input_scale=None, **kw):
        from fluidnet_tpu_torch.models.fluidnet import _input_scale

        def scale(*args):
            if self.fed is None:
                s = (input_scale or _input_scale)(*args)
            else:
                s = self.fed[len(self.seen) % len(self.fed)].to(p.device)
            self.seen.append(s)
            return s
        return self.model(p, u, flags, input_scale=scale, **kw)


def plume(states, key):
    """(global FluidState, its plume BC masks) on the host: states[key],
    or the empty plume of bench.py from zeros when `key` is a
    resolution."""
    from fluidnet_tpu_torch.core.grids import FluidState, empty_domain
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs
    if isinstance(key, int):
        shape = (1, 1, key, key, key)
        state = FluidState(u=torch.zeros((1, 3) + shape[2:]),
                           p=torch.zeros(shape),
                           flags=empty_domain(shape, True, device="cpu"),
                           density=torch.zeros(shape))
    else:
        state = FluidState(**states[key])
    return state, create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)


def counted(fn):
    """(fn(), the kernel launches it made)."""
    before = dict(_build.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before.get(k, 0) for k, v in _build.launches.items()
                 if v - before.get(k, 0)}


def timed(fn, reps):
    """Milliseconds of each of `reps` calls of fn(), the ranks released
    together by a barrier, each call closed by a synchronize."""
    out = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def sharded(inp, reps, rank):
    from fluidnet_tpu_torch.parallel.advect_sharded import (
        _exchange_z_halo, advect_step_z_sharded)
    from fluidnet_tpu_torch.parallel.halo import (exchange_z_planes,
                                                  halo_jacobi_solve)
    mesh = make_mesh(n_dp=1, n_sp=dist.get_world_size())
    dev = mesh_device(mesh)
    sp = spatial_sharding(mesh)
    group = mesh["sp"].get_group()
    u, d, f = (local_part(inp[k], sp).to(dev).contiguous()
               for k in ("u", "density", "flags"))
    info = {"rank": rank, "device": str(dev),
            "transport": transport(u, group), "slab": list(u.shape),
            "cases": {}}
    lo, hi = exchange_z_planes([u], 2 * inp["cases"][0][0] + 2, group)[0]
    saved = {"halo": (lo.cpu(), hi.cpu())}
    for W, dt in inp["cases"]:
        def step():
            return advect_step_z_sharded(dt, u, d, f, mesh, inp["method"],
                                         inp["strength"], W)
        (u_new, d_new), per_step = counted(step)
        saved[W] = (u_new.cpu(), d_new.cpu())
        step_ms = timed(step, reps)
        H = 2 * W + 2
        exch_ms = timed(lambda: _exchange_z_halo([u, f, d], H, group), reps)
        info["cases"][W] = {"launches_per_step": per_step,
                            "step_ms": step_ms, "exchange_ms": exch_ms}
    jac = inp["jacobi"]
    jf, jd = (local_part(jac[k], sp).to(dev).contiguous()
              for k in ("flags", "div"))
    p, jac_launches = counted(lambda: halo_jacobi_solve(jf, jd, mesh,
                                                         jac["n_iter"]))
    info["jacobi"] = {"launches": jac_launches,
                      "ms": timed(lambda: halo_jacobi_solve(
                          jf, jd, mesh, jac["n_iter"]), reps)}
    saved["jacobi"] = p.cpu()
    return info, saved


def train(inp, rank):
    from fluidnet_tpu_torch.train.train import init_train_state, train_step
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = make_global_mesh(n_dp=int(os.environ["LOCAL_WORLD_SIZE"]))
    group = data_parallel_group(mesh)
    batch = shard_host_batch(inp["batch"], mesh)
    mconf, n = inp["mconf"], inp["n"]
    state = init_train_state(inp["model_seed"], mconf, mesh_device(mesh))

    def step():
        return train_step(state, batch,
                          torch.Generator().manual_seed(inp["gen_seed"]),
                          mconf, n, group=group)
    (state, terms), launches = counted(step)
    saved = {"terms": {k: float(v) for k, v in terms.items()},
             "params": [p.detach().to("cpu", copy=True)
                        for p in state.params]}
    info = {"rank": rank, "transport": transport(batch["u_div"], group),
            "local_batch": list(batch["u_div"].shape), "launches": launches,
            "terms": saved["terms"], "step_ms": timed(step, 1)}
    return info, saved


def step(inp, reps, rank):
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_tpu_torch.parallel import simulate_sharded as ss
    from fluidnet_tpu_torch.utils.checkpoint import load_params
    mesh = make_mesh(n_dp=1, n_sp=dist.get_world_size())
    dev = mesh_device(mesh)
    group = mesh["sp"].get_group()
    info = {"rank": rank, "device": str(dev), "runs": {}}
    saved = {}
    for run in inp["runs"]:
        mconf, n = run["mconf"], run["steps"]
        state, bcs = plume(inp["states"], run["state"])
        state_l = ss.shard_state(state, mesh, dev)
        bcs_l = ss.shard_bcs(bcs, mesh, dev)
        del state, bcs
        model = None
        if mconf.sim_method == "convnet":
            model = InputScale(FirstInput(FluidNet(
                mconf, device=dev).load_jax_params(load_params(
                    inp["model"]))), run.get("scales"))

        def roll(use_kernels=True):
            with planted(run["fault"], rank):
                return ss.rollout_z_sharded(state_l, mconf, n, mesh, model,
                                            bcs_l, use_kernels=use_kernels)
        with comm_counts() as comms, cg_solves() as solves:
            out, launches = counted(roll)
        keys = ("u", "p", "density")
        saved[run["name"]] = {k: getattr(out, k).cpu() for k in keys}
        if model is not None:
            # The own planes of the first step's model inputs (the u and
            # divergence the advection and K2 hand it).
            zl, lo = state_l.u.shape[2], ss.ghost_planes(mconf) * (rank > 0)
            first = model.model
            saved[run["name"]].update(
                first_u=first.seen[:, :, lo:lo + zl].cpu(),
                first_div=first.div[:, :, lo:lo + zl].cpu())
        rec = {"launches": launches, "comms": dict(comms),
               "slab": list(state_l.u.shape),
               "ghost": ss.ghost_planes(mconf),
               "transport": transport(state_l.u, group)}
        if model is not None:
            rec["scales"] = [s.flatten().tolist() for s in model.seen[:n]]
        # The same rollout on the same slab with every kernel's plain
        # version: K1, K2 and K3 give their plain versions' bits.
        plain = roll(use_kernels=False)
        rec["plain_max_abs"] = {
            k: (getattr(out, k) - getattr(plain, k)).abs().max().item()
            for k in keys}
        rec["plain_equal"] = all(torch.equal(getattr(out, k),
                                             getattr(plain, k))
                                 for k in keys)
        del plain
        if mconf.sim_method == "pcg":
            from fluidnet_tpu_torch.parallel.mesh import all_reduce_sum
            from fluidnet_tpu_torch.parallel.pcg_sharded import (
                connected_components_z_sharded, exchange_ghost,
                slab_segments)
            rec["cg"] = solves
            if not run["fault"]:
                # The rerun, timed: it must give the same bits.
                again = []
                rec["step_ms"] = [t / n for t in timed(
                    lambda: again.append(roll()), 1)]
                rec["rerun_equal"] = all(torch.equal(getattr(out, k),
                                                     getattr(again[0], k))
                                         for k in keys)
                del again
                # A CG iteration's collectives alone: the exchange of one
                # plane of d and an all_reduce of two per-sample dots.
                d = torch.zeros_like(state_l.p)
                rec["cg_exchange_ms"] = timed(
                    lambda: exchange_ghost([d], 1, group), reps)
                dots = torch.zeros((2, d.shape[0]), device=dev)
                rec["cg_all_reduce_ms"] = timed(
                    lambda: all_reduce_sum(dots, group), reps)
            # The labelling a rollout makes at its start, alone: its
            # time, sweeps and collectives.
            z0 = rank * state_l.u.shape[2]
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with comm_counts() as comms:
                labels, rec["label_sweeps"] = \
                    connected_components_z_sharded(state_l.flags, mesh, z0)
                slab_segments(labels, group)
            torch.cuda.synchronize()
            rec["label_ms"] = (time.perf_counter() - t0) * 1e3
            rec["label_comms"] = dict(comms)
            saved[run["name"]]["labels"] = labels.cpu()
        if mconf.sim_method == "jacobi":
            with halo_solve():
                with comm_counts() as comms:
                    old = roll()
                rec["halo_comms"] = dict(comms)
                rec["halo_equal"] = all(torch.equal(getattr(out, k),
                                                    getattr(old, k))
                                        for k in keys)
                del old
                rec["halo_step_ms"] = [t / n for t in timed(roll, 1)]
        if not run["fault"]:
            if "step_ms" not in rec:
                rec["step_ms"] = [t / n for t in timed(roll, 1)]
            G = rec["ghost"]
            fields = [state_l.u, state_l.density] + (
                [state_l.p] if model is not None else [])
            rec["exchange_ms"] = timed(
                lambda: ss.exchange_ghost(fields, G, group), reps)
            rec["exchange_mib"] = sum(
                f.shape[0] * f.shape[1] * G * f.shape[3] * f.shape[4] *
                f.element_size() for f in fields) / 2**20
        info["runs"][run["name"]] = rec
        del out, model, state_l, bcs_l
        torch.cuda.empty_cache()
    return info, saved


@contextlib.contextmanager
def comm_counts():
    """Counts this process's collectives while it is entered: forward
    exchanges (halo._swap_planes), adjoint exchanges (halo.
    planes_adjoint) and all_reduces (mesh._all_reduce). Yields the dict
    of counts."""
    from fluidnet_tpu_torch.parallel import halo, mesh
    counts = {"exchanges": 0, "adjoint_exchanges": 0, "all_reduces": 0}
    real = {(halo, "_swap_planes"): "exchanges",
            (halo, "planes_adjoint"): "adjoint_exchanges",
            (mesh, "_all_reduce"): "all_reduces"}
    saved = {k: getattr(*k) for k in real}

    def counting(key):
        fn = saved[key]

        def wrapped(*a, **kw):
            counts[real[key]] += 1
            return fn(*a, **kw)
        return wrapped
    for (mod, name) in real:
        setattr(mod, name, counting((mod, name)))
    try:
        yield counts
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def train_sp(inp, reps, rank):
    from fluidnet_tpu_torch.parallel.halo import (exchange_ghost,
                                                  planes_adjoint)
    from fluidnet_tpu_torch.parallel.mesh import shard_batch
    from fluidnet_tpu_torch.parallel.simulate_sharded import ghost_planes
    from fluidnet_tpu_torch.parallel.train_sharded import loss_fn_sharded
    from fluidnet_tpu_torch.train import train as tr
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    n, draws, seed = inp["n"], inp["draws"], inp["model_seed"]
    info, saved, meshes = {"rank": rank, "runs": {}}, {}, {}
    for run in inp["runs"]:
        shape = tuple(run["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        mesh, mconf = meshes[shape], run["mconf"]
        dev = mesh_device(mesh)
        group = mesh["sp"].get_group()
        batch_l = shard_batch(inp["batches"][run["batch"]], mesh, dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def local(use_kernels=True):
            model = tr.init_train_state(seed, mconf, dev).model
            total, terms = loss_fn_sharded(
                model, batch_l, None, mconf, n, mesh, draws=draws,
                use_kernels=use_kernels)
            return torch.autograd.grad(total, list(
                p for _, p in model.jax_named_parameters())), terms

        def reduced(grads, terms):
            g, t = tr._mean_over(dist.group.WORLD, grads, terms,
                                 tr._replicas(mesh))
            return [x.cpu() for x in g], {k: float(v) for k, v in t.items()}

        with comm_counts() as comms:
            (g_k, terms), launches = counted(local)
        g_p, _ = local(use_kernels=False)
        rec = {"launches": launches, "comms": dict(comms),
               "slab": list(batch_l["u_div"].shape),
               "transport": transport(batch_l["u_div"], group),
               "plain_equal": all(torch.equal(a, b)
                                  for a, b in zip(g_k, g_p)),
               "plain_max_abs": max((a - b).abs().max().item()
                                    for a, b in zip(g_k, g_p))}
        grads, rec["terms"] = reduced(g_k, terms)
        del g_p
        with zeroed_d_ghosts() if run.get("fault") == "cg_direction" \
                else dropped_adjoint():
            fault, _ = reduced(*local())
        aug_u = None
        if mconf.augment_without_targets:
            rec_u = FirstInput(tr.init_train_state(seed, mconf, dev).model)
            with torch.no_grad():
                loss_fn_sharded(rec_u, batch_l, None, mconf, n, mesh,
                                draws=draws)
            aug_u = rec_u.seen.cpu()
            del rec_u
        state = tr.init_train_state(seed, mconf, dev)
        steps = []
        for _ in range(2):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, t = tr.train_step(state, batch_l, None, mconf, n,
                                     draws=draws, mesh=mesh)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            rec.setdefault("step_terms", []).append(
                {k: float(v) for k, v in t.items()})
        rec["step_ms"] = steps
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        G = ghost_planes(mconf)
        fields = [batch_l["u_div"], batch_l["density"], batch_l["p_div"]]
        shapes = [f.shape for f in fields]
        idx, n_sp = mesh["sp"].get_local_rank(), mesh["sp"].size()
        cots = [tuple(torch.ones(f.shape[:2] + (G,) + f.shape[3:],
                                 device=dev) if ok else None
                      for ok in (idx > 0, idx < n_sp - 1)) for f in fields]
        rec["ghost"] = G
        rec["exchange_ms"] = timed(
            lambda: exchange_ghost(fields, G, group), reps)
        rec["adjoint_ms"] = timed(
            lambda: planes_adjoint(shapes, cots, G, group, fields[0]), reps)
        rec["exchange_mib"] = sum(
            f.shape[0] * f.shape[1] * G * f.shape[3] * f.shape[4] *
            f.element_size() for f in fields) / 2**20
        info["runs"][run["name"]] = rec
        saved[run["name"]] = {
            "grads": grads, "fault": fault, "aug_u": aug_u,
            "params": [p.detach().to("cpu", copy=True)
                       for p in state.params]}
        del batch_l, state, fields, cots
    return info, saved


def jacobi(inp, reps, rank):
    from fluidnet_tpu_torch.parallel.halo import (halo_jacobi_solve,
                                                  slab_jacobi_solve)
    mesh = make_mesh(n_dp=1, n_sp=dist.get_world_size())
    dev = mesh_device(mesh)
    sp = spatial_sharding(mesh)
    f, d = (local_part(inp[k], sp).to(dev).contiguous()
            for k in ("flags", "div"))
    info = {"rank": rank, "device": str(dev), "slab": list(d.shape),
            "transport": transport(d, mesh["sp"].get_group()), "runs": {}}
    saved = {}
    for n in inp["n_iters"]:
        with comm_counts() as comms:
            p, launches = counted(lambda: slab_jacobi_solve(f, d, mesh, n))
        plain = slab_jacobi_solve(f, d, mesh, n, use_kernels=False)
        info["runs"][n] = {
            "launches": launches, "comms": dict(comms),
            "plain_equal": torch.equal(p, plain),
            "ms": timed(lambda: slab_jacobi_solve(f, d, mesh, n), reps),
            "halo_ms": timed(lambda: halo_jacobi_solve(f, d, mesh, n),
                             reps)}
        saved[n] = p.cpu()
    return info, saved


def spawn_local(args, world, out, timeout, tag="ranks", backend="gloo"):
    """Runs `world` ranks of this script on one host (torchrun's variables
    set here) with `args` and `backend`, each rank's output in
    out/<tag>_rank<r>.log. Raises as soon as a rank exits other than 0,
    or past `timeout` seconds, and kills every rank left. Returns ([each
    rank's JSON report], [each rank's saved tensors], seconds)."""
    import torch
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank))
            log = open(os.path.join(out, f"{tag}_rank{rank}.log"), "w")
            procs.append((log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *args,
                 "--backend", backend, "--out", out], env=env, stdout=log,
                stderr=subprocess.STDOUT)))
        while any(p.poll() is None for _, p in procs):
            if time.perf_counter() - t0 > timeout:
                raise RuntimeError(f"{tag}: ranks ran past {timeout} s")
            time.sleep(0.2)
            failed = [r for r, (_, p) in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed:
                log = procs[failed[0]][0]
                log.flush()
                with open(log.name) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"{tag}: rank {failed[0]} exited "
                                   f"{procs[failed[0]][1].returncode}:\n"
                                   f"{tail}")
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    secs = time.perf_counter() - t0
    reports, saved = [], []
    for rank in range(world):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
        saved.append(torch.load(os.path.join(out, f"rank{rank}.pt"),
                                weights_only=False))
    return reports, saved, secs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=("sharded", "train", "step",
                                       "train_sp", "jacobi"),
                    required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_parallel_rank: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not init_multihost(backend=args.backend):
        raise SystemExit("torch_parallel_rank: needs WORLD_SIZE > 1 and "
                         "torchrun's variables")
    rank = dist.get_rank()
    inp = torch.load(args.inputs, weights_only=False)
    info, saved = {"sharded": lambda: sharded(inp, args.reps, rank),
                   "train": lambda: train(inp, rank),
                   "step": lambda: step(inp, args.reps, rank),
                   "train_sp": lambda: train_sp(inp, args.reps, rank),
                   "jacobi": lambda: jacobi(inp, args.reps, rank)}[
        args.case]()
    info["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    info["launches_total"] = dict(_build.launches)
    torch.save(saved, os.path.join(args.out, f"rank{rank}.pt"))
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
