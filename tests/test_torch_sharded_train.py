"""sp-sharded training of the PyTorch port (parallel/train_sharded.py,
train.train_step(mesh=), train.eval_step(mesh=)) against JAX's loss_fn on
the whole batch and the port's one-process step, on the CPU with gloo.

The pytest process makes every input with numpy from a seed: a batch of
B = 2 scenes of 32 x 16 x 16 cells (Z the longest axis, cut at z = 16
across an obstacle box) with random u_div, p_div and density, a random
float32 default model whose JAX params the port carries over, and the
draws of a JAX key that turns buoyancy and vorticity on, passed to every
side. m3d_v5's loss flags (tests/test_torch_train.py's M3D_V5: manta
targets, border weight 4 over width 3, 'full' gradients, n_future 2;
Adam, the reject guard off so that both steps land). This file, run as a
script, is the worker: two spawns of gloo ranks, one on a 1 x 2 ('dp',
'sp') mesh and one on 2 x 2 (one sample a rank), run while JAX's
value_and_grad compiles in a thread (its suite's knobs: the unfused
sweeps and prologue, interpret-mode Pallas). Each rank writes its results
to an npz.

Held (tolerances stated per test): the loss terms, every parameter's
gradient, the params after 2 Adam steps and eval_step's terms against
JAX and against the port's one-process loss_fn / train_step / eval_step;
one simulate_z_sharded(grad=True) step's gradients against simulate(grad=
True); the loss with augment_without_targets (gravity drawn on too) against
the port's one-process loss_fn with it, with no more exchanges than
without; the exchange's and all_reduce_sum's adjoints by the dot-product
identity; a planted fault (the exchanges' adjoint drops the ghost
planes' cotangents) that must fail the gradient limits; the sharded
PCG's cases on 1 x 2 (SOLVER: PCG and Jacobi solver targets with the p
and u losses on, loss_p_lambda on manta targets; horizon 1) against
JAX's loss_fn (its value_and_grad of each in a thread) and the port's
one process, with their planted fault (the CG direction's exchange
zeroed); the refusals.
"""

import contextlib
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 300
SHAPE = (2, 1, 32, 16, 16)
N_FUTURE = 2
MESHES = {"dp1_sp2": (1, 2), "dp2_sp2": (2, 2)}
M3D_V5 = dict(is_3d=True, advection_method="maccormackOurs",
              adaptive_window=False, advection_window=1,
              maccormack_strength=0.75, train_buoyancy_prob=0.5,
              train_buoyancy_scale=2.0,
              train_vorticity_confinement_prob=0.3,
              train_vorticity_confinement_amp=3.0, long_term_div_lambda=1.0,
              long_term_grad_mode="full", loss_div_lambda=1.0,
              loss_func_border_weight=4.0, loss_func_border_width=3,
              loss_reject_threshold=0.0, conv_compute_dtype="float32")
TERMS = ("total", "p", "u", "div", "long_term_div")
DRAWS = ("dt", "gravity", "b_scale", "g_scale", "v_amp")
# Loss terms: rtol against JAX (its unfused compositions and XLA's sums)
# and against the port's one process (the same ops; the shares sum in
# another order). Gradients and params after 2 steps: each parameter
# within GRAD_REL relative L2.
JAX_RTOL, PORT_RTOL, GRAD_REL = 1e-4, 1e-5, 1e-4
# Refused (ValueError): a two-bank mres model (pooling factor 2) on slabs
# of 15 planes. Window 0 and ghost zones past a slab's planes train:
# tests/test_torch_sharded_exact.py.
SHORT = {"mres_unaligned": dict(banks_num=2)}
AUGMENT = dict(augment_without_targets=True)
# The sharded PCG's cases (dp 1 x sp 2, horizon SOLVER_FUTURE): solver
# targets with the p and u losses on, and the p loss on manta targets.
# "pcg_fault" is "pcg" with the CG direction's exchange zeroed
# (torch_parallel_rank.zeroed_d_ghosts), which must fail GRAD_REL.
SOLVER_FUTURE = 1
SOLVER = {"pcg": dict(train_target_source="pcg", loss_p_lambda=1.0,
                      loss_u_lambda=1.0),
          "jacobi": dict(train_target_source="jacobi", loss_p_lambda=1.0,
                         loss_u_lambda=1.0),
          "p_loss": dict(loss_p_lambda=1.0)}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --- shared by the worker and the pytest side (no JAX) ----------------------

def _mconf():
    from fluidnet_tpu_torch.core.config import ModelConfig
    m = ModelConfig(**M3D_V5)
    return m.replace(optim=m.optim.__class__(learning_rate=5e-4))


def _draws(inp):
    from fluidnet_tpu_torch.train.train import Draws
    return Draws(*(torch.tensor(inp[f"draw_{k}"]) for k in DRAWS))


def _aug_draws(inp):
    """The draws with gravity on as well: the augmentation adds all three
    forces."""
    return _draws(inp)._replace(g_scale=torch.tensor(2.0))


def _batch(inp, targets=False):
    return {k: torch.from_numpy(inp[k])
            for k in ("flags", "u_div", "p_div", "density") +
            (("p_target", "u_target") if targets else ())}


def _model(inp, mconf):
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    net = FluidNet(mconf, device="cpu")
    with torch.no_grad():
        for name, p in net.jax_named_parameters():
            p.copy_(torch.from_numpy(inp[f"param_{name}"]))
    return net


def _named(model):
    return [k for k, _ in model.jax_named_parameters()]


def _step_objective(out, inp, z0, zl):
    """A fixed random functional of one step's u and p (its cotangents),
    on planes z0 .. z0 + zl of the grid."""
    return sum((getattr(out, k) * torch.from_numpy(
        inp[f"cot_{k}"][:, :, z0:z0 + zl])).sum() for k in ("u", "p"))


def _grown(x, z0, zl, g):
    """Planes z0 - g .. z0 + zl + g of the whole-grid x, cut at the grid's
    ends (a one-sided ghost zone)."""
    return x[:, :, max(z0 - g, 0):min(z0 + zl + g, x.shape[2])]


# --- the worker (run as a script; imports no JAX) ---------------------------

def _worker(rank, world, n_dp, n_sp, port, inp):
    import torch.distributed as dist
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_tpu_torch.parallel import simulate_sharded as ss
    from fluidnet_tpu_torch.parallel.halo import exchange_ghost
    from fluidnet_tpu_torch.parallel.mesh import (all_reduce_sum, make_mesh,
                                                  shard_batch)
    from fluidnet_tpu_torch.parallel.multihost import init_multihost
    from fluidnet_tpu_torch.parallel.train_sharded import loss_fn_sharded
    from fluidnet_tpu_torch.train import train as tr

    assert init_multihost(f"127.0.0.1:{port}", world, rank,
                          device_type="cpu")
    mesh = make_mesh(n_dp=n_dp, n_sp=n_sp, device_type="cpu")
    tm, draws = _mconf(), _draws(inp)
    batch_l = shard_batch(_batch(inp), mesh, device="cpu")
    res = {}

    def grads_and_terms():
        model = _model(inp, tm)
        params = [p for _, p in model.jax_named_parameters()]
        total, terms = loss_fn_sharded(model, batch_l, None, tm, N_FUTURE,
                                       mesh, draws=draws)
        grads = torch.autograd.grad(total, params)
        return tr._mean_over(dist.group.WORLD, grads, terms,
                             tr._replicas(mesh))

    grads, terms = grads_and_terms()
    res.update({f"grad_{k}": g for k, g in zip(_named(_model(inp, tm)),
                                               grads)})
    res.update({f"term_{k}": v for k, v in terms.items()})
    state = tr.init_train_state(0, tm, "cpu", model=_model(inp, tm))
    for i in range(2):
        state, t = tr.train_step(state, batch_l, None, tm, N_FUTURE,
                                 draws=draws, mesh=mesh)
        res[f"step{i}_total"], res[f"step{i}_norm"] = t["total"], \
            t["grad_norm"]
    res.update({f"param2_{k}": p.detach() for k, p in
                state.model.jax_named_parameters()})
    ev = tr.eval_step(batch_l, _model(inp, tm), None, tm, N_FUTURE,
                      draws=draws, mesh=mesh)
    res.update({f"eval_{k}": v for k, v in ev.items()})
    with _rank_script().dropped_adjoint():
        grads, _ = grads_and_terms()
    res.update({f"fault_{k}": g for k, g in zip(_named(_model(inp, tm)),
                                                grads)})

    # The adjoints by the dot-product identity, in float64: each rank's
    # <E x, y> and <x, E^T y> (summed over the ranks on the pytest side).
    group = mesh["sp"].get_group()
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn((1, 2, 8, 3, 4), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    ext, = exchange_ghost([x], 3, group)
    y = torch.randn(ext.shape, generator=gen, dtype=torch.float64)
    gx, = torch.autograd.grad((ext * y).sum(), x)
    res["dot_ghost"] = torch.stack([(ext * y).sum(), (x * gx).sum()])
    a = torch.randn(5, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(5, generator=gen, dtype=torch.float64)
    s = all_reduce_sum(a, group)
    ga, = torch.autograd.grad((s * b).sum(), a)
    res["dot_allreduce"] = torch.stack([(s * b).sum(), (a * ga).sum()])

    if n_dp == 1:
        # One sharded step under autograd (no longer refused).
        model = _model(inp, tm)
        st = ss.shard_state(FluidState(
            u=torch.from_numpy(inp["u_div"]), p=torch.from_numpy(
                inp["p_div"]), flags=torch.from_numpy(inp["flags"]),
            density=torch.from_numpy(inp["density"])), mesh, "cpu")
        u, p = st.u.requires_grad_(), st.p.requires_grad_()
        out = ss.simulate_z_sharded(st, tm, mesh, model, grad=True)
        zl = st.u.shape[2]
        obj = _step_objective(out, inp, rank * zl, zl)
        got = torch.autograd.grad(obj, [u, p] + [
            q for _, q in model.jax_named_parameters()])
        res["sim_du"], res["sim_dp"] = got[0], got[1]
        res.update({f"sim_grad_{k}": g for k, g in
                    zip(_named(model), got[2:])})

        # augment_without_targets on the slabs, its exchanges counted
        # beside the loss's without it.
        for name, m, dr in (("plain", tm, draws),
                            ("aug", tm.replace(**AUGMENT), _aug_draws(inp))):
            model = _model(inp, m)
            rec = _rank_script().FirstInput(model)
            with _rank_script().comm_counts() as comms:
                total, terms = loss_fn_sharded(rec, batch_l, None, m,
                                               N_FUTURE, mesh, draws=dr)
                grads = torch.autograd.grad(total, [
                    q for _, q in model.jax_named_parameters()])
            grads, terms = tr._mean_over(dist.group.WORLD, grads, terms,
                                         tr._replicas(mesh))
            res[f"{name}_comms"] = np.array([comms[k] for k in sorted(comms)])
            if name == "aug":
                res["aug_model_u"] = rec.seen
                res.update({f"aug_grad_{k}": g for k, g in
                            zip(_named(model), grads)})
                res.update({f"aug_term_{k}": v for k, v in terms.items()})

        # The sharded PCG's cases, and the planted fault.
        batch_t = shard_batch(_batch(inp, targets=True), mesh, device="cpu")
        for name in list(SOLVER) + ["pcg_fault"]:
            m = tm.replace(**SOLVER[name.replace("_fault", "")])
            model = _model(inp, m)
            with _rank_script().zeroed_d_ghosts() if name == "pcg_fault" \
                    else contextlib.nullcontext():
                total, terms = loss_fn_sharded(model, batch_t, None, m,
                                               SOLVER_FUTURE, mesh,
                                               draws=draws)
                grads = torch.autograd.grad(total, [
                    q for _, q in model.jax_named_parameters()])
            grads, terms = tr._mean_over(dist.group.WORLD, grads, terms,
                                         tr._replicas(mesh))
            res.update({f"{name}_grad_{k}": g for k, g in
                        zip(_named(model), grads)})
            res.update({f"{name}_term_{k}": v for k, v in terms.items()})

        def error(fn):
            try:
                fn()
            except (NotImplementedError, ValueError) as e:
                return np.array(f"{type(e).__name__}: {e}")
            return np.array("")
        for name, kw in SHORT.items():
            m = tm.replace(**kw)
            b = {k: v[:, :, :15] for k, v in batch_l.items()}
            res[f"err_{name}"] = error(lambda: loss_fn_sharded(
                FluidNet(m, device="cpu"), b, None, m, N_FUTURE, mesh,
                draws=draws))
    return res


def _rank_script():
    """scripts/torch_parallel_rank.py as a module (its planted fault)."""
    import importlib.util
    path = os.path.join(REPO, "scripts", "torch_parallel_rank.py")
    spec = importlib.util.spec_from_file_location("torch_parallel_rank",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _worker_main(rank, world, n_dp, n_sp, port, in_path, out_path):
    torch.set_num_threads(1)
    res = _worker(rank, world, n_dp, n_sp, port, dict(np.load(in_path)))
    np.savez(out_path, **{k: v.detach().numpy() if torch.is_tensor(v)
                          else v for k, v in res.items()})
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# --- the pytest side --------------------------------------------------------

def _spawn(tmp, in_path, name):
    n_dp, n_sp = MESHES[name]
    world, port = n_dp * n_sp, _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        out = os.path.join(tmp, f"{name}_rank{rank}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(world),
             str(n_dp), str(n_sp), str(port), in_path, out], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def _collect(procs):
    outs = []
    try:
        for path, proc in procs:
            log = proc.communicate(timeout=SPAWN_TIMEOUT)[0]
            assert proc.returncode == 0, f"rank failed:\n{log}"
            outs.append(dict(np.load(path)))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def _flags():
    flags = np.ones(SHAPE, np.int32)
    flags[:, :, [0, -1]] = 2
    flags[:, :, :, [0, -1]] = 2
    flags[..., [0, -1]] = 2
    flags[..., 13:19, 6:10, 4:8] = 2       # a box across the cut at z 16
    flags[1, :, 20:23, 3:6, 9:13] = 2
    return flags


def _inputs():
    """The inputs of every side, the JAX params and the key."""
    import jax
    from fluidnet_tpu.core.config import ModelConfig as JModelConfig
    from fluidnet_tpu.models.fluidnet import init_model
    from fluidnet_tpu.train import train as jtrain

    rng = np.random.default_rng(150)
    B, _, Z, Y, X = SHAPE
    inp = {"flags": _flags(),
           "u_div": (rng.standard_normal((B, 3, Z, Y, X)) * 0.5).astype(
               np.float32),
           "p_div": (rng.standard_normal(SHAPE) * 0.1).astype(np.float32),
           "density": rng.random(SHAPE).astype(np.float32),
           "cot_u": rng.standard_normal((B, 3, Z, Y, X)).astype(np.float32),
           "cot_p": rng.standard_normal(SHAPE).astype(np.float32),
           "p_target": (rng.standard_normal(SHAPE) * 0.1).astype(
               np.float32),
           "u_target": (rng.standard_normal((B, 3, Z, Y, X)) * 0.5).astype(
               np.float32)}
    jm = JModelConfig(**M3D_V5)
    jm = jm.replace(optim=jm.optim.__class__(learning_rate=5e-4))
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        kdt, kforce = jax.random.split(key)
        forces = jtrain._random_forces(kforce, jm)
        if float(forces[1]) > 0 and float(forces[3]) > 0:
            break
    for k, v in zip(DRAWS, (jtrain._random_dt(kdt, jm),) + tuple(forces)):
        inp[f"draw_{k}"] = np.asarray(v, np.float32)
    params = init_model(jax.random.PRNGKey(3), jm)
    for name in _named(_model_shape()):
        tree = params
        for k in name.split("/"):
            tree = tree[int(k)] if isinstance(tree, list) else tree[k]
        inp[f"param_{name}"] = np.array(tree)
    return inp, params, key, jm


def _model_shape():
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    return FluidNet(_mconf(), device="cpu")


def _jax_ref(inp, params, key, jm):
    """JAX's value_and_grad of loss_fn on the whole batch at the params,
    then two Adam steps (make_optimizer's chain, apply_updates)."""
    import jax
    import jax.numpy as jnp
    from fluidnet_tpu.train import train as jtrain

    batch = {k: jnp.asarray(inp[k]) for k in ("flags", "u_div", "p_div",
                                              "density")}
    vg = jax.jit(jax.value_and_grad(jtrain.loss_fn, has_aux=True),
                 static_argnames=("mconf", "n_future"))
    opt = jtrain.make_optimizer(jm)
    opt_state = opt.init(params)
    out = {}
    for i in range(2):
        (_, terms), grads = vg(params, batch, key, jm, N_FUTURE)
        if i == 0:
            out["terms"] = {k: float(v) for k, v in terms.items()}
            out["grads"] = jax.tree_util.tree_map(np.asarray, grads)
        out[f"step{i}_total"] = float(terms["total"])
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jtrain.optax.apply_updates(params, updates)
    out["params2"] = jax.tree_util.tree_map(np.asarray, params)
    return out


def _port_ref(inp):
    """The port's one-process loss_fn gradients, two train_steps,
    eval_step and one simulate(grad=True) step, on one thread as the
    ranks run (the CPU convolutions and reductions round by the thread
    count)."""
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.sim.simulate import simulate
    from fluidnet_tpu_torch.train import train as tr
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tm, draws, batch = _mconf(), _draws(inp), _batch(inp)
        model = _model(inp, tm)
        params = [p for _, p in model.jax_named_parameters()]
        total, terms = tr.loss_fn(model, batch, None, tm, N_FUTURE,
                                  draws=draws)
        grads = torch.autograd.grad(total, params)
        out = {"terms": {k: float(v.detach()) for k, v in terms.items()},
               "grads": dict(zip(_named(model), grads))}
        state = tr.init_train_state(0, tm, "cpu", model=_model(inp, tm))
        for i in range(2):
            state, t = tr.train_step(state, batch, None, tm, N_FUTURE,
                                     draws=draws)
            out[f"step{i}_total"] = float(t["total"])
            out[f"step{i}_norm"] = float(t["grad_norm"])
        out["params2"] = dict(state.model.jax_named_parameters())
        out["eval"] = {k: float(v) for k, v in tr.eval_step(
            batch, _model(inp, tm), None, tm, N_FUTURE, draws=draws).items()}
        model = _model(inp, tm)
        u = torch.from_numpy(inp["u_div"]).requires_grad_()
        p = torch.from_numpy(inp["p_div"]).requires_grad_()
        s = simulate(FluidState(u=u, p=p, flags=torch.from_numpy(
            inp["flags"]), density=torch.from_numpy(inp["density"])), tm,
            model, grad=True)
        got = torch.autograd.grad(_step_objective(s, inp, 0, SHAPE[2]),
                                  [u, p] + [q for _, q in
                                            model.jax_named_parameters()])
        out["sim"] = {"du": got[0], "dp": got[1],
                      "grads": dict(zip(_named(model), got[2:]))}
        m = tm.replace(**AUGMENT)
        model = _model(inp, m)
        total, terms = tr.loss_fn(model, batch, None, m, N_FUTURE,
                                  draws=_aug_draws(inp))
        with torch.no_grad():
            aug_u = tr._data_augmentation(
                batch["u_div"], batch["flags"], batch["density"], m,
                _aug_draws(inp))
        out["aug"] = {"u": aug_u.numpy(),
                      "terms": {k: float(v.detach())
                                for k, v in terms.items()},
                      "grads": dict(zip(_named(model), torch.autograd.grad(
                          total, [q for _, q in
                                  model.jax_named_parameters()])))}
        return out
    finally:
        torch.set_num_threads(threads)


def _jax_solver_ref(inp, params, key, jm, name):
    """JAX's value_and_grad of loss_fn on the whole batch (with its
    targets) for a SOLVER case."""
    import jax
    import jax.numpy as jnp
    from fluidnet_tpu.train import train as jtrain

    batch = {k: jnp.asarray(v) for k, v in _batch(inp, True).items()}
    (_, terms), grads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        params, batch, key, jm.replace(**SOLVER[name]), SOLVER_FUTURE)
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _port_solver_ref(inp):
    """The port's one-process loss_fn gradients of each SOLVER case, on
    one thread."""
    from fluidnet_tpu_torch.train import train as tr
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, kw in SOLVER.items():
            m = _mconf().replace(**kw)
            model = _model(inp, m)
            total, terms = tr.loss_fn(model, _batch(inp, True), None, m,
                                      SOLVER_FUTURE, draws=_draws(inp))
            out[name] = {
                "terms": {k: float(v.detach()) for k, v in terms.items()},
                "grads": dict(zip(_named(model), torch.autograd.grad(
                    total, [q for _, q in model.jax_named_parameters()])))}
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX's results, the port's one-process results, {mesh: [each
    rank's results]}); JAX's and the port's results of the SOLVER cases
    under "solver"."""
    tmp = str(tmp_path_factory.mktemp("torch_sharded_train"))
    inp, params, key, jm = _inputs()
    in_path = os.path.join(tmp, "inputs.npz")
    np.savez(in_path, **inp)
    procs = {name: _spawn(tmp, in_path, name) for name in MESHES}
    try:
        with ThreadPoolExecutor(1 + len(SOLVER)) as pool:
            jref = pool.submit(_jax_ref, inp, params, key, jm)
            jsol = {name: pool.submit(_jax_solver_ref, inp, params, key, jm,
                                      name) for name in SOLVER}
            pref = _port_ref(inp)
            pref["solver"] = _port_solver_ref(inp)
            jref = jref.result()
            jref["solver"] = {k: f.result() for k, f in jsol.items()}
    finally:
        outs = {name: _collect(p) for name, p in procs.items()}
    return jref, pref, outs


def _jax_leaf(tree, name):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return np.asarray(tree)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) /
                 max(np.linalg.norm(want), 1e-30))


def _worst_grad(o, prefix, want):
    """The largest relative L2 of the parameters' `prefix` entries of a
    rank's results against want(name)."""
    return max(_rel(o[f"{prefix}{k}"], want(k)) for k in _names())


def _names():
    return _named(_model_shape())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_loss_terms(run, mesh):
    """Every rank's reduced loss terms: rtol JAX_RTOL of JAX's on the
    whole batch, PORT_RTOL of the port's one-process loss_fn (atol
    1e-7)."""
    jref, pref, outs = run
    for o in outs[mesh]:
        for k in TERMS:
            np.testing.assert_allclose(o[f"term_{k}"], jref["terms"][k],
                                       rtol=JAX_RTOL, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(o[f"term_{k}"], pref["terms"][k],
                                       rtol=PORT_RTOL, atol=1e-7, err_msg=k)
    assert pref["terms"]["long_term_div"] > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients(run, mesh):
    """Every parameter's gradient, summed over 'sp' and averaged over
    'dp': within GRAD_REL relative L2 of JAX's and of the port's
    one-process gradient, on every rank."""
    jref, pref, outs = run
    for o in outs[mesh]:
        wj = _worst_grad(o, "grad_", lambda k: _jax_leaf(jref["grads"], k))
        wp = _worst_grad(o, "grad_", lambda k: pref["grads"][k].numpy())
        print(f"{mesh}: gradients' worst relative L2 vs JAX {wj:.3e}, vs "
              f"the port {wp:.3e}")
        assert wj <= GRAD_REL and wp <= GRAD_REL, (wj, wp)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_adam_steps(run, mesh):
    """train_step(mesh=) twice: each step's loss within PORT_RTOL of the
    port's one-process train_step and JAX_RTOL of JAX's, its grad norm
    within PORT_RTOL of the port's, and the params after both within
    GRAD_REL relative L2 of the port's and of JAX's (make_optimizer's
    Adam, apply_updates), equal on every rank."""
    jref, pref, outs = run
    for o in outs[mesh]:
        for i in range(2):
            np.testing.assert_allclose(o[f"step{i}_total"],
                                       pref[f"step{i}_total"],
                                       rtol=PORT_RTOL)
            np.testing.assert_allclose(o[f"step{i}_total"],
                                       jref[f"step{i}_total"],
                                       rtol=JAX_RTOL)
            np.testing.assert_allclose(o[f"step{i}_norm"],
                                       pref[f"step{i}_norm"],
                                       rtol=PORT_RTOL)
        assert _worst_grad(o, "param2_",
                           lambda k: pref["params2"][k].detach()) <= GRAD_REL
        assert _worst_grad(o, "param2_",
                           lambda k: _jax_leaf(jref["params2"], k)) <= \
            GRAD_REL
        for k in _names():
            np.testing.assert_array_equal(o[f"param2_{k}"],
                                          outs[mesh][0][f"param2_{k}"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_eval_step(run, mesh):
    """eval_step(mesh=)'s terms: rtol PORT_RTOL of the port's eval_step,
    JAX_RTOL of JAX's terms (atol 1e-7)."""
    jref, pref, outs = run
    for o in outs[mesh]:
        for k in TERMS:
            np.testing.assert_allclose(o[f"eval_{k}"], pref["eval"][k],
                                       rtol=PORT_RTOL, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(o[f"eval_{k}"], jref["terms"][k],
                                       rtol=JAX_RTOL, atol=1e-7, err_msg=k)
        assert float(o["eval_grad_norm"]) == 0.0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_planted_adjoint_fault_fails(run, mesh):
    """The exchanges' adjoint with the ghost planes' cotangents dropped:
    the gradients fail GRAD_REL against JAX's and the port's."""
    jref, pref, outs = run
    for o in outs[mesh]:
        wj = _worst_grad(o, "fault_", lambda k: _jax_leaf(jref["grads"], k))
        wp = _worst_grad(o, "fault_", lambda k: pref["grads"][k].numpy())
        print(f"{mesh}: planted fault, gradients' worst relative L2 vs "
              f"JAX {wj:.3e}, vs the port {wp:.3e}")
        assert wj > GRAD_REL and wp > GRAD_REL, (wj, wp)


@pytest.mark.parametrize("which", ["dot_ghost", "dot_allreduce"])
def test_adjoints_dot_product(run, which):
    """exchange_ghost (3 planes, one-sided at the grid's ends) and
    all_reduce_sum: summed over the ranks of each mesh's 'sp' groups,
    <E x, y> equals <x, E^T y> (float64, rtol 1e-12)."""
    _, _, outs = run
    for mesh, ranks in outs.items():
        n_dp, n_sp = MESHES[mesh]
        for d in range(n_dp):
            dots = sum(o[which] for o in ranks[d * n_sp:(d + 1) * n_sp])
            np.testing.assert_allclose(dots[0], dots[1], rtol=1e-12,
                                       err_msg=f"{mesh} {which}")


def test_simulate_z_sharded_grad(run):
    """simulate_z_sharded(grad=True), one step of the ConvNet, against
    simulate(grad=True) on the whole grid: the gradients of a fixed
    random functional of u and p with respect to the input u and p
    (gathered) and to every parameter (summed over the ranks), each
    within GRAD_REL relative L2."""
    _, pref, outs = run
    ranks = outs["dp1_sp2"]
    for k in ("du", "dp"):
        got = np.concatenate([o[f"sim_{k}"] for o in ranks], axis=2)
        assert _rel(got, pref["sim"][k].numpy()) <= GRAD_REL, k
    for k in _names():
        got = sum(o[f"sim_grad_{k}"] for o in ranks)
        assert _rel(got, pref["sim"]["grads"][k].numpy()) <= GRAD_REL, k


def test_augmentation_on_slabs(run):
    """augment_without_targets on dp 1 x sp 2 (buoyancy, gravity and
    vorticity confinement on each slab grown by the model's ghost zone and
    AUGMENT_REACH, the grid's dx): the reduced terms within PORT_RTOL (atol
    1e-7) of the port's one-process loss_fn with it, which
    tests/test_torch_train.py holds against JAX's, and every gradient
    within GRAD_REL relative L2, on every rank; the augmentation moves the
    loss, and the first model call's exchange carries it (as many
    exchanges, adjoint exchanges and all_reduces as without it). The u
    the first model call gets, each rank's slab grown by model_ghost
    planes, equals the whole grid's augmented u_div on those planes to
    the bit: the augmentation's ghost zone reaches far enough."""
    from fluidnet_tpu_torch.parallel.train_sharded import model_ghost
    _, pref, outs = run
    want = pref["aug"]
    zl, gm = SHAPE[2] // 2, model_ghost(_mconf())
    for rank, o in enumerate(outs["dp1_sp2"]):
        np.testing.assert_array_equal(
            o["aug_model_u"], _grown(want["u"], rank * zl, zl, gm))
        for k in TERMS:
            np.testing.assert_allclose(o[f"aug_term_{k}"], want["terms"][k],
                                       rtol=PORT_RTOL, atol=1e-7, err_msg=k)
        w = _worst_grad(o, "aug_grad_", lambda k: want["grads"][k].numpy())
        print(f"augmentation: gradients' worst relative L2 vs the port "
              f"{w:.3e}")
        assert w <= GRAD_REL, w
        np.testing.assert_array_equal(o["aug_comms"], o["plain_comms"])
    assert abs(want["terms"]["div"] - pref["terms"]["div"]) > \
        1e-3 * pref["terms"]["div"]


@pytest.mark.parametrize("name", list(SOLVER))
def test_sharded_pcg_cases(run, name):
    """The sharded PCG's uses in the loss on dp 1 x sp 2: solver targets
    (PCG on the slabs' pcg_sharded.solve_pcg_z_sharded; jacobi on K3 in
    halo.slab_jacobi_solve's rounds) with the p and u losses on, and
    loss_p_lambda > 0 on manta targets (the per-component mean across the
    slabs), at horizon 1 (the long-term frame solves for its targets
    again): the reduced terms within JAX_RTOL of JAX's loss_fn on the
    whole batch and PORT_RTOL of the port's one-process loss_fn (atol
    1e-7), and every gradient within GRAD_REL relative L2 of both, on
    every rank."""
    jref, pref, outs = run
    js, ps = jref["solver"][name], pref["solver"][name]
    for o in outs["dp1_sp2"]:
        for k in TERMS:
            np.testing.assert_allclose(o[f"{name}_term_{k}"], js["terms"][k],
                                       rtol=JAX_RTOL, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(o[f"{name}_term_{k}"], ps["terms"][k],
                                       rtol=PORT_RTOL, atol=1e-7, err_msg=k)
        wj = _worst_grad(o, f"{name}_grad_",
                         lambda k: _jax_leaf(js["grads"], k))
        wp = _worst_grad(o, f"{name}_grad_",
                         lambda k: ps["grads"][k].numpy())
        print(f"{name}: gradients' worst relative L2 vs JAX {wj:.3e}, vs "
              f"the port {wp:.3e}")
        assert wj <= GRAD_REL and wp <= GRAD_REL, (wj, wp)
    assert js["terms"]["p"] > 0 and js["terms"]["long_term_div"] > 0


def test_sharded_pcg_planted_fault_fails(run):
    """The "pcg" case with the CG direction's exchange zeroed: its
    gradients fail GRAD_REL against JAX's."""
    jref, _, outs = run
    js = jref["solver"]["pcg"]
    for o in outs["dp1_sp2"]:
        w = _worst_grad(o, "pcg_fault_grad_",
                        lambda k: _jax_leaf(js["grads"], k))
        print(f"pcg_fault: gradients' worst relative L2 vs JAX {w:.3e}")
        assert w > GRAD_REL, w


def test_refusals(run):
    """A two-bank mres model on slabs of 15 planes (not a multiple of its
    pooling factor 2) raises ValueError (pooled and banked models train:
    tests/test_torch_sharded_models.py; advection_window 0, batches
    without density and model ghost zones past a slab's planes:
    tests/test_torch_sharded_exact.py)."""
    _, _, outs = run
    for o in outs["dp1_sp2"]:
        msg = str(o["err_mres_unaligned"])
        assert msg.startswith("ValueError: shard z-length 15 is not a "
                              "multiple") and "pooling factor 2" in msg, msg


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker_main(*(int(a) for a in sys.argv[1:6]), sys.argv[6],
                 sys.argv[7])
