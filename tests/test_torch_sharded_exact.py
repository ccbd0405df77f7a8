"""The z-sharded step's remainders in the PyTorch port (parallel/
simulate_sharded.py, parallel/train_sharded.py): states without density,
the exact advection (advection_window 0) on slabs, and the ghost exchange
that reaches past the next rank (parallel/halo.py), against JAX's
unsharded rollout and the port's own, on the CPU with gloo.

The pytest process makes every input with numpy from a seed: one (B=1,
Z=96, Y=8, X=8) grid with a random velocity, pressure and density and
obstacle boxes across the cuts at z = 32 and 64, create_plume_bcs's masks,
and random float32 weights of the default model (random_model) that
JAX's params tree takes. This file, run as a script, is the worker: one
spawn of 3 gloo ranks on a 1 x 3 ('dp', 'sp') mesh (zl = 32) runs every
case while JAX's references compute in three processes of it ("jax" mode,
the suite's knobs). Each writes its results to an npz.

Held: 2 steps (1 for (c): CASES says why) of rollout_z_sharded of
each case of CASES, gathered, against JAX's unsharded rollout at rtol
1e-4, atol 1e-5 and against the
port's unsharded rollout within tests/test_torch_sharded_sim.py's
PORT_MAX / PORT_FRAC: (a) a state without density, no plume BCs, on the
ConvNet and on jacobi-8 (K1's unfused velocity sweep, gravity and K4);
(b) maccormackOurs, eulerOurs, rk2Ours, rk3Ours and Manta's maccormack
at window 0 (G 27, 18, 27, 27, 13 on slabs of 32: a cut inside the
domain); (c) Manta's euler at window 0 with dt max|u_z| past 32 planes
(dt 2.5, one step), so G (47) takes planes from two ranks on the end
ranks. After one step every rank's own planes equal the port's whole
grid's to the bit through the advection and K2 (the ConvNet's inputs),
and through the whole jacobi-8 step; the same step under autograd
(simulate_z_sharded(grad=True)) as the port's. A planted fault (the
ghost planes of a step's exchange zeroed, on (b) and (c)) must fail the
comparisons; the exchange's adjoint at two hops is held by the
dot-product identity; training at window 0 (m3d_v5's loss flags, the
density-less batch too, horizon 2) against the port's one-process loss_fn
and train_step (terms rtol 1e-5, gradients 1e-5 relative L2;
tests/test_torch_exact_grad.py holds that loss_fn against JAX's), with
the dropped adjoint that must fail. Without JAX or ranks: probes of the
exact route's reach (simulate_sharded.advection_reach) by autograd, and
the ghost zones at window 0.
"""

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
WORLD = 3
SHAPE = (1, 1, 96, 8, 8)
N_STEPS = 2
N_FUTURE = 2
RTOL, ATOL = 1e-4, 1e-5
# tests/test_torch_sharded_sim.py's limits against the port's unsharded
# rollout (the ConvNet's input scale sums in another order).
PORT_MAX, PORT_ROUND, PORT_FRAC = 1e-5, 1e-6, 1e-3
# Training against the port's one process: terms, gradients (rel. L2). A
# parameter whose one-process gradient is under CANCEL of the whole
# gradient's norm is a sum that cancels to float32's rounding, and is held
# within GRAD_REL of CANCEL times the whole gradient's norm
# (tests/test_torch_sharded_models.py's rule, at 1e-2 here): the final
# bias, 1.2e-3 of the norm (a constant shift of p leaves u as it is but at
# the walls), whose slabs' sum reads 4e-5 apart, 5e-8 of the norm.
TRAIN_RTOL, GRAD_REL, CANCEL = 1e-5, 1e-5, 1e-2
KNOBS = dict(is_3d=True, sim_method="convnet", dt=0.1, buoyancy_scale=2.0,
             vorticity_confinement_amp=3.0, maccormack_strength=0.6,
             advection_method="maccormackOurs", adaptive_window=False,
             advection_window=1, conv_compute_dtype="float32")
# Each case: mconf changes, its state ("nod": no density, no BCs;
# "slow": density, plume BCs; "fast": "slow" with u_z raised by FAST_UZ,
# stepped at FAST_DT: dt max|u_z| past a slab's 32 planes) and its steps.
# "fast" takes one: there JAX's jitted rollout is what parts from the
# NumPy loop oracle (tests/reference_impl.py's semi_lagrange_euler_mac and
# semi_lagrange_euler_scalar, no fused multiply-adds), which the port's
# euler advection equals to the bit on the same input at both steps, and
# JAX's does too when run eagerly. Under jit XLA:CPU contracts the
# backtrace's multiply-adds (px - mac dt rounded once: emulating that alone
# brings the port from 2.724e-05 to 2.861e-06 of jitted JAX's u), so u
# after step 1 differs by 2.724e-05, and at dt 2.5 step 2 takes it to
# 1.137e-04, 4 cells past RTOL / ATOL (the forces and the model add under
# 1e-6 on the same input).
U_SLOW, FAST_UZ, FAST_DT = 1.0, 10.0, 2.5
CASES = {
    "nod_convnet": (dict(gravity_scale=1.0), "nod", N_STEPS),
    "nod_jacobi8": (dict(sim_method="jacobi", max_iter=8,
                         gravity_scale=1.0), "nod", N_STEPS),
    "w0_maccormackOurs": (dict(advection_window=0), "slow", N_STEPS),
    "w0_eulerOurs": (dict(advection_window=0,
                          advection_method="eulerOurs"), "slow", N_STEPS),
    "w0_rk2Ours": (dict(advection_window=0, advection_method="rk2Ours"),
                   "slow", N_STEPS),
    "w0_rk3Ours": (dict(advection_window=0, advection_method="rk3Ours"),
                   "slow", N_STEPS),
    "w0_maccormack": (dict(advection_window=0,
                           advection_method="maccormack"), "slow", N_STEPS),
    "w0_euler": (dict(advection_window=0, advection_method="euler",
                      dt=FAST_DT), "fast", 1),
}
# The planted fault: the ghost planes of that exchange call zeroed (call
# 0 extends the flags, then one a step).
FAULTS = {"w0_maccormackOurs": 2, "w0_euler": 1}
M3D_V5 = dict(is_3d=True, advection_method="maccormackOurs",
              adaptive_window=False, advection_window=0,
              maccormack_strength=0.75, long_term_div_lambda=1.0,
              long_term_grad_mode="full", loss_div_lambda=1.0,
              loss_func_border_weight=4.0, loss_func_border_width=3,
              loss_reject_threshold=0.0, conv_compute_dtype="float32")
TRAIN = ("w0", "w0_nod")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --- shared by the worker and the pytest side (no JAX) ----------------------

def _mconf(name):
    from fluidnet_tpu_torch.core.config import ModelConfig
    return ModelConfig(**KNOBS).replace(**CASES[name][0])


def _state(inp, kind):
    from fluidnet_tpu_torch.core.grids import FluidState
    return FluidState(u=torch.from_numpy(inp[f"u_{kind}"]),
                      p=torch.from_numpy(inp["p"]),
                      flags=torch.from_numpy(inp["flags"]),
                      density=None if kind == "nod" else
                      torch.from_numpy(inp["density"]))


def _bcs(state):
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs
    if state.density is None:
        return None
    return create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)


def _model(inp, mconf):
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    net = FluidNet(mconf, device="cpu")
    with torch.no_grad():
        for name, p in net.jax_named_parameters():
            p.copy_(torch.from_numpy(inp[f"param_{name}"]))
    return net


def _train_mconf():
    from fluidnet_tpu_torch.core.config import ModelConfig
    m = ModelConfig(**M3D_V5)
    return m.replace(optim=m.optim.__class__(learning_rate=5e-4))


def _draws():
    from fluidnet_tpu_torch.train.train import Draws
    return Draws(torch.tensor(0.1), torch.tensor([0.0, 1.0, 0.0]),
                 torch.tensor(2.0), torch.tensor(0.0), torch.tensor(3.0))


def _batch(inp, name):
    b = {"flags": torch.from_numpy(inp["flags"]),
         "u_div": torch.from_numpy(inp["u_slow"]),
         "p_div": torch.from_numpy(inp["p"])}
    if name == "w0":
        b["density"] = torch.from_numpy(inp["density"])
    return b


def _rank_script():
    """scripts/torch_parallel_rank.py as a module (its planted faults)."""
    import importlib.util
    path = os.path.join(REPO, "scripts", "torch_parallel_rank.py")
    spec = importlib.util.spec_from_file_location("torch_parallel_rank",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Recorder(torch.nn.Module):
    """The model, recording the (u, div) it is handed at its first call
    (div None without K2's prologue: the model takes its own)."""

    def __init__(self, model):
        super().__init__()
        self.model, self.seen = model, None

    def forward(self, p, u, flags, **kw):
        if self.seen is None:
            div = kw.get("precomputed_div")
            self.seen = (u.clone(), torch.zeros(0) if div is None
                         else div.clone())
        return self.model(p, u, flags, **kw)


# --- the worker (run as a script; imports no JAX) ---------------------------

def _worker(rank, port, inp):
    import torch.distributed as dist
    from fluidnet_tpu_torch.parallel import simulate_sharded as ss
    from fluidnet_tpu_torch.parallel.halo import exchange_ghost
    from fluidnet_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from fluidnet_tpu_torch.parallel.multihost import init_multihost
    from fluidnet_tpu_torch.parallel.train_sharded import loss_fn_sharded
    from fluidnet_tpu_torch.train import train as tr

    assert init_multihost(f"127.0.0.1:{port}", WORLD, rank,
                          device_type="cpu")
    mesh = make_mesh(n_dp=1, n_sp=WORLD, device_type="cpu")
    group = mesh["sp"].get_group()
    rs = _rank_script()
    res = {}
    for name, (_, kind, steps) in CASES.items():
        m = _mconf(name)
        net = _model(inp, m) if m.sim_method == "convnet" else None
        st = _state(inp, kind)
        st_l = ss.shard_state(st, mesh)
        bcs_l = ss.shard_bcs(_bcs(st), mesh)
        with rs.comm_counts() as comms:
            out = ss.rollout_z_sharded(st_l, m, steps, mesh, net, bcs_l)
        res[f"{name}_comms"] = np.array([comms["exchanges"],
                                         comms["all_reduces"]])
        for k in ("u", "p", "density"):
            if getattr(out, k) is not None:
                res[f"{name}_{k}"] = getattr(out, k)
        # One step: the ConvNet's model inputs, jacobi-8's whole step.
        if net is not None:
            rec = _Recorder(net)
            ss.simulate_z_sharded(st_l, m, mesh, rec, bcs_l)
            slab = ss._Slab(st_l, m, mesh, bcs_l)
            slab.at(slab.step_ghost(st_l.u, m.dt))
            res[f"step1_{name}_u"] = slab.own(rec.seen[0])
            res[f"step1_{name}_div"] = rec.seen[1] if not \
                rec.seen[1].numel() else slab.own(rec.seen[1])
            res[f"{name}_ghost"] = np.array(slab.g)
        else:
            out = ss.simulate_z_sharded(st_l, m, mesh, None, bcs_l)
            res[f"step1_{name}_u"], res[f"step1_{name}_p"] = out.u, out.p
        # The same step under autograd (training's form).
        res[f"grad1_{name}_u"] = ss.simulate_z_sharded(
            st_l, m, mesh, net, bcs_l, grad=True).u.detach()
        if name in FAULTS:
            with rs.zeroed_ghosts(FAULTS[name], rank):
                out = ss.rollout_z_sharded(st_l, m, steps, mesh, net,
                                           bcs_l)
            res[f"fault_{name}_u"] = out.u

    # The exchange and its adjoint two hops deep, by the dot-product
    # identity in float64: each rank's <E x, y> and <x, E^T y>.
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn((1, 2, 5, 3, 4), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    ext, = exchange_ghost([x], 7, group)
    y = torch.randn(ext.shape, generator=gen, dtype=torch.float64)
    gx, = torch.autograd.grad((ext * y).sum(), x)
    res["dot_ghost"] = torch.stack([(ext * y).sum(), (x * gx).sum()])
    res["ghost_x"], res["ghost_ext"] = x.detach(), ext.detach()

    # Training at window 0, with and without density.
    tm, draws = _train_mconf(), _draws()
    for name in TRAIN:
        batch_l = shard_batch(_batch(inp, name), mesh, device="cpu")
        for fault in (False, True):
            model = _model(inp, tm)
            params = [p for _, p in model.jax_named_parameters()]
            if fault:
                with rs.dropped_adjoint():
                    total, terms = loss_fn_sharded(model, batch_l, None, tm,
                                                   N_FUTURE, mesh,
                                                   draws=draws)
                    grads = torch.autograd.grad(total, params)
            else:
                total, terms = loss_fn_sharded(model, batch_l, None, tm,
                                               N_FUTURE, mesh, draws=draws)
                grads = torch.autograd.grad(total, params)
            grads, terms = tr._mean_over(dist.group.WORLD, grads, terms,
                                         tr._replicas(mesh))
            pre = f"train_{name}_{'fault_' if fault else ''}"
            res.update({f"{pre}grad_{i}": g for i, g in enumerate(grads)})
            res.update({f"{pre}term_{k}": v for k, v in terms.items()})
        state = tr.init_train_state(0, tm, "cpu", model=_model(inp, tm))
        state, t = tr.train_step(state, batch_l, None, tm, N_FUTURE,
                                 draws=draws, mesh=mesh)
        res[f"train_{name}_step_total"] = t["total"]
        res.update({f"train_{name}_param_{i}": p.detach()
                    for i, p in enumerate(state.params)})

    # A 2-D state: refused.
    st = ss.shard_state(_state(inp, "slow"), mesh)
    st = st.replace(u=st.u[:, :2, :1], p=st.p[:, :, :1],
                    flags=st.flags[:, :, :1], density=st.density[:, :, :1])
    try:
        ss.simulate_z_sharded(st, _mconf("w0_maccormackOurs"), mesh,
                              _model(inp, _mconf("w0_maccormackOurs")))
        res["err_2d"] = np.array("")
    except NotImplementedError as e:
        res["err_2d"] = np.array(f"NotImplementedError: {e}")
    return res


def _worker_main(rank, port, in_path, out_path):
    torch.set_num_threads(1)
    res = _worker(rank, port, dict(np.load(in_path)))
    np.savez(out_path, **{k: v.detach().numpy() if torch.is_tensor(v)
                          else v for k, v in res.items()})
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# --- the pytest side --------------------------------------------------------

def _spawn(tmp, in_path):
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        out = os.path.join(tmp, f"rank{rank}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(port),
             in_path, out], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
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
    flags[..., 29:35, 2:5, 3:6] = 2        # across the cut at z 32
    flags[..., 62:67, 4:7, 1:4] = 2        # across the cut at z 64
    return flags


def _inputs():
    """The numpy inputs, the model's weights from random_model's seed
    (JAX's params tree takes them in _jax_worker)."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.models.fluidnet import random_model

    rng = np.random.default_rng(200)
    B, _, Z, Y, X = SHAPE
    u = rng.standard_normal((B, 3, Z, Y, X)).astype(np.float32)
    inp = {"flags": _flags(), "u_nod": u * 0.5,
           "u_slow": u * U_SLOW,
           "p": (rng.standard_normal(SHAPE) * 0.1).astype(np.float32),
           "density": rng.random(SHAPE).astype(np.float32)}
    inp["u_fast"] = inp["u_slow"].copy()
    inp["u_fast"][:, 2] += FAST_UZ
    net = random_model(ModelConfig(**KNOBS), 3, "cpu")
    for name, p in net.jax_named_parameters():
        inp[f"param_{name}"] = p.detach().numpy()
    return inp


def _jax_worker(in_path, out_path, names):
    """JAX's unsharded rollout of each case of `names` (the suite's knobs,
    set in the environment by tests/conftest.py), in threads, its params
    tree holding the inputs' weights; written to out_path."""
    import jax
    import jax.numpy as jnp
    from fluidnet_tpu.core.config import ModelConfig as JModelConfig
    from fluidnet_tpu.core.grids import FluidState as JFluidState
    from fluidnet_tpu.models.fluidnet import apply_model, init_model
    from fluidnet_tpu.sim.simulate import create_plume_bcs, rollout

    inp = dict(np.load(in_path))
    params = init_model(jax.random.PRNGKey(0), JModelConfig(**KNOBS))
    for key, value in inp.items():
        if key.startswith("param_"):
            *path, leaf = key[len("param_"):].split("/")
            tree = params
            for k in path:
                tree = tree[int(k)] if isinstance(tree, list) else tree[k]
            tree[int(leaf) if isinstance(tree, list) else leaf] = \
                jnp.asarray(value)

    def run(name):
        m = JModelConfig(**KNOBS).replace(**CASES[name][0])
        kind, steps = CASES[name][1:]
        state = JFluidState(
            u=jnp.asarray(inp[f"u_{kind}"]), p=jnp.asarray(inp["p"]),
            flags=jnp.asarray(inp["flags"]),
            density=None if kind == "nod" else jnp.asarray(inp["density"]))
        bcs = None if kind == "nod" else create_plume_bcs(
            state, [1.0], u_scale=0.6, rad=0.15)
        net = m.sim_method == "convnet"
        out = rollout(state, m, steps,
                      (lambda pr, p, u, f, **kw: apply_model(pr, m, p, u, f,
                                                             **kw))
                      if net else None, params if net else None, bcs)
        return {k: np.asarray(getattr(out, k)) for k in
                ("u", "p", "density") if getattr(out, k) is not None}

    with ThreadPoolExecutor(len(names)) as pool:
        futs = {name: pool.submit(run, name) for name in names}
        np.savez(out_path, **{f"{name}__{k}": v for name, f in futs.items()
                              for k, v in f.result().items()})


def _port_refs(inp):
    """The port's unsharded rollouts, one step of each case (recording
    the ConvNet's inputs) and the training references, on one thread as
    the ranks run (CPU convolutions and reductions round by the thread
    count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _port_refs_1(inp)
    finally:
        torch.set_num_threads(threads)


def _port_refs_1(inp):
    from fluidnet_tpu_torch.sim.simulate import rollout, simulate
    from fluidnet_tpu_torch.train import train as tr
    ref = {}
    for name, (_, kind, steps) in CASES.items():
        m = _mconf(name)
        net = _model(inp, m) if m.sim_method == "convnet" else None
        st = _state(inp, kind)
        out = rollout(st, m, steps, net, _bcs(st))
        ref[name] = {k: getattr(out, k) for k in ("u", "p", "density")
                     if getattr(out, k) is not None}
        if net is not None:
            rec = _Recorder(net)
            out = simulate(st, m, rec, _bcs(st))
            ref[f"step1_{name}_u"], ref[f"step1_{name}_div"] = rec.seen
        else:
            out = simulate(st, m, None, _bcs(st))
            ref[f"step1_{name}_u"], ref[f"step1_{name}_p"] = out.u, out.p
        ref[f"one_{name}_u"] = out.u
    tm, draws = _train_mconf(), _draws()
    for name in TRAIN:
        model = _model(inp, tm)
        total, terms = tr.loss_fn(model, _batch(inp, name), None, tm,
                                  N_FUTURE, draws=draws)
        ref[f"train_{name}"] = {
            "grads": torch.autograd.grad(total, [
                p for _, p in model.jax_named_parameters()]),
            "terms": {k: float(v.detach()) for k, v in terms.items()}}
        # One process's train_step: the optimizer's update of those
        # gradients (the reject guard is off).
        state = tr.init_train_state(0, tm, "cpu", model=_model(inp, tm))
        updates, _ = tr.make_optimizer(tm).update(
            ref[f"train_{name}"]["grads"], state.opt_state)
        ref[f"train_{name}"].update(
            step_total=float(total.detach()),
            params=[(p + u).detach() for p, u in zip(state.params,
                                                     updates)])
    return ref


# JAX's references run in JAX_PROCS processes of this file (its tracing
# holds the GIL, so threads of one process trace in turn).
JAX_PROCS = 3


def _spawn_jax(tmp, in_path):
    procs, names = [], list(CASES)
    for i in range(JAX_PROCS):
        out = os.path.join(tmp, f"jax{i}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "jax", in_path, out,
             ",".join(names[i::JAX_PROCS])],
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX references, the port's references, [rank results])."""
    tmp = str(tmp_path_factory.mktemp("torch_sharded_exact"))
    inp = _inputs()
    in_path = os.path.join(tmp, "inputs.npz")
    np.savez(in_path, **inp)
    procs = _spawn(tmp, in_path)
    jprocs = _spawn_jax(tmp, in_path)
    try:
        pref = _port_refs(inp)
    finally:
        outs = _collect(procs)
        jouts = _collect(jprocs)
    jref = {}
    for o in jouts:
        for key, v in o.items():
            name, k = key.split("__")
            jref.setdefault(name, {})[k] = v
    return inp, jref, pref, outs


def _gather(outs, key):
    return np.concatenate([o[key] for o in outs], axis=2)


def _port_err(got, want):
    """(max |got - want|, the share of cells past PORT_ROUND), both over
    max |want|."""
    want = np.asarray(want)
    err = np.abs(got - want) / max(float(np.abs(want).max()), 1e-30)
    return float(err.max()), float((err > PORT_ROUND).mean())


def _within_port(got, want):
    m, f = _port_err(got, want)
    return m <= PORT_MAX and f <= PORT_FRAC


def _rel(a, b):
    return float(np.linalg.norm((a - b).ravel()) /
                 max(np.linalg.norm(np.asarray(b).ravel()), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_rollout_matches_jax(run, name):
    """The gathered slabs after 2 steps against JAX's unsharded rollout:
    rtol 1e-4, atol 1e-5."""
    _, jref, _, outs = run
    for k, want in jref[name].items():
        got = _gather(outs, f"{name}_{k}")
        print(f"{name} {k}: vs JAX, max abs err "
              f"{np.abs(got - want).max():.3e}")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_rollout_matches_port(run, name):
    """The gathered slabs against the port's unsharded rollout: within
    PORT_MAX of the field's largest value, at most PORT_FRAC of the cells
    past PORT_ROUND of it; a state without density stays without."""
    _, _, pref, outs = run
    assert set(pref[name]) == ({"u", "p"} if CASES[name][1] == "nod"
                               else {"u", "p", "density"})
    for k, want in pref[name].items():
        m, f = _port_err(_gather(outs, f"{name}_{k}"), want)
        print(f"{name} {k}: vs the port's unsharded rollout, max {m:.3e} "
              f"of the field's max, share past {PORT_ROUND} {f:.3e}")
        assert m <= PORT_MAX and f <= PORT_FRAC, (name, k, m, f)
    for o in outs:
        assert f"{name}_density" not in o or CASES[name][1] != "nod"


@pytest.mark.parametrize("name", list(CASES))
def test_first_step_is_bit_equal(run, name):
    """Every rank's own planes after one step equal the port's whole
    grid's to the bit: the u (and K2's divergence) the ConvNet gets,
    through the advection at the slab's z origin (the exact route's too)
    and K2 or gravity and K4; jacobi-8's whole step (u, p)."""
    _, _, pref, outs = run
    zl = SHAPE[2] // WORLD
    keys = [k for k in pref if k.startswith(f"step1_{name}_")]
    assert keys
    for r, o in enumerate(outs):
        for key in keys:
            want = pref[key].numpy()
            if want.size:
                want = want[:, :, r * zl:(r + 1) * zl]
            np.testing.assert_array_equal(o[key], want, f"rank {r} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_simulate_z_sharded_grad(run, name):
    """simulate_z_sharded(grad=True), one step, gathered: within PORT_MAX
    of the port's unsharded step (PORT_FRAC past PORT_ROUND)."""
    _, _, pref, outs = run
    m, f = _port_err(_gather(outs, f"grad1_{name}_u"),
                     pref[f"one_{name}_u"])
    print(f"{name}: grad=True step's u vs the port's, max {m:.3e}, share "
          f"{f:.3e}")
    assert m <= PORT_MAX and f <= PORT_FRAC, (m, f)


def test_ghost_zones_and_hops(run):
    """The ranks' ghost zones at window 0: 27 for maccormackOurs and 18
    for eulerOurs (one rank a side); Manta's euler from the grid's dt
    max|u_z| (ghost_planes), past a slab's 32 planes, so the end ranks
    take planes from two ranks. The collectives a rollout: the flags'
    exchange at its start and one a step; an all_reduce MAX a step where
    G depends on u (not for eulerOurs), the input scale's 2."""
    from fluidnet_tpu_torch.parallel.simulate_sharded import ghost_planes
    inp, _, _, outs = run
    vz = float(np.abs(inp["u_fast"][:, 2]).max())
    g_fast = ghost_planes(_mconf("w0_euler"), vz * FAST_DT)
    assert 32 < g_fast < 64
    for o in outs:
        assert int(o["w0_maccormackOurs_ghost"]) == 27
        assert int(o["w0_eulerOurs_ghost"]) == 18
        assert int(o["w0_euler_ghost"]) == g_fast
        assert list(o["w0_maccormackOurs_comms"]) == [1 + N_STEPS,
                                                      3 * N_STEPS]
        assert list(o["w0_eulerOurs_comms"]) == [1 + N_STEPS, 2 * N_STEPS]
        assert list(o["w0_euler_comms"]) == [2, 3]


@pytest.mark.parametrize("name", FAULTS)
def test_planted_ghost_fault_fails(run, name):
    """Step 2's ghost planes zeroed (at two hops for Manta's euler): the
    comparisons against JAX's rollout and the port's fail."""
    _, jref, pref, outs = run
    got = _gather(outs, f"fault_{name}_u")
    print(f"{name} fault: vs the port (max, share) "
          f"{_port_err(got, pref[name]['u'])}")
    assert not np.allclose(got, jref[name]["u"], rtol=RTOL, atol=ATOL)
    assert not _within_port(got, pref[name]["u"])


def test_exchange_two_hops_and_adjoint(run):
    """exchange_ghost of 7 planes on slabs of 5 (two ranks a side where
    the grid allows, one-sided at its ends): each rank's extended slab is
    the whole grid's planes around it, and summed over the ranks <E x, y>
    equals <x, E^T y> (float64, rtol 1e-12)."""
    _, _, _, outs = run
    whole = np.concatenate([o["ghost_x"] for o in outs], axis=2)
    zl, Z = 5, 5 * WORLD
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(
            o["ghost_ext"], whole[:, :, max(r * zl - 7, 0):
                                  min((r + 1) * zl + 7, Z)])
    dots = sum(o["dot_ghost"] for o in outs)
    np.testing.assert_allclose(dots[0], dots[1], rtol=1e-12)


@pytest.mark.parametrize("name", TRAIN)
def test_sharded_training_at_window_0(run, name):
    """The sharded loss at window 0 (m3d_v5's loss flags, horizon 2; with
    and without density), reduced as train_step(mesh=) reduces it,
    against the port's one-process loss_fn: terms within rtol 1e-5, every
    gradient within 1e-5 relative L2 (CANCEL); train_step(mesh=)'s total
    and params against one process's train_step the same. The dropped
    adjoint (no ghost plane's cotangent sent back) fails the gradients."""
    _, _, pref, outs = run
    ref = pref[f"train_{name}"]
    whole = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in ref["grads"]))

    def err(got, want):
        want = want.numpy()
        return float(np.linalg.norm(got - want) /
                     max(np.linalg.norm(want), CANCEL * whole))
    for o in outs:
        for k, v in ref["terms"].items():
            np.testing.assert_allclose(o[f"train_{name}_term_{k}"], v,
                                       rtol=TRAIN_RTOL, atol=1e-8,
                                       err_msg=k)
        worst = max(err(o[f"train_{name}_grad_{i}"], g)
                    for i, g in enumerate(ref["grads"]))
        fault = max(err(o[f"train_{name}_fault_grad_{i}"], g)
                    for i, g in enumerate(ref["grads"]))
        print(f"{name}: gradients' worst relative L2 {worst:.3e}, the "
              f"dropped adjoint's {fault:.3e}")
        assert worst <= GRAD_REL and fault > GRAD_REL, (worst, fault)
        np.testing.assert_allclose(o[f"train_{name}_step_total"],
                                   ref["step_total"], rtol=TRAIN_RTOL)
        for i, p in enumerate(ref["params"]):
            assert _rel(o[f"train_{name}_param_{i}"], p.numpy()) <= \
                GRAD_REL, i


def test_2d_refused(run):
    """A 2-D state raises NotImplementedError saying why: JAX's spatial
    sharding splits axis 2, which a 2-D state holds at one plane."""
    _, _, _, outs = run
    for o in outs:
        msg = str(o["err_2d"])
        assert msg.startswith("NotImplementedError") and "axis 2" in msg, \
            msg


# --- without JAX or ranks ---------------------------------------------------

def _reach(fn, u, s, k):
    """The farthest plane from plane k that output plane k of fn(s, u)
    reads (a nonzero gradient of its sum)."""
    s = s.clone().requires_grad_(True)
    u = u.clone().requires_grad_(True)
    grads = torch.autograd.grad(fn(s, u)[:, :, k].sum(), [s, u],
                                allow_unused=True)
    far = 0
    for g in grads:
        if g is not None:
            read = g.abs().sum((0, 1, 3, 4)).nonzero().flatten()
            far = max(far, int((read - k).abs().max()))
    return far


# (method, the probe's dt u_z below and above plane MID - 4, the reach it
# must show, advection_reach's bound less it: the bound's slack). A ray
# of whole planes lands on a corner with weight 1 and reads the next one
# with weight 0, and ceil(d) + 1 covers that read and the rounding of a
# trace's end: the slack of the traces.
PROBES = {
    # Flow that turns: the backward trace runs 8 planes down, the forward
    # from there 8 more: 16 of 18.
    "maccormackOurs": ("maccormackOurs", 9.0, -9.0, 16, 2),
    # At dt max|u_z| = 20 the velocity clamp's corners (min and max, no
    # weights) lie floor(20) + 1 = 21 planes away, past the traces' 18:
    # the bound is met.
    "maccormackOurs_fast": ("maccormackOurs", 20.0, 20.0, 21, 0),
    "rk2Ours": ("rk2Ours", 9.0, -9.0, 16, 2),
    "eulerOurs": ("eulerOurs", 9.0, 9.0, 8, 1),
    "euler": ("euler", 20.5, 20.5, 21, 1),
    "maccormack": ("maccormack", 20.5, -20.5, 42, 2),
}


@pytest.mark.parametrize("name", list(PROBES))
def test_exact_reach_probe(name):
    """The exact route's reach, probed: on a z flow of dt u_z as PROBES
    gives it (walls around, random density), the farthest plane that
    output plane MID of the advection (density and velocity) reads lies
    advection_reach's bound less its stated slack away, never past the
    bound."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.ops.advect import advect_scalar, advect_vel
    from fluidnet_tpu_torch.parallel.simulate_sharded import advection_reach
    method, below, above, want, slack = PROBES[name]
    m = ModelConfig(**KNOBS).replace(advection_window=0,
                                     advection_method=method)
    Z, mid, dt = SHAPE[2], SHAPE[2] // 2, 0.1
    flags = torch.ones(SHAPE, dtype=torch.int32)
    flags[:, :, [0, -1]] = 2
    flags[:, :, :, [0, -1]] = 2
    flags[..., [0, -1]] = 2
    u = torch.zeros((1, 3, Z) + SHAPE[3:])
    u[:, 2, :mid - 4], u[:, 2, mid - 4:] = below / dt, above / dt
    s = torch.from_numpy(np.random.default_rng(5).random(
        (1, 1, Z) + SHAPE[3:]).astype(np.float32))
    got = max(_reach(lambda s, u: advect_scalar(dt, s, u, flags, method,
                                                window=0), u, s, mid),
              _reach(lambda s, u: advect_vel(dt, u, flags, method,
                                             window=0), u, s, mid))
    bound = advection_reach(m, max(abs(below), abs(above)))
    print(f"{name}: reads {got} planes; advection_reach {bound}")
    assert got == want == bound - slack


def test_ghost_planes_at_window_0():
    """G at window 0: the default model 27, tog 40, jacobi-n and PCG 24
    (maccormackOurs, while dt max|u_z| <= 17), eulerOurs 18; Manta's
    euler and maccormack from dt max|u_z| (ceil + 1, twice for
    maccormack); the W >= 1 zones as before."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.parallel.simulate_sharded import (ghost_planes,
                                                              reach_of_data)
    m = ModelConfig(**KNOBS).replace(advection_window=0)
    assert ghost_planes(m) == ghost_planes(m, 17.0) == 27
    assert ghost_planes(m, 17.5) == 28
    assert ghost_planes(m.replace(model_type="tog")) == 40
    assert ghost_planes(m.replace(sim_method="jacobi")) == 24
    assert ghost_planes(m.replace(sim_method="pcg")) == 24
    e = m.replace(advection_method="eulerOurs")
    assert ghost_planes(e) == ghost_planes(e, 100.0) == 18
    assert not reach_of_data(e) and reach_of_data(m)
    manta = m.replace(advection_method="euler")
    assert ghost_planes(manta, 35.2) == 36 + 1 + 9
    assert ghost_planes(manta.replace(advection_method="maccormack"),
                        3.0) == 2 * 4 + 9
    assert ghost_planes(m.replace(advection_window=1)) == 13
    assert not reach_of_data(m.replace(advection_window=1))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "jax":
        _jax_worker(sys.argv[2], sys.argv[3], sys.argv[4].split(","))
    else:
        _worker_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                     sys.argv[4])
