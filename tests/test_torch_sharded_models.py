"""The pooled and banked ConvNets of the PyTorch port on the z-sharded
rollout (parallel/simulate_sharded.py) and in sp-sharded training
(parallel/train_sharded.py), against JAX's unsharded rollout and loss_fn
and the port's own, on the CPU with gloo.

The pytest process makes every input with numpy from a seed: one (B=1,
Z=64, Y=8, X=8) plume state with a random velocity, pressure and density
and an obstacle box across the cut at z = 32, create_plume_bcs's masks,
and for each model of MODELS random float32 weights (random_model, from
a seed) that JAX's params tree carries over, plus the draws of a JAX key
that turns buoyancy and vorticity on. This file, run as a script, is the
worker: one spawn of 2 gloo ranks on a 1 x 2 ('dp', 'sp') mesh (zl = 32)
runs every case while the JAX references compute in threads. Each rank
writes its results to an npz.

Held: 3 steps of rollout_z_sharded of each model (bench knobs:
maccormackOurs, W = 1; tog's G 28, mres_bn_skip's 16, dilate3's 19),
gathered, against JAX's unsharded rollout at rtol 1e-4, atol 1e-5 and the
port's unsharded rollout within tests/test_torch_sharded_sim.py's
PORT_MAX / PORT_FRAC; tog's sharded loss_fn at n = 1 (m3d_v5's loss
flags) against JAX's value_and_grad (terms rtol 1e-4, gradients 1e-4
relative L2), tog's and mres_bn_skip's against the port's one-process
loss_fn (terms rtol 1e-5, gradients 1e-4; CANCEL below); a planted fault
that must fail those limits (torch_parallel_rank.misaligned_trunk: the
trunk one plane off the pooling factor's multiples); the ghost zones and
pooling factors of the models. Without JAX or ranks: a probe of the
trunk's reach (for each model of REACH the farthest plane that one output
plane of the trunk reads, by autograd, is at most trunk_reach and more
than trunk_reach less pool_factor), and one of the whole step's: the
farthest plane that one output plane of an unsharded step reads, by
autograd with the input scale (all_reduced on slabs) held constant, lies
within ghost_planes, and past the ghost zone that sums the trunk's conv
radii at full resolution, as the sharded step did before it counted
pools and dilations (the planted short ghost zone: for tog 16 planes
against a reach of 22).

A ghost zone one pooling factor short is no fault a test can plant:
ghost_planes bounds each stage's reach alone (the advection's 2W + 2 and
K2's 4 are more than the step reads), so tog's G - F = 24 still covers
the step's 22 planes, and the sharded rollout with it reads what the
right one reads. With random weights even 16 planes read the same to
1.9e-05 of p's largest value: a conv's outermost taps carry ~1/5 of its
gain, so what the trunk reads 16 planes away weighs ~1e-6.
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
SHAPE = (1, 1, 64, 8, 8)
N_STEPS = 3
N_FUTURE = 1
RTOL, ATOL = 1e-4, 1e-5
PORT_MAX, PORT_ROUND, PORT_FRAC = 1e-5, 1e-6, 1e-3
JAX_RTOL, PORT_RTOL, GRAD_REL = 1e-4, 1e-5, 1e-4
KNOBS = dict(is_3d=True, sim_method="convnet", dt=0.1, buoyancy_scale=2.0,
             vorticity_confinement_amp=3.0, maccormack_strength=0.6,
             advection_method="maccormackOurs", adaptive_window=False,
             advection_window=1, conv_compute_dtype="float32")
M3D_V5 = dict(is_3d=True, advection_method="maccormackOurs",
              adaptive_window=False, advection_window=1,
              maccormack_strength=0.75, train_buoyancy_prob=0.5,
              train_buoyancy_scale=2.0,
              train_vorticity_confinement_prob=0.3,
              train_vorticity_confinement_amp=3.0, long_term_div_lambda=1.0,
              long_term_grad_mode="full", loss_div_lambda=1.0,
              loss_func_border_weight=4.0, loss_func_border_width=3,
              loss_reject_threshold=0.0, conv_compute_dtype="float32")
MODELS = {"tog": dict(model_type="tog"),
          "mres_bn_skip": dict(banks_num=2, add_batch_norm=True,
                               add_pressure_skip=True),
          "dilate3": dict(banks_num=3, banks_type="dilate",
                          banks_aggregate_method="add")}
TRAIN = ("tog", "mres_bn_skip")
# Gradients: a parameter whose one-process gradient is under CANCEL of
# the whole gradient's norm is a sum that cancels to float32's rounding
# (mres_bn_skip's final bias and its last batch norm's bias and mean: a
# constant shift of p leaves u as it is, 4e-8 of the norm): it is held
# within GRAD_REL of CANCEL times the whole gradient's norm.
CANCEL = 1e-3
TERMS = ("total", "p", "u", "div", "long_term_div")
DRAWS = ("dt", "gravity", "b_scale", "g_scale", "v_amp")
# Each model's (G at W = 1, training's model_ghost, pooling factor).
ZONES = {"default": ({}, 13, 8, 1), "tog": (MODELS["tog"], 28, 24, 4),
         "mres_bn_skip": (MODELS["mres_bn_skip"], 16, 12, 2),
         "dilate3": (MODELS["dilate3"], 19, 14, 1)}
# The probe's models (the trunk reach each measured, in planes).
REACH = {"tog": dict(model_type="tog"),
         "mres2": dict(banks_num=2),
         "mres3": dict(banks_num=3),
         "mres2_bn_skip": MODELS["mres_bn_skip"],
         "dilate2": dict(banks_num=2, banks_type="dilate"),
         "dilate3": dict(banks_num=3, banks_type="dilate"),
         "tog_mres2": dict(model_type="tog", banks_num=2)}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --- shared by the worker and the pytest side (no JAX) ----------------------

def _mconf(name):
    from fluidnet_tpu_torch.core.config import ModelConfig
    return ModelConfig(**KNOBS).replace(**MODELS[name])


def _train_mconf(name):
    from fluidnet_tpu_torch.core.config import ModelConfig
    return ModelConfig(**M3D_V5).replace(**MODELS[name])


def _state(inp):
    from fluidnet_tpu_torch.core.grids import FluidState
    return FluidState(**{k: torch.from_numpy(inp[k])
                         for k in ("u", "p", "flags", "density")})


def _bcs(state):
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs
    return create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)


def _batch(inp):
    return {"flags": torch.from_numpy(inp["flags"]),
            "u_div": torch.from_numpy(inp["u"]),
            "p_div": torch.from_numpy(inp["p"]),
            "density": torch.from_numpy(inp["density"])}


def _draws(inp):
    from fluidnet_tpu_torch.train.train import Draws
    return Draws(*(torch.tensor(inp[f"draw_{k}"]) for k in DRAWS))


def _model(inp, name, mconf):
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    net = FluidNet(mconf, device="cpu")
    with torch.no_grad():
        for k, p in net.jax_named_parameters():
            p.copy_(torch.from_numpy(inp[f"param_{name}/{k}"]))
    return net


def _named(name):
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    return [k for k, _ in FluidNet(_mconf(name),
                                   device="cpu").jax_named_parameters()]


# --- the worker (run as a script; imports no JAX) ---------------------------

def _worker(rank, port, inp):
    import torch.distributed as dist
    from fluidnet_tpu_torch.parallel import simulate_sharded as ss
    from fluidnet_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from fluidnet_tpu_torch.parallel.multihost import init_multihost
    from fluidnet_tpu_torch.parallel.train_sharded import loss_fn_sharded
    from fluidnet_tpu_torch.train import train as tr

    assert init_multihost(f"127.0.0.1:{port}", 2, rank, device_type="cpu")
    mesh = make_mesh(n_dp=1, n_sp=2, device_type="cpu")
    rs = _rank_script()
    state = _state(inp)
    state_l = ss.shard_state(state, mesh)
    bcs_l = ss.shard_bcs(_bcs(state), mesh)
    res = {}
    for name in MODELS:
        m = _mconf(name)
        out = ss.rollout_z_sharded(state_l, m, N_STEPS, mesh,
                                   _model(inp, name, m), bcs_l)
        res.update({f"{name}_{k}": getattr(out, k)
                    for k in ("u", "p", "density")})
    m = _mconf("tog")
    with rs.misaligned_trunk():
        out = ss.rollout_z_sharded(state_l, m, N_STEPS, mesh,
                                   _model(inp, "tog", m), bcs_l)
    res.update({f"misaligned_{k}": getattr(out, k)
                for k in ("u", "p", "density")})

    batch_l = shard_batch(_batch(inp), mesh, device="cpu")
    for key, name, fault in [(n, n, None) for n in TRAIN] + [
            ("misaligned", "tog", "misaligned")]:
        tm = _train_mconf(name)
        model = _model(inp, name, tm)
        with rs.planted(fault, rank):
            total, terms = loss_fn_sharded(model, batch_l, None, tm,
                                           N_FUTURE, mesh,
                                           draws=_draws(inp))
            grads = torch.autograd.grad(total, [
                q for _, q in model.jax_named_parameters()])
        grads, terms = tr._mean_over(dist.group.WORLD, grads, terms,
                                     tr._replicas(mesh))
        res.update({f"train_{key}_grad_{k}": g
                    for k, g in zip(_named(name), grads)})
        res.update({f"train_{key}_term_{k}": v for k, v in terms.items()})
    return res


def _rank_script():
    """scripts/torch_parallel_rank.py as a module (its planted faults)."""
    import importlib.util
    path = os.path.join(REPO, "scripts", "torch_parallel_rank.py")
    spec = importlib.util.spec_from_file_location("torch_parallel_rank",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    for rank in range(2):
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
    flags[..., 29:35, 2:5, 3:6] = 2        # a box across the cut at z 32
    return flags


def _jax_tree(inp, name):
    """The JAX params pytree of a model from its weights in `inp`
    (init_model's layout: stages[i][ib]["conv"], bn[i] or None,
    final["conv"])."""
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    net = FluidNet(_mconf(name), device="cpu")
    tree = {"stages": [[{"conv": {}} for _ in convs] for convs in net.stages],
            "bn": [None] * len(net.stages), "final": {"conv": {}}}
    for k in _named(name):
        parts, leaf = k.split("/"), inp[f"param_{name}/{k}"]
        if parts[0] == "stages":
            tree["stages"][int(parts[1])][int(parts[2])]["conv"][
                parts[4]] = leaf
        elif parts[0] == "bn":
            tree["bn"][int(parts[1])] = dict(tree["bn"][int(parts[1])] or {},
                                             **{parts[2]: leaf})
        else:
            tree["final"]["conv"][parts[2]] = leaf
    return tree


def _inputs():
    """The inputs of every side (each model's random weights, drawn by
    random_model from a seed), each model's JAX params and the key."""
    import jax
    from fluidnet_tpu.core.config import ModelConfig as JModelConfig
    from fluidnet_tpu.train import train as jtrain
    from fluidnet_tpu_torch.models.fluidnet import random_model

    rng = np.random.default_rng(190)
    B, _, Z, Y, X = SHAPE
    inp = {"flags": _flags(),
           "u": (rng.standard_normal((B, 3, Z, Y, X)) * 0.5).astype(
               np.float32),
           "p": (rng.standard_normal(SHAPE) * 0.1).astype(np.float32),
           "density": rng.random(SHAPE).astype(np.float32)}
    for i, name in enumerate(MODELS):
        net = random_model(_mconf(name), 20 + i, "cpu")
        inp.update({f"param_{name}/{k}": p.detach().numpy().copy()
                    for k, p in net.jax_named_parameters()})
    params = {name: _jax_tree(inp, name) for name in MODELS}
    jm = JModelConfig(**M3D_V5)
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        kdt, kforce = jax.random.split(key)
        forces = jtrain._random_forces(kforce, jm)
        if float(forces[1]) > 0 and float(forces[3]) > 0:
            break
    for k, v in zip(DRAWS, (jtrain._random_dt(kdt, jm),) + tuple(forces)):
        inp[f"draw_{k}"] = np.asarray(v, np.float32)
    return inp, params, key


def _jax_rollout(inp, params, name):
    """JAX's unsharded rollout of a model (the suite's knobs)."""
    import jax.numpy as jnp
    from fluidnet_tpu.core.config import ModelConfig as JModelConfig
    from fluidnet_tpu.core.grids import FluidState as JFluidState
    from fluidnet_tpu.models.fluidnet import apply_model
    from fluidnet_tpu.sim.simulate import create_plume_bcs, rollout

    m = JModelConfig(**KNOBS).replace(**MODELS[name])
    state = JFluidState(**{k: jnp.asarray(inp[k]) for k in
                           ("u", "p", "flags", "density")})
    bcs = create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)
    out = rollout(state, m, N_STEPS,
                  lambda pr, p, u, f, **kw: apply_model(pr, m, p, u, f, **kw),
                  params[name], bcs)
    return {k: np.asarray(getattr(out, k)) for k in ("u", "p", "density")}


def _jax_loss(inp, params, key):
    """JAX's value_and_grad of loss_fn for tog on the whole batch."""
    import jax
    import jax.numpy as jnp
    from fluidnet_tpu.core.config import ModelConfig as JModelConfig
    from fluidnet_tpu.train import train as jtrain

    batch = {"flags": jnp.asarray(inp["flags"]),
             "u_div": jnp.asarray(inp["u"]), "p_div": jnp.asarray(inp["p"]),
             "density": jnp.asarray(inp["density"])}
    jm = JModelConfig(**M3D_V5).replace(**MODELS["tog"])
    vg = jax.jit(jax.value_and_grad(jtrain.loss_fn, has_aux=True),
                 static_argnames=("mconf", "n_future"))
    (_, terms), grads = vg(params["tog"], batch, key, jm, N_FUTURE)
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _port_refs(inp):
    """The port's unsharded rollouts and one-process loss_fn gradients, on
    one thread as the ranks run (the CPU convolutions and reductions round
    by the thread count)."""
    from fluidnet_tpu_torch.sim.simulate import rollout
    from fluidnet_tpu_torch.train import train as tr
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = _state(inp)
        ref = {}
        for name in MODELS:
            m = _mconf(name)
            out = rollout(state, m, N_STEPS, _model(inp, name, m),
                          _bcs(state))
            ref[name] = {k: getattr(out, k).numpy()
                         for k in ("u", "p", "density")}
        for name in TRAIN:
            tm = _train_mconf(name)
            model = _model(inp, name, tm)
            total, terms = tr.loss_fn(model, _batch(inp), None, tm,
                                      N_FUTURE, draws=_draws(inp))
            grads = torch.autograd.grad(total, [
                q for _, q in model.jax_named_parameters()])
            ref[f"train_{name}"] = {
                "terms": {k: float(v.detach()) for k, v in terms.items()},
                "grads": {k: g.numpy() for k, g in zip(_named(name),
                                                       grads)}}
        return ref
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(JAX's references, the port's references, [rank results])."""
    tmp = str(tmp_path_factory.mktemp("torch_sharded_models"))
    inp, params, key = _inputs()
    in_path = os.path.join(tmp, "inputs.npz")
    np.savez(in_path, **inp)
    procs = _spawn(tmp, in_path)
    try:
        with ThreadPoolExecutor(len(MODELS) + 1) as pool:
            loss = pool.submit(_jax_loss, inp, params, key)
            rolls = {name: pool.submit(_jax_rollout, inp, params, name)
                     for name in MODELS}
            pref = _port_refs(inp)
            jref = {name: f.result() for name, f in rolls.items()}
            jref["train_tog"] = loss.result()
    finally:
        outs = _collect(procs)
    return jref, pref, outs


def _gather(outs, key):
    return np.concatenate([o[key] for o in outs], axis=2)


def _port_err(got, want):
    """(max |got - want|, the share of cells past PORT_ROUND), both over
    max |want|."""
    err = np.abs(got - want) / max(float(np.abs(want).max()), 1e-30)
    return float(err.max()), float((err > PORT_ROUND).mean())


def _within_port(got, want):
    m, f = _port_err(got, want)
    return m <= PORT_MAX and f <= PORT_FRAC


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) /
                 max(np.linalg.norm(want), 1e-30))


def _jax_leaf(tree, name):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return np.asarray(tree)


def _worst_grad(o, prefix, names, want):
    return max(_rel(o[f"{prefix}{k}"], want(k)) for k in names)


@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_rollout_matches_jax(run, name):
    """The gathered slabs after 3 steps against JAX's unsharded rollout:
    rtol 1e-4, atol 1e-5."""
    jref, _, outs = run
    for k in ("u", "p", "density"):
        got = _gather(outs, f"{name}_{k}")
        print(f"{name} {k}: vs JAX, max abs err "
              f"{np.abs(got - jref[name][k]).max():.3e}")
        np.testing.assert_allclose(got, jref[name][k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_rollout_matches_port(run, name):
    """The gathered slabs against the port's unsharded rollout: within
    PORT_MAX of the field's largest value, at most PORT_FRAC of the cells
    past PORT_ROUND of it."""
    _, pref, outs = run
    for k in ("u", "p", "density"):
        m, f = _port_err(_gather(outs, f"{name}_{k}"), pref[name][k])
        print(f"{name} {k}: vs the port's unsharded rollout, max {m:.3e} "
              f"of the field's max, share past {PORT_ROUND} {f:.3e}")
        assert m <= PORT_MAX and f <= PORT_FRAC, (name, k, m, f)


def test_planted_misalignment_fails(run):
    """tog's rollout with the trunk one plane off the pooling factor's
    multiples: JAX's rollout at rtol 1e-4 / atol 1e-5 and the port's
    within PORT_MAX fail."""
    jref, pref, outs = run
    for k in ("u", "p"):
        got = _gather(outs, f"misaligned_{k}")
        print(f"misaligned {k}: vs the port's unsharded rollout (max, "
              f"share) {_port_err(got, pref['tog'][k])}")
        assert not np.allclose(got, jref["tog"][k], rtol=RTOL,
                               atol=ATOL), k
        assert not _within_port(got, pref["tog"][k]), k


def test_sharded_loss_matches_jax(run):
    """tog's sharded loss_fn at n = 1 (the ranks' shares reduced as
    train_step(mesh=) reduces them) against JAX's value_and_grad of
    loss_fn on the whole batch: terms rtol 1e-4, each parameter's
    gradient within 1e-4 relative L2."""
    jref, _, outs = run
    js = jref["train_tog"]
    for o in outs:
        for k in TERMS:
            np.testing.assert_allclose(o[f"train_tog_term_{k}"],
                                       js["terms"][k], rtol=JAX_RTOL,
                                       atol=1e-7, err_msg=k)
        w = _worst_grad(o, "train_tog_grad_", _named("tog"),
                        lambda k: _jax_leaf(js["grads"], k))
        print(f"tog: gradients' worst relative L2 vs JAX {w:.3e}")
        assert w <= GRAD_REL, w


@pytest.mark.parametrize("name", TRAIN)
def test_sharded_loss_matches_port(run, name):
    """The sharded loss_fn against the port's one-process loss_fn: terms
    rtol 1e-5, each parameter's gradient within 1e-4 relative L2, or of
    CANCEL times the whole gradient's norm where its own is a sum that
    cancels below that."""
    _, pref, outs = run
    ps = pref[f"train_{name}"]
    whole = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for g in ps["grads"].values()))
    for o in outs:
        for k in TERMS:
            np.testing.assert_allclose(o[f"train_{name}_term_{k}"],
                                       ps["terms"][k], rtol=PORT_RTOL,
                                       atol=1e-7, err_msg=k)
        for k in _named(name):
            want = ps["grads"][k]
            err = np.linalg.norm(o[f"train_{name}_grad_{k}"] - want) / max(
                np.linalg.norm(want), CANCEL * whole)
            assert err <= GRAD_REL, (k, err, np.linalg.norm(want) / whole)
        w = _worst_grad(o, f"train_{name}_grad_", _named(name),
                        lambda k: ps["grads"][k])
        print(f"{name}: gradients' worst relative L2 vs one process {w:.3e}")


def test_planted_fault_fails_training(run):
    """tog's sharded loss with the trunk one plane off the pooling
    factor's multiples: its gradients fail the 1e-4 relative L2 against
    JAX's."""
    jref, _, outs = run
    js = jref["train_tog"]
    for o in outs:
        w = _worst_grad(o, "train_misaligned_grad_", _named("tog"),
                        lambda k: _jax_leaf(js["grads"], k))
        print(f"misaligned: gradients' worst relative L2 vs JAX {w:.3e}")
        assert w > GRAD_REL, w


@pytest.mark.parametrize("name", list(ZONES))
def test_ghost_zones(name):
    """G at W = 1 (the trunk's reach plus the step's 10 planes, rounded up
    to the pooling factor), training's model_ghost (the reach plus 5,
    rounded up) and the pooling factor of each model."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.parallel.simulate_sharded import (ghost_planes,
                                                              pool_factor)
    from fluidnet_tpu_torch.parallel.train_sharded import model_ghost
    kw, g, gm, f = ZONES[name]
    m = ModelConfig(**KNOBS).replace(**kw)
    assert (ghost_planes(m), model_ghost(m), pool_factor(m)) == (g, gm, f)
    assert ghost_planes(m.replace(advection_window=2)) % f == 0


@pytest.mark.parametrize("name", list(REACH))
def test_trunk_reach_probe(name):
    """The farthest plane that any of F consecutive output planes of the
    trunk reads (a nonzero gradient of the plane's sum, random weights and
    input) lies at most trunk_reach planes away, and more than
    trunk_reach - F: the bound is met within the pooling factor."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.models.fluidnet import (num_input_channels,
                                                    random_model)
    from fluidnet_tpu_torch.parallel.simulate_sharded import (pool_factor,
                                                              trunk_reach)
    m = ModelConfig(**KNOBS).replace(**REACH[name])
    net = random_model(m, 5, "cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, num_input_channels(m), SHAPE[2], 8, 8),
                    generator=gen, requires_grad=True)
    out = net.trunk(x, x[:, :1] if m.add_pressure_skip else None)
    f, mid = pool_factor(m), SHAPE[2] // 2
    got = 0
    for z in range(mid, mid + f):
        g, = torch.autograd.grad(out[:, :, z].sum(), x, retain_graph=True)
        read = g.abs().sum((0, 1, 3, 4)).nonzero().flatten()
        got = max(got, int((read - z).abs().max()))
    print(f"{name}: measured reach {got}, trunk_reach {trunk_reach(m)}, "
          f"pool_factor {f}")
    assert trunk_reach(m) - f < got <= trunk_reach(m)


class _HeldScale(torch.nn.Module):
    """The model with its input scale computed from detached inputs."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, p, u, flags, input_scale=None, **kw):
        from fluidnet_tpu_torch.models.fluidnet import _input_scale

        def scale(mconf, *chans):
            return _input_scale(mconf, *(None if c is None else c.detach()
                                         for c in chans))
        return self.model(p, u, flags, input_scale=scale, **kw)


def _step_reach(name):
    """The farthest plane that any of max(F, 4) consecutive output planes
    of one unsharded step (u, p, density) reads of its input (u, p,
    density), by autograd, the input scale held constant."""
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.models.fluidnet import random_model
    from fluidnet_tpu_torch.parallel.simulate_sharded import pool_factor
    from fluidnet_tpu_torch.sim.simulate import simulate
    m = _mconf(name)
    model = _HeldScale(random_model(m, 5, "cpu"))
    rng = np.random.default_rng(191)
    B, _, Z, Y, X = SHAPE
    u, p, d = (torch.tensor(a, requires_grad=True) for a in (
        (rng.standard_normal((B, 3, Z, Y, X)) * 0.5).astype(np.float32),
        (rng.standard_normal(SHAPE) * 0.1).astype(np.float32),
        rng.random(SHAPE).astype(np.float32)))
    fields, flags = [u, p, d], torch.from_numpy(_flags())
    bcs = _bcs(FluidState(u=u.detach(), p=p.detach(), flags=flags,
                          density=d.detach()))
    out = simulate(FluidState(u=u, p=p, flags=flags, density=d), m, model,
                   bcs, grad=True)
    reach = 0
    for z in range(Z // 2, Z // 2 + max(pool_factor(m), 4)):
        obj = sum(getattr(out, k)[:, :, z].sum()
                  for k in ("u", "p", "density"))
        grads = torch.autograd.grad(obj, fields, retain_graph=True)
        read = sum(g.abs().sum((0, 1, 3, 4)) for g in grads).nonzero()
        reach = max(reach, int((read.flatten() - z).abs().max()))
    return reach


@pytest.mark.parametrize("name", list(MODELS))
def test_ghost_zone_covers_the_step(name):
    """G (ghost_planes) covers the planes one unsharded step reads
    (_step_reach)."""
    from fluidnet_tpu_torch.parallel.simulate_sharded import (ghost_planes,
                                                              pool_factor)
    m = _mconf(name)
    reach = _step_reach(name)
    print(f"{name}: the step reads {reach} planes; G {ghost_planes(m)}, "
          f"G - F {ghost_planes(m) - pool_factor(m)}")
    assert reach <= ghost_planes(m)


@pytest.mark.parametrize("name", ("tog", "dilate3"))
def test_planted_short_ghost_zone_fails(name):
    """The ghost zone from the trunk's conv radii summed at full
    resolution (rounded up to the pooling factor), as the sharded step
    counted before pools and dilations: short of the planes the step
    reads for tog (16 against 22) and dilate3 (13 against 15)."""
    from fluidnet_tpu_torch.models.fluidnet import layer_spec
    from fluidnet_tpu_torch.parallel.simulate_sharded import pool_factor
    m = _mconf(name)
    radii = sum((k - 1) // 2 for k in layer_spec(m)[1])
    short = -(-(2 * m.advection_window + 2 + 4 + radii + 2) //
              pool_factor(m)) * pool_factor(m)
    reach = _step_reach(name)
    print(f"{name}: the step reads {reach} planes; the radius sum's G "
          f"{short}")
    assert short < reach


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                 sys.argv[4])
