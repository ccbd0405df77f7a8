"""The z-sharded simulation step of the PyTorch port
(parallel/simulate_sharded.py) against JAX's unsharded rollout and the
port's own, on the CPU with gloo.

The pytest process makes every input with numpy from a seed: a (B=2, Z=32,
Y=16, X=16) plume state (Z the longest axis, so a dx read from a slab's
shape would show) with a random velocity and density and an obstacle box
across the cut at z = 16, create_plume_bcs's masks, and a random f32
default model whose JAX params the port carries over (from_jax_params).
This file, run as a script, is the worker: one spawn of 2 gloo ranks on a
1 x 2 ('dp', 'sp') mesh runs every case while the JAX references compute
in threads (FLUIDNET_FUSED_EPILOGUE / _PROLOGUE on, as
tests/test_torch_slice.py sets them). Each rank writes its slabs to an
npz.

Cases: the ConvNet, the ConvNet + 2 polish sweeps and jacobi-8, 3 steps of
rollout_z_sharded each (bench knobs: maccormackOurs, W = 1), gathered and held
against JAX's unsharded rollout at rtol 1e-4, atol 1e-5 (that file's tolerance)
and against the port's unsharded plain rollout within PORT_MAX of the field's
largest value, at most PORT_FRAC of the cells past PORT_ROUND of it (the
ConvNet's input scale sums in another order). After one step every rank's
own planes equal the whole grid's to the bit through the advection and K2
(the ConvNet's inputs, each slab's advection at its own z origin), and
through the whole jacobi-8 step. Also: the sharded input scale (std,
norm) against _input_scale on the whole grid, the adaptive window chosen
the same on both ranks, each case
with every kernel's plain version equal to the bit, a planted ghost-zone
fault that must fail the comparisons, and the refusals.
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
SHAPE = (2, 1, 32, 16, 16)
N_STEPS = 3
RTOL, ATOL = 1e-4, 1e-5
# Against the port's unsharded rollout: the largest difference over the
# field's largest value, and the share of cells past PORT_ROUND of it.
# Each slab advects at its own z origin, so a step equals the whole grid's
# to the bit through the advection and K2 (jacobi-8's whole rollout does);
# the ConvNet's input scale sums in another order, and its rounding moves
# a cell by at most 7.5e-7 of the field's largest value in 3 steps.
PORT_MAX, PORT_ROUND, PORT_FRAC = 1e-5, 1e-6, 1e-3
KNOBS = dict(is_3d=True, sim_method="convnet", dt=0.1, buoyancy_scale=2.0,
             vorticity_confinement_amp=3.0, maccormack_strength=0.6,
             advection_method="maccormackOurs", adaptive_window=False,
             advection_window=1, conv_compute_dtype="float32")
CASES = {"convnet": {}, "convnet_p2": dict(polish_iters=2),
         "jacobi8": dict(sim_method="jacobi", max_iter=8)}
ADAPT = dict(adaptive_window=True, advection_window=2)
FAULT_CALL = 2        # step 2's exchange (call 0 extends the flags)
REFUSALS = {"tog": dict(model_type="tog"),
            "window0": dict(advection_window=0), "2d": {}, "no_density": {}}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --- the worker (run as a script; imports no JAX) ---------------------------

class _Recorder(torch.nn.Module):
    """The model, recording the (u, div) K2 hands it at its first call."""

    def __init__(self, model):
        super().__init__()
        self.model, self.seen = model, None

    def forward(self, p, u, flags, **kw):
        if self.seen is None:
            self.seen = (u.clone(), kw["precomputed_div"].clone())
        return self.model(p, u, flags, **kw)


def _state(inp, prefix=""):
    from fluidnet_tpu_torch.core.grids import FluidState
    return FluidState(**{k: torch.from_numpy(inp[prefix + k])
                         for k in ("u", "p", "flags", "density")})


def _bcs(state):
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs
    return create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)


def _model(inp, mconf):
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    net = FluidNet(mconf, device="cpu")
    with torch.no_grad():
        for name, p in net.jax_named_parameters():
            p.copy_(torch.from_numpy(inp[f"param_{name}"]))
    return net


def _worker(rank, port, inp):
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.parallel import simulate_sharded as ss
    from fluidnet_tpu_torch.parallel.halo import exchange_ghost
    from fluidnet_tpu_torch.parallel.mesh import make_mesh
    from fluidnet_tpu_torch.parallel.multihost import init_multihost

    assert init_multihost(f"127.0.0.1:{port}", 2, rank, device_type="cpu")
    mesh = make_mesh(n_dp=1, n_sp=2, device_type="cpu")
    group = mesh["sp"].get_group()
    base = ModelConfig(**KNOBS)
    model = _model(inp, base)
    state, bcs = _state(inp), _bcs(_state(inp))
    state_l, bcs_l = ss.shard_state(state, mesh), ss.shard_bcs(bcs, mesh)
    res = {}
    for name, kw in CASES.items():
        mconf = base.replace(**kw)
        net = model if mconf.sim_method == "convnet" else None
        out = ss.rollout_z_sharded(state_l, mconf, N_STEPS, mesh, net, bcs_l,
                                   save_every=1 if name == "convnet" else 0)
        if name == "convnet":
            out, res["frames"] = out
        plain = ss.rollout_z_sharded(state_l, mconf, N_STEPS, mesh, net,
                                     bcs_l, use_kernels=False)
        for k in ("u", "p", "density"):
            res[f"{name}_{k}"] = getattr(out, k)
            res[f"{name}_plain_{k}"] = getattr(plain, k)
    whole = ss.gather_state(ss.rollout_z_sharded(
        state_l, base, 1, mesh, model, bcs_l), mesh)
    res.update({f"gathered_{k}": getattr(whole, k)
                for k in ("u", "p", "flags")})

    # One step of each case: the ConvNet's with the recording model (the
    # u and divergence K2 hands it), jacobi-8's whole.
    for name in ("convnet", "convnet_p2"):
        rec = _Recorder(model)
        m = base.replace(**CASES[name])
        ss.simulate_z_sharded(state_l, m, mesh, rec, bcs_l)
        slab = ss._Slab(state_l, m, mesh, bcs_l)
        res[f"step1_{name}_u"], res[f"step1_{name}_div"] = (
            slab.own(x) for x in rec.seen)
    out = ss.simulate_z_sharded(
        state_l, base.replace(**CASES["jacobi8"]), mesh, None, bcs_l)
    res["step1_jacobi8_u"], res["step1_jacobi8_p"] = out.u, out.p

    # The input scale of the whole grid from the slabs' own planes.
    sc = ss.shard_state(_state(inp, "sc_"), mesh)
    ext = exchange_ghost([sc.p, sc.u, sc.density], slab.g, group)
    for func in ("std", "norm"):
        for chan in ("UDiv", "div"):
            m = base.replace(normalize_input_func=func,
                             normalize_input_chan=chan)
            res[f"scale_{func}_{chan}"] = slab.input_scale(m, *ext)

    # The adaptive window: max|u| dt past the CFL limit on rank 0 only.
    adapt = _state(inp, "ad_")
    ad_l = ss.shard_state(adapt, mesh)
    m_ad = base.replace(**ADAPT)
    res["window"] = torch.tensor(ss.step_window(m_ad, ad_l.u, m_ad.dt,
                                                group))
    res["local_cfl"] = ad_l.u.abs().max() * m_ad.dt
    out = ss.rollout_z_sharded(ad_l, m_ad, 1, mesh, model,
                               ss.shard_bcs(_bcs(adapt), mesh))
    res["adapt_u"], res["adapt_density"] = out.u, out.density

    # The planted fault: the ghost planes of step 2's exchange zeroed.
    with _rank_script().zeroed_ghosts(FAULT_CALL, rank):
        out = ss.rollout_z_sharded(state_l, base, N_STEPS, mesh, model,
                                   bcs_l)
    res["fault_u"], res["fault_density"] = out.u, out.density

    # The refusals.
    def error(fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            return np.array(f"{type(e).__name__}: {e}")
        return np.array("")
    for name, kw in REFUSALS.items():
        m = base.replace(**kw)
        st = state_l
        if name == "2d":
            st = st.replace(u=st.u[:, :2, :1], p=st.p[:, :, :1],
                            flags=st.flags[:, :, :1],
                            density=st.density[:, :, :1])
        if name == "no_density":
            st = st.replace(density=None)
        res[f"err_{name}"] = error(lambda: ss.simulate_z_sharded(
            st, m, mesh, model, None if name == "2d" else bcs_l))
    res["err_short"] = error(lambda: ss.rollout_z_sharded(
        state_l, base.replace(advection_window=4), 1, mesh, model, bcs_l))
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


def _flags(rng):
    flags = np.ones(SHAPE, np.int32)
    flags[:, :, [0, -1]] = 2
    flags[:, :, :, [0, -1]] = 2
    flags[..., [0, -1]] = 2
    flags[..., 13:19, 6:10, 4:8] = 2       # a box across the cut at z 16
    flags[1, :, 20:23, 3:6, 9:13] = 2
    return flags


def _inputs():
    import jax
    from fluidnet_tpu.core.config import ModelConfig as JModelConfig
    from fluidnet_tpu.models.fluidnet import init_model
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.models.fluidnet import FluidNet

    rng = np.random.default_rng(140)
    B, _, Z, Y, X = SHAPE
    inp = {"flags": _flags(rng),
           "u": (rng.standard_normal((B, 3, Z, Y, X)) * 0.5).astype(
               np.float32),
           "p": (rng.standard_normal(SHAPE) * 0.1).astype(np.float32),
           "density": rng.random(SHAPE).astype(np.float32)}
    for pre in ("sc_", "ad_"):
        for k, v in list(inp.items()):
            if not k.startswith(("sc_", "ad_")):
                inp[pre + k] = v.copy()
    inp["sc_u"] = (rng.standard_normal(inp["u"].shape) * 2.0 + 0.3).astype(
        np.float32)
    inp["sc_density"] = rng.standard_normal(SHAPE).astype(np.float32)
    inp["ad_u"][1, 1, 5, 8, 8] = 15.0     # max|u| dt = 1.5 on rank 0 only
    params = init_model(jax.random.PRNGKey(2), JModelConfig(**KNOBS))
    names = [k for k, _ in FluidNet(ModelConfig(**KNOBS),
                                    device="cpu").jax_named_parameters()]
    for name in names:
        tree = params
        for k in name.split("/"):
            tree = tree[int(k)] if isinstance(tree, list) else tree[k]
        inp[f"param_{name}"] = np.array(tree)
    return inp, params


def _jax_refs(inp, params):
    """JAX's unsharded rollout of each case, fused knobs on."""
    import jax.numpy as jnp
    from fluidnet_tpu.core.config import ModelConfig as JModelConfig
    from fluidnet_tpu.core.grids import FluidState as JFluidState
    from fluidnet_tpu.models.fluidnet import apply_model
    from fluidnet_tpu.sim.simulate import create_plume_bcs, rollout

    jm = JModelConfig(**KNOBS)
    state = JFluidState(**{k: jnp.asarray(inp[k]) for k in
                           ("u", "p", "flags", "density")})
    bcs = create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)

    def run(name):
        m = jm.replace(**CASES[name])
        net = m.sim_method == "convnet"
        out = rollout(state, m, N_STEPS,
                      (lambda pr, p, u, f, **kw: apply_model(pr, m, p, u, f,
                                                             **kw))
                      if net else None, params if net else None, bcs)
        return {k: np.asarray(getattr(out, k)) for k in
                ("u", "p", "density")}

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLUIDNET_FUSED_EPILOGUE", "1")
        mp.setenv("FLUIDNET_FUSED_PROLOGUE", "1")
        with ThreadPoolExecutor(len(CASES)) as pool:
            futs = {name: pool.submit(run, name) for name in CASES}
            return {name: f.result() for name, f in futs.items()}


def _port_refs(inp):
    """The port's unsharded plain rollouts: every case, the adaptive
    window's, one step of the ConvNet (recording its inputs) and of
    jacobi-8. On one thread, as the ranks run: the CPU convolutions and
    reductions round by the thread count, and through the MacCormack
    clamp's bounds a rounding can move a cell by ~1e-4 of the field."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _port_refs_1(inp)
    finally:
        torch.set_num_threads(threads)


def _port_refs_1(inp):
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.sim.simulate import rollout, simulate
    base = ModelConfig(**KNOBS)
    model = _model(inp, base)
    state = _state(inp)
    bcs = _bcs(state)
    ref = {}
    for name, kw in CASES.items():
        m = base.replace(**kw)
        out = rollout(state, m, N_STEPS,
                      model if m.sim_method == "convnet" else None, bcs,
                      save_every=1 if name == "convnet" else 0)
        if name == "convnet":
            out, ref["frames"] = out
        ref[name] = {k: getattr(out, k) for k in ("u", "p", "density")}
    for name in ("convnet", "convnet_p2"):
        rec = _Recorder(model)
        simulate(state, base.replace(**CASES[name]), rec, bcs)
        ref[f"step1_{name}_u"], ref[f"step1_{name}_div"] = rec.seen
    out = simulate(state, base.replace(**CASES["jacobi8"]), None, bcs)
    ref["step1_jacobi8_u"], ref["step1_jacobi8_p"] = out.u, out.p
    adapt = _state(inp, "ad_")
    out = rollout(adapt, base.replace(**ADAPT), 1, model, _bcs(adapt))
    ref["adapt"] = {"u": out.u, "density": out.density}
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX references, the port's references, [rank results])."""
    tmp = str(tmp_path_factory.mktemp("torch_sharded_sim"))
    inp, params = _inputs()
    in_path = os.path.join(tmp, "inputs.npz")
    np.savez(in_path, **inp)
    procs = _spawn(tmp, in_path)
    try:
        jref = _jax_refs(inp, params)
        pref = _port_refs(inp)
    finally:
        outs = _collect(procs)
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


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_rollout_matches_jax(run, name):
    """The gathered slabs after 3 steps against JAX's unsharded rollout:
    rtol 1e-4, atol 1e-5."""
    _, jref, _, outs = run
    for k in ("u", "p", "density"):
        got = _gather(outs, f"{name}_{k}")
        print(f"{name} {k}: vs JAX, max abs err "
              f"{np.abs(got - jref[name][k]).max():.3e}")
        np.testing.assert_allclose(got, jref[name][k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_rollout_matches_port(run, name):
    """The gathered slabs against the port's unsharded rollout: within
    PORT_MAX of the field's largest value, at most PORT_FRAC of the cells
    past PORT_ROUND of it."""
    _, _, pref, outs = run
    for k in ("u", "p", "density"):
        m, f = _port_err(_gather(outs, f"{name}_{k}"), pref[name][k])
        print(f"{name} {k}: vs the port's unsharded rollout, max {m:.3e} "
              f"of the field's max, share past {PORT_ROUND} {f:.3e}")
        assert m <= PORT_MAX and f <= PORT_FRAC, (name, k, m, f)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_plain_versions_equal(run, name):
    """Each rank's slab after 3 steps with use_kernels=False (every
    kernel's plain version) equals its slab with the kernels to the bit
    (chip_smoke.py phase 21 holds the card's kernels so at the shapes
    this path gives them)."""
    _, _, _, outs = run
    for o in outs:
        for k in ("u", "p", "density"):
            np.testing.assert_array_equal(o[f"{name}_plain_{k}"],
                                          o[f"{name}_{k}"], f"{name} {k}")


def test_save_every_and_gather(run):
    """save_every=1 stacks each step's density slab (the gathered frames
    match the port's unsharded frames), and gather_state gives every rank
    the whole grid."""
    inp, _, pref, outs = run
    frames = np.concatenate([o["frames"] for o in outs], axis=3)
    assert frames.shape == (N_STEPS,) + SHAPE
    print(f"frames: (max, share) {_port_err(frames, pref['frames'])}")
    assert _within_port(frames, pref["frames"])
    for o in outs:
        np.testing.assert_array_equal(o["gathered_flags"], inp["flags"])
        np.testing.assert_array_equal(o["gathered_u"], outs[0]["gathered_u"])
        assert o["gathered_p"].shape == SHAPE


def test_rank0_first_step_is_bit_equal(run):
    """Every rank's extended slab passes its first global plane (the z
    origin) to the advection: after one step every rank's own planes equal
    the whole grid's to the bit through the advection and K2 (the u and
    divergence the ConvNet gets, with and without the polish), and
    through the whole jacobi-8 step (u and p)."""
    _, _, pref, outs = run
    zl = SHAPE[2] // 2
    keys = ("step1_convnet_u", "step1_convnet_div", "step1_convnet_p2_u",
            "step1_convnet_p2_div", "step1_jacobi8_u", "step1_jacobi8_p")
    for r, o in enumerate(outs):
        for key in keys:
            np.testing.assert_array_equal(
                o[key], pref[key][:, :, r * zl:(r + 1) * zl].numpy(),
                f"rank {r} {key}")
    assert np.abs(outs[1]["step1_convnet_div"]).max() > 1e-3


def test_sharded_input_scale(run):
    """The input scale from the slabs' own planes (std: JAX's two passes
    over all_reduced sums; norm) equals _input_scale on the whole grid,
    on both ranks (rtol 1e-6: the sums run in another order)."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.models.fluidnet import _input_scale
    inp, _, _, outs = run
    base = ModelConfig(**KNOBS)
    p, u, d = (torch.from_numpy(inp[k]) for k in ("sc_p", "sc_u",
                                                   "sc_density"))
    for func in ("std", "norm"):
        for chan in ("UDiv", "div"):
            m = base.replace(normalize_input_func=func,
                             normalize_input_chan=chan)
            want = _input_scale(m, p, u, d).numpy()
            for o in outs:
                np.testing.assert_allclose(o[f"scale_{func}_{chan}"], want,
                                           rtol=1e-6, err_msg=func + chan)
    assert _input_scale(base, p, u, d).min() > 1.0


def test_adaptive_window_is_global(run):
    """advection_window 2 with the adaptive window, max|u| dt past the
    CFL limit on rank 0's planes only: both ranks take W = 2, and the
    step matches the port's unsharded one."""
    _, _, pref, outs = run
    assert float(outs[0]["local_cfl"]) > 1.0 > float(outs[1]["local_cfl"])
    assert [int(o["window"]) for o in outs] == [2, 2]
    for k in ("u", "density"):
        got = _gather(outs, f"adapt_{k}")
        print(f"adapt {k}: (max, share) {_port_err(got, pref['adapt'][k])}")
        assert _within_port(got, pref["adapt"][k]), k


def test_planted_ghost_fault_fails(run):
    """The ghost planes of step 2's exchange zeroed: the same comparisons
    (JAX's rollout at rtol 1e-4 / atol 1e-5, the port's within PORT_MAX)
    fail."""
    _, jref, pref, outs = run
    for k in ("u", "density"):
        got = _gather(outs, f"fault_{k}")
        print(f"fault {k}: vs the port's unsharded rollout (max, share) "
              f"{_port_err(got, pref['convnet'][k])}")
        assert not np.allclose(got, jref["convnet"][k], rtol=RTOL,
                               atol=ATOL), k
        assert not _within_port(got, pref["convnet"][k]), k


def test_refusals(run):
    """A pooled model (tog), advection_window 0, a 2-D state and a state
    without density raise NotImplementedError naming the ROADMAP item
    (training, grad=True, runs: tests/test_torch_sharded_train.py; PCG
    runs: tests/test_torch_sharded_pcg.py);
    a slab shorter than the ghost zone (W = 4: 19 planes > 16) raises
    ValueError."""
    _, _, _, outs = run
    for o in outs:
        for name in REFUSALS:
            msg = str(o[f"err_{name}"])
            assert msg.startswith("NotImplementedError") and \
                "ROADMAP" in msg, (name, msg)
        assert "shard z-length 16 < ghost zone 19" in str(o["err_short"])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                 sys.argv[4])
