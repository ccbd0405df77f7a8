"""parallel/ of the PyTorch port (torch.distributed) against the JAX
package's parallel/, on the CPU with gloo.

The pytest process makes every input with numpy from a seed, computes the
JAX references on tests/conftest.py's 8-device CPU mesh (interpret-mode
Pallas, as the JAX suite runs it) and writes the inputs to an npz. The
port runs in real processes: this file, run as a script, is the worker.
One spawn of 2 gloo ranks runs every case on a 1 x 2 ('dp', 'sp') mesh
(the halo Jacobi at 16^3 with an obstacle across the cut; the z-sharded
advection at 16 x 12 x 16, W = 1 and 2, maccormack and maccormackOurs; the
exchange; the mesh-size errors), then the data-parallel train_step on a
2 x 1 mesh; a second spawn of 4 ranks, LOCAL_WORLD_SIZE 2, runs the same
train step on make_global_mesh's 2 x 2 x 1 mesh through shard_host_batch.
Both spawns run while the JAX references compile. Each rank writes its
results to an npz.

Tolerances: port against JAX, atol 1e-5 (as JAX's own tests); the halo
Jacobi against the port's jacobi_plain on the whole grid, equal to the
bit; the sharded advection against the port's own computation on the same
halo-extended slabs in one process, equal to the bit (the exchange moves
exact planes), and against the port's unsharded advection atol 1e-5
(positions are absolute, so a weight rounds at the slab's magnitude; see
parallel/advect_sharded.py). Losses rtol 1e-5; params rtol 1e-4, atol
1e-5.

JAX's sharded advection compiles its interpret-mode kernels per shard
shape, method and window, 52-136 s a case on the CPU; the four cases
compile in threads side by side while the spawns run. Each is held
against JAX's advect_step_z_sharded on the whole grid, the global z ends
included (maccormack at W = 2 reads the zero halo there), against the
port's slabs and against its unsharded advection. The file takes ~2
min, most of it those JAX compiles.
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
JAC_SHAPE, JAC_ITERS = (1, 1, 16, 16, 16), 50
ADV_SHAPE = (1, 1, 16, 12, 16)
# (window, method, velocity scale, dt): CFL ~0.3 at W = 1; ~1.3 at W = 2,
# so displacements use the second plane.
ADV_CASES = {"w1_maccormack": (1, "maccormack", 0.8, 0.4),
             "w1_maccormackOurs": (1, "maccormackOurs", 0.8, 0.4),
             "w2_maccormack": (2, "maccormack", 1.6, 0.8),
             "w2_maccormackOurs": (2, "maccormackOurs", 1.6, 0.8)}
STRENGTH = 0.6
TRAIN_SHAPE = (4, 1, 1, 16, 16)     # a global batch of four 2-D scenes
TERMS = ("total", "p", "u", "div", "long_term_div", "grad_norm",
         "rejected")
TRAIN_CONF = dict(is_3d=False, time_scale_sigma=0.0,
                  advection_method="euler", long_term_div_num_steps=(1, 1),
                  conv_compute_dtype="float32")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _adv_flags():
    """Obstacle-bordered 16 x 12 x 16 flags with a box across the z cut
    at 8."""
    flags = np.ones(ADV_SHAPE, np.int32)
    flags[:, :, [0, -1]] = 2
    flags[:, :, :, [0, -1]] = 2
    flags[..., [0, -1]] = 2
    flags[..., 6:10, 4:8, 5:9] = 2
    return flags


# --- the worker (run as a script; imports no JAX) ---------------------------

def _worker_pair(rank, port, inp):
    from fluidnet_tpu_torch.parallel.advect_sharded import (
        _exchange_z_halo, advect_step_z_sharded)
    from fluidnet_tpu_torch.parallel.halo import halo_jacobi_solve
    from fluidnet_tpu_torch.parallel.mesh import (
        data_parallel_group, local_part, make_mesh, shard_batch,
        spatial_sharding, transport)
    from fluidnet_tpu_torch.parallel.multihost import init_multihost

    assert init_multihost(f"127.0.0.1:{port}", 2, rank, device_type="cpu")
    res = {}
    mesh = make_mesh(n_dp=1, n_sp=2, device_type="cpu")
    sp = spatial_sharding(mesh)
    group = mesh["sp"].get_group()
    res["transport"] = transport(torch.zeros(1), group)

    res["jac_p"] = halo_jacobi_solve(local_part(inp["jac_flags"], sp),
                                     local_part(inp["jac_div"], sp), mesh,
                                     JAC_ITERS)
    flags = local_part(inp["adv_flags"], sp)
    for name, (W, method, _, dt) in ADV_CASES.items():
        u, d = advect_step_z_sharded(
            dt, local_part(inp[f"adv_u_{name}"], sp),
            local_part(inp[f"adv_d_{name}"], sp), flags, mesh, method,
            STRENGTH, W)
        res[f"adv_u_{name}"], res[f"adv_d_{name}"] = u, d
    u_only, none = advect_step_z_sharded(
        0.4, local_part(inp["adv_u_w1_maccormackOurs"], sp), None, flags,
        mesh, "maccormackOurs", STRENGTH, 1)
    res["adv_u_only"] = u_only
    res["adv_d_none"] = torch.tensor(none is None)
    res["halo"] = _exchange_z_halo([local_part(inp["halo_x"], sp)], 3,
                                   group)[0]

    def error(fn):
        try:
            fn()
        except ValueError as e:
            return np.array(str(e))
        return np.array("")
    res["err_short"] = error(lambda: advect_step_z_sharded(
        0.4, local_part(inp["adv_u_w1_maccormack"], sp), None, flags, mesh,
        "maccormackOurs", STRENGTH, 4))
    res["err_divide"] = error(lambda: local_part(
        np.zeros((1, 1, 15, 4, 4), np.float32), sp))
    res["err_mesh"] = error(lambda: make_mesh(n_dp=2, n_sp=2,
                                              device_type="cpu"))

    dp = make_mesh(n_dp=2, n_sp=1, device_type="cpu")
    batch = shard_batch({k[3:]: inp[k] for k in inp if k.startswith("tr_")},
                        dp)
    res.update(_train(inp, batch, data_parallel_group(dp), "dp2"))
    return res


def _worker_hosts(inp):
    from fluidnet_tpu_torch.parallel.mesh import (data_parallel_group,
                                                  local_part)
    from fluidnet_tpu_torch.parallel.multihost import (
        global_batch_sharding, init_multihost, make_global_mesh,
        shard_host_batch)

    assert init_multihost(device_type="cpu")
    mesh = make_global_mesh(n_dp=2, n_sp=1, device_type="cpu")
    host = mesh.get_coordinate()[0]
    gbatch = {k[3:]: inp[k] for k in inp if k.startswith("tr_")}
    local = {k: v[2 * host:2 * host + 2] for k, v in gbatch.items()}
    batch = shard_host_batch(local, mesh)
    gsh = global_batch_sharding(mesh)
    res = {"same_as_global": torch.tensor(all(
        torch.equal(batch[k], local_part(gbatch[k], gsh)) for k in batch)),
        "local_b": torch.tensor(batch["u_div"].shape[0])}
    res.update(_train(inp, batch, data_parallel_group(mesh), "hosts"))
    return res


def _train(inp, batch, group, tag):
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.train.train import (Draws, init_train_state,
                                                train_step)
    mconf = ModelConfig(**TRAIN_CONF)
    state = init_train_state(0, mconf, "cpu")
    with torch.no_grad():
        for name, p in state.model.jax_named_parameters():
            p.copy_(torch.from_numpy(inp[f"param_{name}"]))
    draws = Draws(*(torch.from_numpy(inp[f"draw_{k}"])
                    for k in Draws._fields))
    state, terms = train_step(state, batch, None, mconf, 1, draws=draws,
                              group=group)
    res = {f"{tag}_term_{k}": terms[k] for k in TERMS}
    for name, p in state.model.jax_named_parameters():
        res[f"{tag}_param_{name}"] = p.detach()
    return res


def _worker_main(mode, rank, port, in_path, out_path):
    torch.set_num_threads(1)
    inp = dict(np.load(in_path))
    res = _worker_pair(rank, port, inp) if mode == "pair" \
        else _worker_hosts(inp)
    np.savez(out_path, **{k: v.detach().numpy() if torch.is_tensor(v)
                          else v for k, v in res.items()})
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# --- the pytest side --------------------------------------------------------

def _spawn(mode, world, tmp, in_path):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        if mode == "hosts":
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(rank),
                       LOCAL_WORLD_SIZE="2", LOCAL_RANK=str(rank % 2))
        out = os.path.join(tmp, f"{mode}{rank}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(rank),
             str(port), in_path, out], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
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


def _inputs():
    """Every global input, from numpy seeds (and JAX's div, params and
    draws)."""
    import jax
    import jax.numpy as jnp
    from fluidnet_tpu.core.config import ModelConfig as JModelConfig
    from fluidnet_tpu.core.grids import empty_domain
    from fluidnet_tpu.ops.boundary import set_wall_bcs
    from fluidnet_tpu.ops.divergence import velocity_divergence
    from fluidnet_tpu.train import train as jtrain

    inp = {}
    rng = np.random.default_rng(50)
    flags = np.asarray(empty_domain(JAC_SHAPE, True)).copy()
    flags[..., 6:9, 4:8, 5:9] = 2        # obstacle across the cut at z 8
    u = set_wall_bcs(jnp.asarray(rng.standard_normal((1, 3) + JAC_SHAPE[2:]),
                                 jnp.float32), jnp.asarray(flags))
    inp["jac_flags"] = flags
    inp["jac_div"] = np.array(velocity_divergence(u, jnp.asarray(flags)))

    rng = np.random.default_rng(83)
    inp["adv_flags"] = _adv_flags()
    for name, (_, _, scale, _) in ADV_CASES.items():
        inp[f"adv_u_{name}"] = (rng.standard_normal(
            (1, 3) + ADV_SHAPE[2:]) * scale).astype(np.float32)
        inp[f"adv_d_{name}"] = rng.random(ADV_SHAPE).astype(np.float32)
    inp["halo_x"] = np.arange(2 * 16 * 3 * 4, dtype=np.float32).reshape(
        1, 2, 16, 3, 4)

    # test_multihost.py's batch and mconf (f32 convs), its keys 0 and 1.
    rng = np.random.default_rng(7)
    B, Z, Y, X = TRAIN_SHAPE[0], 1, 16, 16
    tflags = empty_domain((B, 1, Z, Y, X), False)
    u_div = np.array(set_wall_bcs(jnp.asarray(
        rng.standard_normal((B, 2, Z, Y, X)), jnp.float32), tflags))
    batch = {"p_div": np.zeros((B, 1, Z, Y, X), np.float32),
             "u_div": u_div, "flags": np.array(tflags),
             "p_target": np.zeros((B, 1, Z, Y, X), np.float32),
             "u_target": u_div,
             "density": rng.random((B, 1, Z, Y, X)).astype(np.float32)}
    inp.update({f"tr_{k}": v for k, v in batch.items()})
    jm = JModelConfig(**TRAIN_CONF)
    state = jtrain.init_train_state(jax.random.PRNGKey(0), jm)
    key = jax.random.PRNGKey(1)
    kdt, kforce = jax.random.split(key)
    draws = (jtrain._random_dt(kdt, jm),) + tuple(
        jtrain._random_forces(kforce, jm))
    for k, v in zip(("dt", "gravity", "b_scale", "g_scale", "v_amp"),
                    draws):
        inp[f"draw_{k}"] = np.array(v, np.float32)
    for name in _param_names():
        inp[f"param_{name}"] = np.array(_named(state.params, name))
    return inp, (jm, state, key)


def _param_names():
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    return [k for k, _ in FluidNet(ModelConfig(**TRAIN_CONF),
                                   device="cpu").jax_named_parameters()]


def _named(tree, name):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _jax_refs(inp, train):
    import jax.numpy as jnp
    from fluidnet_tpu.parallel.advect_sharded import \
        advect_step_z_sharded as j_advect
    from fluidnet_tpu.parallel.halo import halo_jacobi_solve as j_halo
    from fluidnet_tpu.parallel.mesh import make_mesh as j_mesh
    from fluidnet_tpu.parallel.mesh import shard_batch as j_shard
    from fluidnet_tpu.train.train import train_step as j_train_step

    ref = {}
    mesh = j_mesh(n_dp=1, n_sp=2)

    def advect(name):
        W, method, _, dt = ADV_CASES[name]
        u, d = j_advect(dt, jnp.asarray(inp[f"adv_u_{name}"]),
                        jnp.asarray(inp[f"adv_d_{name}"]),
                        jnp.asarray(inp["adv_flags"]), mesh, method,
                        STRENGTH, W)
        return np.asarray(u), np.asarray(d)

    # Each case compiles its own interpret-mode kernels (52-108 s); the
    # compiles release the GIL, so the cases run side by side.
    with ThreadPoolExecutor(len(ADV_CASES)) as pool:
        cases = {name: pool.submit(advect, name) for name in ADV_CASES}
        ref["jac_p"] = np.asarray(j_halo(jnp.asarray(inp["jac_flags"]),
                                         jnp.asarray(inp["jac_div"]), mesh,
                                         n_iter=JAC_ITERS))
        jm, state, key = train
        batch = j_shard({k[3:]: jnp.asarray(inp[k]) for k in inp
                         if k.startswith("tr_")}, j_mesh(n_dp=2, n_sp=1))
        state, terms = j_train_step(state, batch, key, jm, n_future=1)
        for k in TERMS:
            ref[f"term_{k}"] = np.asarray(terms[k])
        for name in _param_names():
            ref[f"param_{name}"] = np.asarray(_named(state.params, name))
        for name, case in cases.items():
            ref[f"adv_u_{name}"], ref[f"adv_d_{name}"] = case.result()
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX references, [rank results of the 2-rank spawn],
    [rank results of the 4-rank spawn])."""
    tmp = str(tmp_path_factory.mktemp("torch_parallel"))
    inp, train = _inputs()
    in_path = os.path.join(tmp, "inputs.npz")
    np.savez(in_path, **inp)
    pair = _spawn("pair", 2, tmp, in_path)
    hosts = _spawn("hosts", 4, tmp, in_path)
    try:
        ref = _jax_refs(inp, train)
    finally:
        pair, hosts = _collect(pair), _collect(hosts)
    return inp, ref, pair, hosts


def _gather(outs, key):
    """The ranks' z-slabs of `key`, concatenated in rank order."""
    return np.concatenate([o[key] for o in outs], axis=2)


def test_halo_jacobi_matches_jax_and_plain_sweeps(run):
    """The halo Jacobi (50 sweeps, an obstacle across the cut): atol 1e-5
    against JAX's halo_jacobi_solve, equal to the bit to the port's
    jacobi_plain on the whole grid (the same sums in the same order)."""
    from fluidnet_tpu_torch.solvers.cuda_jacobi import jacobi_plain
    inp, ref, pair, _ = run
    got = _gather(pair, "jac_p")
    np.testing.assert_allclose(got, ref["jac_p"], atol=1e-5)
    plain = jacobi_plain(torch.from_numpy(inp["jac_flags"]),
                         torch.from_numpy(inp["jac_div"]), JAC_ITERS)
    np.testing.assert_array_equal(got, plain.numpy())
    assert np.abs(got).max() > 0.1


def _rank_script():
    """scripts/torch_parallel_rank.py as a module (its slab reference)."""
    import importlib.util
    path = os.path.join(REPO, "scripts", "torch_parallel_rank.py")
    spec = importlib.util.spec_from_file_location("torch_parallel_rank",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(ADV_CASES))
def test_sharded_advection_equals_its_slabs(run, name):
    """Each rank's result equals, to the bit, the port's advection of the
    same halo-extended slab cut in one process: the exchange delivers
    exact planes, and the global border mask is the slab's."""
    inp, _, pair, _ = run
    W, method, _, dt = ADV_CASES[name]
    u, d, f = (torch.from_numpy(inp[k]) for k in
               (f"adv_u_{name}", f"adv_d_{name}", "adv_flags"))
    rs = _rank_script()
    for rank, out in enumerate(pair):
        want_u, want_d = rs.slab_reference(dt, u, d, f, 2, rank, method,
                                           STRENGTH, W)
        np.testing.assert_array_equal(out[f"adv_u_{name}"], want_u.numpy())
        np.testing.assert_array_equal(out[f"adv_d_{name}"], want_d.numpy())


@pytest.mark.parametrize("name", list(ADV_CASES))
def test_sharded_advection_matches_unsharded(run, name):
    """The gathered shards against the port's unsharded advect_vel_fast and
    advect_scalar_fast: atol 1e-5 (float32 position rounding). For
    maccormack at W = 2 only 2W planes in from the global z ends: nearer,
    the unsharded warp clamps its corners at the border where the shard
    reads the zero halo (JAX's function does the same)."""
    from fluidnet_tpu_torch.ops.advect_fast import (advect_scalar_fast,
                                                    advect_vel_fast)
    inp, _, pair, _ = run
    W, method, _, dt = ADV_CASES[name]
    u, d, f = (torch.from_numpy(inp[k]) for k in
               (f"adv_u_{name}", f"adv_d_{name}", "adv_flags"))
    want_u = advect_vel_fast(dt, u, f, method, STRENGTH, W).numpy()
    want_d = advect_scalar_fast(dt, d, u, f, method, False, STRENGTH,
                                W).numpy()
    z = slice(2 * W, -2 * W) if method == "maccormack" and W > 1 \
        else slice(None)
    got_u, got_d = _gather(pair, f"adv_u_{name}"), _gather(pair,
                                                          f"adv_d_{name}")
    np.testing.assert_allclose(got_u[:, :, z], want_u[:, :, z], atol=1e-5)
    np.testing.assert_allclose(got_d[:, :, z], want_d[:, :, z], atol=1e-5)


@pytest.mark.parametrize("name", list(ADV_CASES))
def test_sharded_advection_matches_jax(run, name):
    """The gathered shards against JAX's advect_step_z_sharded on the
    whole grid, the global z ends included: atol 1e-5."""
    _, ref, pair, _ = run
    for key in (f"adv_u_{name}", f"adv_d_{name}"):
        np.testing.assert_allclose(_gather(pair, key), ref[key], atol=1e-5)


def test_velocity_only_and_exchange(run):
    """Without a density the step returns (u', None), u' equal to the bit
    to the step with one; the exchange extends a slab with its
    neighbours' 3 planes and zeros past the mesh ends."""
    inp, _, pair, _ = run
    x = torch.from_numpy(inp["halo_x"])
    for rank, out in enumerate(pair):
        assert bool(out["adv_d_none"])
        np.testing.assert_array_equal(out["adv_u_only"],
                                      out["adv_u_w1_maccormackOurs"])
        want = _rank_script().cut_slab(x, 2, rank, 3)
        np.testing.assert_array_equal(out["halo"], want.numpy())
        assert str(out["transport"]) == "gloo"


def test_mesh_size_errors(run):
    """A shard shorter than the halo (W = 4: H = 10 > 8 planes), a z axis
    that does not divide over sp (15 over 2) and a mesh that is not the
    world size all raise ValueError."""
    _, _, pair, _ = run
    for out in pair:
        assert "shard z-length 8 < halo 10" in str(out["err_short"])
        assert "must divide over sp (2)" in str(out["err_divide"])
        assert "is not the world size 2" in str(out["err_mesh"])


def _check_train(ref, outs, tag):
    for out in outs:
        for k in TERMS:
            np.testing.assert_allclose(out[f"{tag}_term_{k}"],
                                       ref[f"term_{k}"], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        for name in _param_names():
            np.testing.assert_allclose(out[f"{tag}_param_{name}"],
                                       ref[f"param_{name}"], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    assert float(outs[0][f"{tag}_term_rejected"]) == 0.0


def test_data_parallel_train_step_matches_jax(run):
    """train_step(group=) on a 2 x 1 ('dp', 'sp') mesh, 2 samples a rank,
    against JAX's train_step on the shard_batch'ed global batch of 4:
    every loss term rtol 1e-5, every parameter rtol 1e-4 / atol 1e-5, on
    both ranks."""
    _, ref, pair, _ = run
    _check_train(ref, pair, "dp2")


def test_multihost_train_step_matches_jax(run):
    """4 ranks, LOCAL_WORLD_SIZE 2, from torchrun's variables: a 2 x 2 x 1
    ('host', 'dp', 'sp') mesh, each host feeding its half of the global
    batch through shard_host_batch (1 sample a rank, the rank's part of
    the global batch under global_batch_sharding). The step matches JAX's
    on the global batch (which tests/test_multihost.py equates with its
    two-process step)."""
    _, ref, _, hosts = run
    for out in hosts:
        assert bool(out["same_as_global"]) and int(out["local_b"]) == 1
    _check_train(ref, hosts, "hosts")


def test_init_multihost_single_process(monkeypatch):
    """No coordinator or one process: init_multihost is a no-op."""
    from fluidnet_tpu_torch.parallel.multihost import init_multihost
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_multihost(device_type="cpu") is False
    assert init_multihost("127.0.0.1:1", 1, 0, device_type="cpu") is False


@pytest.mark.parametrize("is_3d,size", [(True, (6, 5, 4)), (False,
                                                           (6, 5, 1))])
def test_zero_state_matches_jax(is_3d, size):
    """core/grids.zero_state against JAX's: every field equal."""
    from fluidnet_tpu.core.grids import zero_state as j_zero_state
    from fluidnet_tpu_torch.core.grids import zero_state
    got = zero_state(2, size, is_3d, 3, device="cpu")
    want = j_zero_state(2, size, is_3d, 3)
    for k in ("u", "p", "flags", "density"):
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, k
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    with pytest.raises(ValueError, match="z == 1"):
        zero_state(1, (4, 4, 2), False, device="cpu")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                 sys.argv[4], sys.argv[5])
