"""Sharded PCG of the PyTorch port (parallel/pcg_sharded.py, and
rollout_z_sharded with sim_method 'pcg') against the JAX package's
connected_components, component_mean, normalize_pressure_mean, solve_pcg
and rollout on the whole grid, on the CPU with gloo.

The pytest process makes every input with numpy from a seed: a (B=2, Z=32,
Y=16, X=16) scene cut at z = 16 between the 'sp' ranks, with
  - an obstacle box across the cut;
  - an enclosed (singular) component that spans the cut (the shell);
  - a U-shaped component whose arms join only on rank 0's slab (two
    components on rank 1's slab alone, one on the whole grid), whose only
    Empty-cell (Dirichlet) link lies on rank 1's slab;
  - the bulk, whose only Empty cells lie on rank 1's slab too;
and a divergence (JAX's velocity_divergence of a wall-BC'd random u)
scaled so that sample 1 converges in far fewer CG iterations than sample
0. This file, run as a script, is the worker: one spawn of 2 gloo ranks,
on a 1 x 2 ('dp', 'sp') mesh and then a 2 x 1 mesh, while the JAX
references compute in threads. Each rank writes its results to an npz.

Held: the gathered labels equal JAX's exactly, with the default cap and
with a cap that stops the loop early; the component means at
tests/test_torch_solvers.py's rtol 1e-5, atol 1e-6; the solve at that
file's PCG rtol (1e-4 on p, an atol of 1e-4 of p's largest value, P_*
below; the residual at rtol 1e-3), with both preconditioners and with the
null-space removal on and off, every rank reporting the same iteration
count; on the 2 x 1 mesh the sample that converges first takes the batch's
iteration count; a 3-step PCG rollout_z_sharded at
tests/test_torch_slice.py's rtol 1e-4, atol 1e-5, on
tests/test_torch_sharded_sim.py's scene (an obstacle box across the cut:
on the U scene 100 CG iterations leave the solve short of its tolerance,
and there the port's own unsharded PCG rollout is 1.4e-5 off JAX's on p,
past that atol, as the sharded one is); each rank's reruns equal to the
bit; a planted fault (the exchange of the CG direction zeroed) that must
fail the solve's and the rollout's limits.
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
OB, FL, EM = 2, 1, 4
# Each sample's divergence scale: sample 1 converges in ~22 iterations,
# sample 0 in ~81 (tol 1e-4).
DIV_SCALE = (3e-4, 1e-4)
CAP = 5                     # a labelling cap that binds
SOLVES = {"jacobi": dict(precond="jacobi"), "none": dict(precond="none"),
          "jacobi_keep": dict(precond="jacobi", remove_null_space=False,
                              tol=0.0, max_iter=12),
          "none_keep": dict(precond="none", remove_null_space=False,
                            tol=0.0, max_iter=12)}
# p: rtol 1e-4 and atol 1e-4 of p's largest value. The scene's pressures
# reach ~1e-3 (the divergence is scaled so that CG converges within 100
# iterations at tol 1e-4), where tests/test_torch_solvers.py's absolute
# atol of 2e-5 would be loose; the port's own unsharded solve with
# precond 'none' reads 5.6e-5 of p's largest value against JAX's here.
P_RTOL, P_ATOL_REL, RES_RTOL = 1e-4, 1e-4, 1e-3
MEAN_RTOL, MEAN_ATOL = 1e-5, 1e-6
N_STEPS = 3
RTOL, ATOL = 1e-4, 1e-5
KNOBS = dict(is_3d=True, sim_method="pcg", max_iter=100, pcg_tol=1e-4,
             dt=0.1, buoyancy_scale=2.0, vorticity_confinement_amp=3.0,
             maccormack_strength=0.6, advection_method="maccormackOurs",
             adaptive_window=False, advection_window=1)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --- the worker (run as a script; imports no JAX) ---------------------------

def _state(inp):
    from fluidnet_tpu_torch.core.grids import FluidState
    return FluidState(flags=torch.from_numpy(inp["roll_flags"]),
                      **{k: torch.from_numpy(inp[k])
                         for k in ("u", "p", "density")})


def _bcs(state):
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs
    return create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)


def _worker(rank, port, inp):
    import torch.distributed as dist
    from fluidnet_tpu_torch.core.celltype import is_fluid
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.parallel import pcg_sharded as ps
    from fluidnet_tpu_torch.parallel import simulate_sharded as ss
    from fluidnet_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from fluidnet_tpu_torch.parallel.multihost import init_multihost
    from fluidnet_tpu_torch.solvers.cg import _laplacian_masks

    assert init_multihost(f"127.0.0.1:{port}", 2, rank, device_type="cpu")
    mesh = make_mesh(n_dp=1, n_sp=2, device_type="cpu")
    group = mesh["sp"].get_group()
    host = {k: torch.from_numpy(inp[k]) for k in ("flags", "div", "x")}
    part = shard_batch(host, mesh, "cpu")
    flags, div = part["flags"], part["div"]
    z0 = rank * flags.shape[2]
    res = {}

    # (a) the labels, with the grid's cap and with one that binds.
    labels, res["sweeps"] = ps.connected_components_z_sharded(flags, mesh,
                                                              z0)
    res["labels"] = labels
    res["labels_cap"], res["sweeps_cap"] = \
        ps.connected_components_z_sharded(flags, mesh, z0, max_iter=CAP)

    # (b) the component sums; has_dirichlet as the solve builds it.
    segs = ps.slab_segments(labels, group)
    fl = is_fluid(flags)
    res["mean"] = ps.component_mean_z_sharded(part["x"], segs, fl)
    res["normalized"] = ps.normalize_pressure_mean_z_sharded(part["x"],
                                                             flags, segs)
    fe, = ps.exchange_ghost([flags], 1, group)
    lo = int(rank > 0)
    _, diag, nbr, _ = _laplacian_masks(fe, True)
    crop = slice(lo, lo + flags.shape[2])
    nonsing = fl & (diag[:, :, crop] > sum(
        m[:, :, crop].to(torch.float32) for m in nbr))
    res["nonsing"] = nonsing
    res["has_dirichlet"] = ps.component_mean_z_sharded(
        nonsing.to(torch.float32), segs, fl) > 0.0

    # (c) the solves; (e) one rerun; (f) the planted fault.
    rs = _rank_script()
    for name, kw in SOLVES.items():
        p, r, it = ps.solve_pcg_z_sharded(flags, div, mesh, z0, **kw)
        res[f"solve_{name}_p"], res[f"solve_{name}_res"] = p, r
        res[f"solve_{name}_it"] = np.array(it)
    p, _, _ = ps.solve_pcg_z_sharded(flags, div, mesh, z0, labels=segs)
    res["rerun_p"] = p
    with rs.zeroed_d_ghosts():
        p, _, _ = ps.solve_pcg_z_sharded(flags, div, mesh, z0, labels=segs)
    res["fault_p"] = p

    # (d) the PCG rollout; (e) its rerun; (f) the fault.
    mconf = ModelConfig(**KNOBS)
    state = _state(inp)
    state_l, bcs_l = ss.shard_state(state, mesh), ss.shard_bcs(_bcs(state),
                                                               mesh)
    for key in ("roll", "roll_rerun"):
        out = ss.rollout_z_sharded(state_l, mconf, N_STEPS, mesh, None,
                                   bcs_l)
        for k in ("u", "p", "density"):
            res[f"{key}_{k}"] = getattr(out, k)
    with rs.zeroed_d_ghosts():
        out = ss.rollout_z_sharded(state_l, mconf, N_STEPS, mesh, None,
                                   bcs_l)
    res["fault_u"], res["fault_roll_p"] = out.u, out.p

    # Past int32's labels: refused before anything is allocated.
    try:
        ps.connected_components_z_sharded(
            torch.zeros((), dtype=torch.int32).expand(1, 1, 646, 1291,
                                                      1291), mesh, 0)
        res["err_int32"] = np.array("")
    except ValueError as e:
        res["err_int32"] = np.array(str(e))

    # The stop test over the whole mesh: dp 2 x sp 1, a sample a rank.
    mesh2 = make_mesh(n_dp=2, n_sp=1, device_type="cpu")
    part2 = shard_batch(host, mesh2, "cpu")
    p, r, it = ps.solve_pcg_z_sharded(part2["flags"], part2["div"], mesh2,
                                      0)
    res["dp_p"], res["dp_res"], res["dp_it"] = p, r, np.array(it)
    dist.barrier()
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


def _flags():
    f = np.ones(SHAPE, np.int32) * FL
    f[:, :, [0, -1]] = OB
    f[:, :, :, [0, -1]] = OB
    f[..., [0, -1]] = OB
    f[..., 13:19, 6:10, 4:8] = OB        # a box across the cut at z 16
    f[..., 10:23, 1:7, 9:15] = OB        # the shell ...
    f[..., 11:22, 2:6, 10:14] = FL       # ... encloses a component
    f[..., 3:29, 9:15, 9:15] = OB        # the U's block
    f[..., 6:27, 10:14, 10:12] = FL      # arm A
    f[..., 6:27, 10:14, 13:14] = FL      # arm B
    f[..., 6:8, 10:14, 10:14] = FL       # joined at z 6-7, on rank 0
    f[..., 24, 11, 14] = EM              # the U's only Dirichlet link
    f[..., 27:30, 2:5, 2:5] = EM         # the bulk's, on rank 1 too
    f[1, :, 20:23, 2:5, 2:5] = OB
    return f


def _roll_flags():
    """The rollout's scene: tests/test_torch_sharded_sim.py's, an
    obstacle box across the cut (and one more in sample 1)."""
    f = np.ones(SHAPE, np.int32) * FL
    f[:, :, [0, -1]] = OB
    f[:, :, :, [0, -1]] = OB
    f[..., [0, -1]] = OB
    f[..., 13:19, 6:10, 4:8] = OB
    f[1, :, 20:23, 3:6, 9:13] = OB
    return f


def _inputs():
    import jax.numpy as jnp
    from fluidnet_tpu.ops.boundary import set_wall_bcs
    from fluidnet_tpu.ops.divergence import velocity_divergence

    rng = np.random.default_rng(180)
    B, _, Z, Y, X = SHAPE
    flags = _flags()
    u = rng.standard_normal((B, 3, Z, Y, X)).astype(np.float32)
    jf = jnp.asarray(flags)
    div = np.array(velocity_divergence(set_wall_bcs(jnp.asarray(u), jf),
                                       jf))
    div *= np.asarray(DIV_SCALE, np.float32).reshape(B, 1, 1, 1, 1)
    return {"flags": flags, "div": div, "roll_flags": _roll_flags(),
            "x": rng.standard_normal(SHAPE).astype(np.float32),
            "u": (rng.standard_normal((B, 3, Z, Y, X)) * 0.5).astype(
                np.float32),
            "p": (rng.standard_normal(SHAPE) * 0.1).astype(np.float32),
            "density": rng.random(SHAPE).astype(np.float32)}


def _jax_refs(inp):
    """JAX's functions on the whole grid (the rollout with the fused
    knobs, as tests/test_torch_slice.py), in threads."""
    import jax.numpy as jnp
    from fluidnet_tpu.core.celltype import is_fluid
    from fluidnet_tpu.core.config import ModelConfig as JModelConfig
    from fluidnet_tpu.core.grids import FluidState as JFluidState
    from fluidnet_tpu.sim.simulate import create_plume_bcs, rollout
    from fluidnet_tpu.solvers import cg
    from fluidnet_tpu.solvers import components as jc

    flags, div, x = (jnp.asarray(inp[k]) for k in ("flags", "div", "x"))

    def small():
        labels = jc.connected_components(flags)
        out = {"labels": labels,
               "labels_cap": jc.connected_components(flags, max_iter=CAP),
               "mean": jc.component_mean(x, labels, is_fluid(flags)),
               "normalized": jc.normalize_pressure_mean(x, flags)}
        for name, kw in SOLVES.items():
            out[f"solve_{name}"] = cg.solve_pcg(flags, div, **kw)
        return _jax_np(out)

    def roll():
        state = JFluidState(flags=jnp.asarray(inp["roll_flags"]),
                            **{k: jnp.asarray(inp[k]) for k in
                               ("u", "p", "density")})
        bcs = create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.15)
        out = rollout(state, JModelConfig(**KNOBS), N_STEPS, None, None,
                      bcs)
        return {k: np.asarray(getattr(out, k)) for k in
                ("u", "p", "density")}

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLUIDNET_FUSED_EPILOGUE", "1")
        mp.setenv("FLUIDNET_FUSED_PROLOGUE", "1")
        with ThreadPoolExecutor(2) as pool:
            a, b = pool.submit(small), pool.submit(roll)
            return {**a.result(), "roll": b.result()}


def _jax_np(tree):
    if isinstance(tree, dict):
        return {k: _jax_np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_jax_np(v) for v in tree)
    return np.asarray(tree)


def _iterations(flags, div):
    """The port's unsharded solve_pcg on the whole grid: (p, its
    iteration count), counted by its dot products (2 before the loop, 3
    an iteration)."""
    from fluidnet_tpu_torch.solvers import cg
    real, calls = cg._bdot, [0]

    def counting(a, b):
        calls[0] += 1
        return real(a, b)
    cg._bdot = counting
    try:
        p, _ = cg.solve_pcg(torch.from_numpy(flags), torch.from_numpy(div))
    finally:
        cg._bdot = real
    return p.numpy(), (calls[0] - 2) // 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX's references, [rank results])."""
    tmp = str(tmp_path_factory.mktemp("torch_sharded_pcg"))
    inp = _inputs()
    in_path = os.path.join(tmp, "inputs.npz")
    np.savez(in_path, **inp)
    procs = _spawn(tmp, in_path)
    try:
        jref = _jax_refs(inp)
    finally:
        outs = _collect(procs)
    return inp, jref, outs


def _gather(outs, key):
    return np.concatenate([o[key] for o in outs], axis=2)


def _p_close(got, want):
    want = np.asarray(want)
    return np.allclose(got, want, rtol=P_RTOL,
                       atol=P_ATOL_REL * np.abs(want).max())


def test_scene():
    """The scene has what the tests need: the U is one component on the
    whole grid and two on rank 1's slab alone, its smallest label lies
    on rank 0's slab and its only Dirichlet link on rank 1's; the bulk's
    Empty cells lie on rank 1's slab; the shell's component is enclosed
    and spans the cut."""
    from fluidnet_tpu_torch.solvers.components import connected_components
    f = _flags()
    whole = connected_components(torch.from_numpy(f)).numpy()
    upper = connected_components(torch.from_numpy(f[:, :, 16:])).numpy()
    n = f[0, 0].size
    arm_a, arm_b = whole[0, 0, 20, 11, 10], whole[0, 0, 20, 11, 13]
    assert arm_a == arm_b and arm_a // (16 * 16) == 6
    assert upper[0, 0, 4, 11, 10] != upper[0, 0, 4, 11, 13]
    shell = whole[0, 0, 12, 3, 11]
    assert shell == whole[0, 0, 20, 3, 11] != n
    assert (np.argwhere(f[0, 0] == EM)[:, 0] >= 16).all()
    assert len(np.unique(whole[0])) == 4      # bulk, shell, U; non-fluid


@pytest.mark.parametrize("key", ["labels", "labels_cap"])
def test_labels_equal_jax(run, key):
    """The gathered labels equal JAX's connected_components on the whole
    grid exactly: with the grid's cap (the fixpoint) and with a cap of
    CAP sweeps, which stops the loop early (the labels differ from the
    fixpoint's); both ranks take the same sweeps."""
    _, jref, outs = run
    got = _gather(outs, key)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jref[key])
    sweeps = [int(o["sweeps" if key == "labels" else "sweeps_cap"])
              for o in outs]
    assert sweeps[0] == sweeps[1], sweeps
    if key == "labels_cap":
        assert sweeps[0] == CAP
        assert not np.array_equal(got, jref["labels"])
    else:
        assert CAP < sweeps[0] < sum(SHAPE[2:])


@pytest.mark.parametrize("key", ["mean", "normalized"])
def test_component_sums_match_jax(run, key):
    """component_mean_z_sharded and normalize_pressure_mean_z_sharded
    gathered against JAX's component_mean and normalize_pressure_mean on
    the whole grid: rtol 1e-5, atol 1e-6."""
    _, jref, outs = run
    np.testing.assert_allclose(_gather(outs, key), jref[key],
                               rtol=MEAN_RTOL, atol=MEAN_ATOL)


def test_has_dirichlet_across_slabs(run):
    """A component whose only Dirichlet link lies on rank 1's slab (the U,
    whose smallest label is on rank 0's; the bulk) counts as non-singular
    on rank 0's cells too, and the enclosed shell's component as singular
    on both."""
    _, _, outs = run
    f = _flags()
    nonsing = _gather(outs, "nonsing")
    hd = _gather(outs, "has_dirichlet")
    assert not nonsing[:, :, :16].any() and nonsing[:, :, 16:].any()
    for b in range(2):
        assert hd[b, 0, 6, 11, 10] and hd[b, 0, 10, 11, 10]   # the U
        assert hd[b, 0, 5, 8, 3]                             # the bulk
        assert not hd[b, 0, 12, 3, 11] and not hd[b, 0, 20, 3, 11]
    assert not hd[f != FL].any()


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_matches_jax(run, name):
    """solve_pcg_z_sharded gathered against JAX's solve_pcg on the whole
    grid: p at rtol 1e-4, atol 1e-4 of its largest value; the residual
    at rtol 1e-3; both ranks report the same iteration count."""
    _, jref, outs = run
    jp, jres = jref[f"solve_{name}"]
    got = _gather(outs, f"solve_{name}_p")
    print(f"{name}: p max abs err {np.abs(got - jp).max():.3e} of "
          f"{np.abs(jp).max():.3e}, iterations "
          f"{[int(o[f'solve_{name}_it']) for o in outs]}")
    assert _p_close(got, jp)
    for o in outs:
        np.testing.assert_allclose(o[f"solve_{name}_res"], jres,
                                   rtol=RES_RTOL)
    its = [int(o[f"solve_{name}_it"]) for o in outs]
    assert its[0] == its[1], its
    if SOLVES[name].get("tol", 1e-4):
        assert float(jres) <= 1e-4


def test_stop_test_over_the_mesh(run):
    """On a 2 x 1 mesh (a sample a rank) the sample that converges first
    still takes the batch's iteration count, as JAX's while_loop does, and
    both ranks return JAX's p for their sample."""
    inp, jref, outs = run
    counts = [_iterations(inp["flags"][b:b + 1], inp["div"][b:b + 1])[1]
              for b in range(2)]
    _, batch = _iterations(inp["flags"], inp["div"])
    assert counts[1] < counts[0] == batch < 100, (counts, batch)
    assert [int(o["dp_it"]) for o in outs] == [batch, batch]
    jp, jres = jref["solve_jacobi"]
    for b, o in enumerate(outs):
        assert _p_close(o["dp_p"], jp[b:b + 1]), b
        np.testing.assert_allclose(o["dp_res"], jres, rtol=RES_RTOL)


def test_rollout_matches_jax(run):
    """rollout_z_sharded with sim_method 'pcg' (max_iter 100, pcg_tol
    1e-4), 3 steps, gathered against JAX's unsharded rollout: rtol 1e-4,
    atol 1e-5."""
    _, jref, outs = run
    for k in ("u", "p", "density"):
        got = _gather(outs, f"roll_{k}")
        print(f"rollout {k}: max abs err "
              f"{np.abs(got - jref['roll'][k]).max():.3e}")
        np.testing.assert_allclose(got, jref["roll"][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("key", ["rerun_p", "roll_rerun_u", "roll_rerun_p",
                                 "roll_rerun_density"])
def test_rerun_is_bit_equal(run, key):
    """Each rank's second solve (the labels passed in) and second rollout
    equal its first to the bit: the sums run in a fixed order."""
    _, _, outs = run
    first = "solve_jacobi_p" if key == "rerun_p" else \
        key.replace("_rerun", "")
    for o in outs:
        np.testing.assert_array_equal(o[key], o[first])


@pytest.mark.parametrize("what", ["solve", "rollout"])
def test_planted_fault_fails(run, what):
    """The CG direction's exchange zeroed (each slab's apply_A sees p = 0
    across the cut): the solve and the rollout fail their limits."""
    _, jref, outs = run
    if what == "solve":
        assert not _p_close(_gather(outs, "fault_p"),
                            jref["solve_jacobi"][0])
    else:
        for k in ("u", "p"):
            key = "fault_u" if k == "u" else "fault_roll_p"
            assert not np.allclose(_gather(outs, key), jref["roll"][k],
                                   rtol=RTOL, atol=ATOL), k


def test_int32_labels_refused(run):
    """A grid of Z * Y * X >= 2^31 cells (1292 x 1291 x 1291) is refused:
    its labels do not fit int32."""
    _, _, outs = run
    for o in outs:
        assert "do not fit int32" in str(o["err_int32"])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                 sys.argv[4])
