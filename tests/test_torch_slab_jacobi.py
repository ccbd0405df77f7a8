"""The z-sharded Jacobi solve on K3 (parallel/halo.py::slab_jacobi_solve)
and K3's starting pressure (`p0=`) of the PyTorch port, on the CPU with
gloo, against the port's jacobi_plain and JAX's solve_jacobi on the whole
grid.

The pytest process makes every input with numpy from a seed: a (B=2, Z=16,
Y=10, X=12) grid with an obstacle border, random obstacles (10%) and boxes
across the cuts at z = 4, 8 and 12, and a random divergence. This file,
run as a script, is the worker: one spawn of 2 gloo ranks and one of 4 (a
1 x n ('dp', 'sp') mesh; slabs of 8 and 4 planes) run every solve while
JAX's solve_jacobi(p_tol=0) computes in a thread. Sweeps NS: at 8 planes a
slab one round (3, 8), two (10: 8 + 2; 16: two full rounds) and three (19:
8 + 8 + 3); at 4 planes one (3) to five. Each rank solves with K3 (its
plain version on the CPU), with use_kernels=False, and with the flags
passed already grown, counts its exchanges, and writes its slabs to an
npz.

Held: every gathered solve equal to the bit to jacobi_plain on the whole
grid, and within JAX_ATOL of the largest |p| of JAX's solve_jacobi(p_tol=0,
max_iter=n) (XLA:CPU rounds a sweep about 1e-7 from PyTorch: ROADMAP queue
3, observations); 1 + (rounds - 1) exchanges a solve. On one process: n
sweeps from p0 equal the last n sweeps of a longer solve (hypothesis, 3-D
and 2-D), and a round on a slab grown by h is exact for at most h sweeps:
one sweep more spoils the own planes next to the cut.
"""

import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 300
SHAPE = (2, 1, 16, 10, 12)
WORLDS = (2, 4)
NS = (3, 8, 10, 16, 19)
# Against JAX: the largest difference over JAX's largest |p|.
JAX_ATOL = 1e-6


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rounds(n, zl):
    h = min(n, zl)
    return -(-n // h)


# --- the worker (run as a script; imports no JAX) ---------------------------

def _worker(rank, world, port, inp):
    from fluidnet_tpu_torch.parallel import halo
    from fluidnet_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from fluidnet_tpu_torch.parallel.multihost import init_multihost

    assert init_multihost(f"127.0.0.1:{port}", world, rank,
                          device_type="cpu")
    mesh = make_mesh(n_dp=1, n_sp=world, device_type="cpu")
    group = mesh["sp"].get_group()
    part = shard_batch({k: torch.from_numpy(inp[k]) for k in
                        ("flags", "div")}, mesh, device="cpu")
    flags_l, div_l = part["flags"], part["div"]
    zl = div_l.shape[2]
    calls = []
    real = halo._swap_planes

    def counting(xs, h, grp):
        calls.append(h)
        return real(xs, h, grp)
    halo._swap_planes = counting
    res = {}
    try:
        for n in NS:
            del calls[:]
            res[f"p_{n}"] = halo.slab_jacobi_solve(flags_l, div_l, mesh, n)
            res[f"exchanges_{n}"] = np.array(calls)
            res[f"plain_{n}"] = halo.slab_jacobi_solve(
                flags_l, div_l, mesh, n, use_kernels=False)
            fe, = halo.exchange_ghost([flags_l], min(n, zl), group)
            res[f"given_{n}"] = halo.slab_jacobi_solve(
                flags_l, div_l, mesh, n, flags_ext=fe)
    finally:
        halo._swap_planes = real
    return res


def _worker_main(rank, world, port, in_path, out_path):
    torch.set_num_threads(1)
    res = _worker(rank, world, port, dict(np.load(in_path)))
    np.savez(out_path, **{k: v.detach().numpy() if torch.is_tensor(v)
                          else v for k, v in res.items()})
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


# --- the pytest side --------------------------------------------------------

def _spawn(tmp, in_path, world):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        out = os.path.join(tmp, f"w{world}_rank{rank}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(world),
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


def _flags(rng, shape):
    flags = np.where(rng.random(shape) < 0.1, 2, 1).astype(np.int32)
    flags[:, :, [0, -1]] = 2
    flags[:, :, :, [0, -1]] = 2
    flags[..., [0, -1]] = 2
    flags[..., 6:10, 3:6, 4:8] = 2          # across the cut at z 8
    flags[0, :, 3:5, 5:8, 2:5] = 2          # across z 4
    flags[1, :, 11:14, 2:4, 6:10] = 2       # across z 12
    return flags


def _inputs():
    rng = np.random.default_rng(160)
    return {"flags": _flags(rng, SHAPE),
            "div": rng.standard_normal(SHAPE).astype(np.float32)}


def _jax_refs(inp):
    """JAX's solve_jacobi(p_tol=0, max_iter=n) on the whole grid, each n."""
    import jax.numpy as jnp
    from fluidnet_tpu.solvers.jacobi import solve_jacobi
    f, d = jnp.asarray(inp["flags"]), jnp.asarray(inp["div"])
    return {n: np.asarray(solve_jacobi(f, d, p_tol=0.0, max_iter=n)[0])
            for n in NS}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, JAX's solves, {world: [each rank's results]})."""
    tmp = str(tmp_path_factory.mktemp("torch_slab_jacobi"))
    inp = _inputs()
    in_path = os.path.join(tmp, "inputs.npz")
    np.savez(in_path, **inp)
    procs = {w: _spawn(tmp, in_path, w) for w in WORLDS}
    try:
        with ThreadPoolExecutor(1) as pool:
            jref = pool.submit(_jax_refs, inp).result()
    finally:
        outs = {w: _collect(p) for w, p in procs.items()}
    return inp, jref, outs


def _whole(inp, n):
    from fluidnet_tpu_torch.solvers.cuda_jacobi import jacobi_plain
    return jacobi_plain(torch.from_numpy(inp["flags"]),
                        torch.from_numpy(inp["div"]), n).numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", NS)
def test_slab_solve_matches_whole_grid(run, world, n):
    """The gathered slabs of each solve (K3's wrapper, use_kernels=False,
    the flags given grown) equal jacobi_plain on the whole grid to the
    bit, and JAX's solve_jacobi(p_tol=0) within JAX_ATOL of its largest
    |p|."""
    inp, jref, outs = run
    want = _whole(inp, n)
    for key in ("p", "plain", "given"):
        got = np.concatenate([o[f"{key}_{n}"] for o in outs[world]], axis=2)
        np.testing.assert_array_equal(got, want, f"{key} n={n}")
    got = np.concatenate([o[f"p_{n}"] for o in outs[world]], axis=2)
    err = np.abs(got - jref[n]).max() / np.abs(jref[n]).max()
    print(f"{world} ranks, {n} sweeps ({_rounds(n, SHAPE[2] // world)} "
          f"rounds): vs JAX's solve_jacobi, max abs err over its max "
          f"{err:.3e}")
    assert err <= JAX_ATOL, err
    assert np.abs(want[:, :, SHAPE[2] // 2 - 1:SHAPE[2] // 2 + 1]).max() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_exchanges_per_solve(run, world):
    """One exchange of div and the flags by h = min(n, zl) planes, then
    one of p by h before each round after the first: 1 + (rounds - 1);
    with the flags given grown, the first carries div alone (the count is
    the same)."""
    _, _, outs = run
    zl = SHAPE[2] // world
    for o in outs[world]:
        for n in NS:
            h = min(n, zl)
            assert list(o[f"exchanges_{n}"]) == [h] * _rounds(n, zl), n
    assert _rounds(19, 8) == 3 and _rounds(16, 8) == 2 and \
        _rounds(10, 4) == 3


def _case(rng, shape):
    flags = np.where(rng.random(shape) < 0.15, 2, 1).astype(np.int32)
    flags[..., [0, -1], :] = 2
    flags[..., [0, -1]] = 2
    if shape[2] > 1:
        flags[:, :, [0, -1]] = 2
    return (torch.from_numpy(flags),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(a=hs.integers(0, 12), b=hs.integers(0, 12), is3d=hs.booleans(),
       seed=hs.integers(0, 2 ** 16))
def test_sweeps_from_p0_continue_a_solve(a, b, is3d, seed):
    """jacobi_plain(f, d, a + b) equals jacobi_plain(f, d, b,
    p0=jacobi_plain(f, d, a)) to the bit, in 3-D and 2-D, and K3's
    wrapper on CPU tensors is the plain version with p0 too."""
    from fluidnet_tpu_torch.solvers.cuda_jacobi import (jacobi_cuda,
                                                        jacobi_plain)
    shape = (2, 1, 7, 9, 11) if is3d else (2, 1, 1, 9, 11)
    flags, div = _case(np.random.default_rng(seed), shape)
    start = jacobi_plain(flags, div, a)
    want = jacobi_plain(flags, div, a + b)
    assert torch.equal(jacobi_plain(flags, div, b, p0=start), want)
    assert torch.equal(jacobi_cuda(flags, div, b, p0=start), want)


@pytest.mark.parametrize("h", [1, 2, 3])
def test_round_is_exact_for_h_sweeps_only(h):
    """A round on the slab grown by h planes (one-sided at the grid's
    ends), from the whole grid's p after k sweeps, gives the whole grid's
    p after k + s sweeps on the own planes for every s <= h, also at a
    global end; s = h + 1 spoils the own plane next to an inner cut (the
    fake border's 0 has then reached it). The own planes are 6..10 of 16
    and 0..4."""
    from fluidnet_tpu_torch.solvers.cuda_jacobi import jacobi_plain
    flags, div = _case(np.random.default_rng(40 + h), SHAPE)
    k = 5
    base = jacobi_plain(flags, div, k)
    for z0, zl in ((6, 5), (0, 5)):
        lo = min(h, z0)
        hi = min(h, SHAPE[2] - z0 - zl)
        cut = slice(z0 - lo, z0 + zl + hi)
        for s in range(1, h + 2):
            got = jacobi_plain(flags[:, :, cut], div[:, :, cut], s,
                               p0=base[:, :, cut])[:, :, lo:lo + zl]
            want = jacobi_plain(flags, div, k + s)[:, :, z0:z0 + zl]
            if s <= h:
                assert torch.equal(got, want), (z0, s)
            elif z0:
                assert not torch.equal(got[:, :, 0], want[:, :, 0]), s


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker_main(*(int(a) for a in sys.argv[1:4]), sys.argv[4], sys.argv[5])
