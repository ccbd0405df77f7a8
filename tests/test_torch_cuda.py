"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels build on first use); every test
here is marked `cuda` and skips without a card. The machine with the card
has no JAX, so run this file without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Both sides run the same float32 operations (the kernels are built with
-fmad=false): K1 (fused and unfused, with its VJP), K2, K3, K4, K5 and K6
are held to a max abs error of 0 (K1, K5 and K6 also at z origins up to
past K1's tiled reach), K1, K2 and K4 on shapes that cut their
xy tiles and z-ranges raggedly and on both routes of K1 (windows 1, 2
tiled, 3 global), K6 on shapes that cut its 32 x 8 tiles raggedly, K3 on
every route it takes, from p = 0 and from a given p0; rollouts to 1e-5 of
each field's largest value; rollout's CUDA graph chain to the bit against
the eager steps.
Batch 2 and odd extents exercise the kernels' indexing.
"""

import numpy as np
import pytest
import torch

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.ops.advect_fast import chebyshev_free_space
from fluidnet_tpu_torch.ops.cuda import _build, forces_kernel, mac_sweep
from fluidnet_tpu_torch.ops.cuda.warp_transpose import (
    warp_transpose_cuda, warp_transpose_plain)
from fluidnet_tpu_torch.ops.forces import forces_block, forces_block_xla
from fluidnet_tpu_torch.ops.warp import warp_group, warp_group_plain
from fluidnet_tpu_torch.solvers.cuda_jacobi import (
    device_limits, jacobi_cuda, jacobi_plain, jacobi_route)

pytestmark = pytest.mark.cuda
TOL = 1e-5
SHAPE = (2, 1, 9, 13, 17)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _flags(rng, shape):
    """15% obstacles, an obstacle border (x/y only in 2-D), Stick and
    Empty cells."""
    flags = np.where(rng.random(shape) < 0.15, 2, 1)
    flags[..., 0, :] = flags[..., -1, :] = 2
    flags[..., :, 0] = flags[..., :, -1] = 2
    if shape[2] > 1:
        flags[:, :, 0] = flags[:, :, -1] = 2
    flags = np.where((flags == 1) & (rng.random(shape) < 0.08), 128, flags)
    return np.where((flags == 1) & (rng.random(shape) < 0.05), 4, flags)


def _case(dev, seed=3):
    rng = np.random.default_rng(seed)
    flags = _flags(rng, SHAPE)
    Z, X = SHAPE[2], SHAPE[4]

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    return {"flags": torch.tensor(flags.astype(np.int32), device=dev),
            "u": t(rng.standard_normal((2, 3) + SHAPE[2:]) * 3.0),
            "s": t(rng.random(SHAPE)),
            "u_bc": t(rng.standard_normal((2, 3, Z, 4, X))),
            "u_inv": t(rng.random((2, 3, Z, 4, X)) < 0.5)}


def _exact(out, ref, what):
    """Max abs error 0: every value equal, +-inf and the +-1e30 sentinels
    included."""
    err = torch.where(out == ref, 0.0, (out - ref).abs()).max().item()
    assert err == 0.0, f"{what}: max abs err {err}"


def _close(out, ref, what):
    scale = max(ref[ref.abs() < 1e29].abs().max().item(), 1.0)
    # Equal values are no error, +-inf min/max (no corner in the window)
    # included.
    err = torch.where(out == ref, 0.0, (out - ref).abs()).max().item()
    assert err <= TOL * scale, f"{what}: max abs err {err} (scale {scale})"


# K1's shapes (b, z, y, x): the small case, x and y cutting the 32 x TY
# tiles and z the plane ranges raggedly (batch 2), y under one tile, the
# training batch and the 128^3 plume's grid.
SWEEP_SHAPES = [(2, 9, 13, 17), (2, 37, 45, 61), (1, 33, 17, 70),
                (6, 64, 64, 64), (1, 128, 128, 128)]


def _sweep_case(dev, shape, seed, W, ours):
    c = _forces_case(dev, shape, seed)
    c["m"] = is_fluid(c["flags"]).to(torch.float32)
    c["free"] = chebyshev_free_space(c["flags"], W + 1) if ours else None
    return c


def _sweep_key(W, shape, base):
    """The launch counter of K1's route at window W and u's shape."""
    return base if mac_sweep.sweep_route(W, shape) == "tiled" else \
        "mac_sweep_global"


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
@pytest.mark.parametrize("ours,renorm", [(True, True), (True, False),
                                         (False, False)])
def test_mac_sweep_kernel_matches_plain(dev, ours, renorm, shape, W):
    """K1's fused forward and backward sweeps equal their plain versions
    to the bit, on the route window W takes (the tiled route at the
    table's tile height and at each other), one launch counted each."""
    c = _sweep_case(dev, shape, 3, W, ours)
    args = (c["u"], c["s"], c["m"], None, None, c["free"], -0.1, 0.6, W,
            ours, renorm)
    ref_f = mac_sweep.sweep_fused_ep_plain(*args)
    bargs = (c["u"], c["s"], c["m"], ref_f["u_w"].contiguous(),
             ref_f["s_val"].contiguous(), c["free"], 0.1, 0.6, W, ours,
             renorm)
    ref_b = mac_sweep.sweep_fused_ep_plain(*bargs)
    heights = [None] + (list(mac_sweep.TILE_YS)
                        if mac_sweep.sweep_route(W, c["u"].shape) == "tiled"
                        else [])
    for ty in heights:
        for a, ref, key in ((args, ref_f, "mac_sweep_fwd"),
                            (bargs, ref_b, "mac_sweep_bwd")):
            key = _sweep_key(W, c["u"].shape, key)
            before = _build.launches[key]
            out = mac_sweep.advect_sweep_fused_ep(*a, tile_y=ty)
            torch.cuda.synchronize()
            assert _build.launches[key] == before + 1
            for k in ref:
                _exact(out[k], ref[k], f"{key} tile_y={ty} {k}")


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("shape", [(1, 2, 3, mac_sweep.MAX_TILED_EXTENT + 8),
                                   (1, mac_sweep.MAX_TILED_EXTENT + 8, 3, 2)])
def test_mac_sweep_long_axis_takes_the_global_route(dev, shape, W):
    """Past MAX_TILED_EXTENT a position at the clip rounds to i + W, out
    of the tile: the fused sweeps take the global route there and equal
    their plain versions to the bit on a flow at the clip everywhere."""
    c = _sweep_case(dev, shape, 5, W, False)
    args = (c["u"] * 30.0, c["s"], c["m"], None, None, None, -0.1, 0.6, W,
            False, False)
    assert mac_sweep.sweep_route(W, args[0].shape) == "global"
    before = _build.launches["mac_sweep_global"]
    ref = mac_sweep.sweep_fused_ep_plain(*args)
    out = mac_sweep.advect_sweep_fused_ep(*args)
    torch.cuda.synchronize()
    assert _build.launches["mac_sweep_global"] == before + 1
    for k in ref:
        _exact(out[k], ref[k], f"mac_sweep_global {k}")


# z origins (the global index of an array's first plane, a slab's of a
# z-sharded grid): 0, two in the thousands, and one whose z0 + Z passes
# MAX_TILED_EXTENT (K1's global route).
Z_ORIGINS = (0, 1021, 2998, mac_sweep.MAX_TILED_EXTENT - 20)


def _origin_positions(dev, shape, G, W, z0, nearest, seed):
    """(px, py, pz) (b, G, z, y, x) within +-(W - 1e-3) of the centres,
    pz global from plane z0; nearest mode's at whole-cell centres."""
    rng = np.random.default_rng(seed)
    B, Z, Y, X = shape
    pos = []
    for n, axis, first in ((X, 4, 0), (Y, 3, 0), (Z, 2, z0)):
        centre = (np.arange(first, first + n, dtype=np.float32) + 0.5)
        d = rng.uniform(-(W - 1e-3), W - 1e-3, (B, G, Z, Y, X))
        p = torch.tensor(centre.reshape([n if a == axis else 1
                                         for a in range(5)]),
                         device=dev) + torch.tensor(d.astype(np.float32),
                                                    device=dev)
        pos.append(torch.floor(p) + 0.5 if nearest else p.contiguous())
    return pos


@pytest.mark.parametrize("z0", Z_ORIGINS)
@pytest.mark.parametrize("W", [1, 2])
def test_position_kernels_at_a_z_origin(dev, W, z0):
    """K1 (fused forward and backward, the unfused forms), K5 (trilinear
    with min/max, nearest) and K6 (linear, nearest) at a z origin equal
    their plain versions there to the bit, one launch counted each; K1
    takes its global route once z0 + Z passes MAX_TILED_EXTENT."""
    shape = (2, 37, 45, 61)
    c = _sweep_case(dev, shape, 11, W, True)
    route = mac_sweep.sweep_route(W, c["u"].shape, z0)
    assert route == ("global" if z0 + shape[1] >
                     mac_sweep.MAX_TILED_EXTENT else "tiled")
    args = (c["u"], c["s"], c["m"], None, None, c["free"], -0.1, 0.6, W,
            True, True)
    ref_f = mac_sweep.sweep_fused_ep_plain(*args, z0=z0)
    fwd_u, fwd_s = ref_f["u_w"].contiguous(), ref_f["s_val"].contiguous()
    bargs = (c["u"], c["s"], c["m"], fwd_u, fwd_s, c["free"], 0.1, 0.6, W,
             True, True)
    ref_b = mac_sweep.sweep_fused_ep_plain(*bargs, z0=z0)
    for a, ref, key in ((args, ref_f, "mac_sweep_fwd"),
                        (bargs, ref_b, "mac_sweep_bwd")):
        key = key if route == "tiled" else "mac_sweep_global"
        before = _build.launches[key]
        out = mac_sweep.advect_sweep_fused_ep(*a, z0=z0)
        torch.cuda.synchronize()
        assert _build.launches[key] == before + 1
        for k in ref:
            _exact(out[k], ref[k], f"{key} z0={z0} {k}")
    for ua in ((c["u"], c["s"], c["m"], None, None, c["free"], -0.1, W, True,
                True, True),
               (c["u"], None, c["m"], fwd_u, fwd_s, c["free"], 0.1, W, True,
                True, True),
               (c["u"], None, None, None, None, c["free"], -0.1, W, True,
                False, False)):
        _exact(mac_sweep.sweep_cuda(*ua, z0=z0),
               mac_sweep.sweep_plain(*ua, z0=z0), f"unfused z0={z0}")
    g = torch.randn((2, 3, 1) + shape[1:], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    for nearest in (False, True):
        pos = _origin_positions(dev, shape, 3, W, z0, nearest, 13)
        before = _build.launches["warp"]
        out = warp_group(c["u"][:, :, None], *pos, W, nearest, not nearest,
                         z0=z0)
        torch.cuda.synchronize()
        assert _build.launches["warp"] == before + 1
        _exact(out, warp_group_plain(c["u"][:, :, None], *pos, W, nearest,
                                     not nearest, z0=z0),
               f"K5 nearest={nearest} z0={z0}")
        _exact(warp_transpose_cuda(g, *pos, W, nearest, z0),
               warp_transpose_plain(g, *pos, W, nearest, z0),
               f"K6 nearest={nearest} z0={z0}")


# K2's and K4's shapes (b, z, y, x): the small case, the 128^3 plume, the
# 6x64^3 training batch, a ragged batch of 2 (x and y cut the 32 x TY
# tiles raggedly), and y under one tile with z cut into ranges of 7.
FORCES_SHAPES = [(2, 9, 13, 17), (1, 128, 128, 128), (6, 64, 64, 64),
                 (2, 37, 45, 61), (1, 33, 17, 70)]


def _forces_case(dev, shape, seed):
    rng = np.random.default_rng(seed)
    B, Z, Y, X = shape
    flags = _flags(rng, (B, 1, Z, Y, X))

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)
    return {"flags": torch.tensor(flags.astype(np.int32), device=dev),
            "u": t(rng.standard_normal((B, 3, Z, Y, X)) * 3.0),
            "s": t(rng.random((B, 1, Z, Y, X))),
            "u_bc": t(rng.standard_normal((B, 3, Z, 4, X))),
            "u_inv": t(rng.random((B, 3, Z, 4, X)) < 0.5)}


@pytest.mark.parametrize("tile_y", forces_kernel.TILE_YS)
@pytest.mark.parametrize("shape", FORCES_SHAPES)
@pytest.mark.parametrize("with_bc", [False, True])
def test_prologue_kernel_matches_plain(dev, with_bc, shape, tile_y):
    """K2's prologue form against prologue_plain, max abs error 0, on
    every tile height the kernel instantiates."""
    c = _forces_case(dev, shape, 4)
    args = (c["u"], c["flags"], c["s"], [0.01, -0.2, 0.03],
            [0.0, -0.05, 0.02], 0.7, 0.1,
            c["u_bc"] if with_bc else None, c["u_inv"] if with_bc else None)
    before = _build.launches["prologue"]
    ref = forces_kernel.prologue_plain(*args)
    out = forces_kernel.prologue_cuda(*args, tile_y=tile_y)
    torch.cuda.synchronize()
    _exact(out[0], ref[0], "u''")
    _exact(out[1], ref[1], "div")
    assert _build.launches["prologue"] == before + 1


@pytest.mark.parametrize("tile_y", forces_kernel.TILE_YS)
@pytest.mark.parametrize("shape", FORCES_SHAPES)
def test_forces_block_kernel_matches_plain(dev, shape, tile_y):
    """K2's forces-block form (epi=False) against forces_block_xla, direct
    and through the ops.forces.forces_block dispatch, max abs error 0."""
    c = _forces_case(dev, shape, 6)
    args = (c["u"], c["flags"], c["s"], [0.01, -0.2, 0.03],
            [0.0, -0.05, 0.02], 0.7, 0.1)
    before = _build.launches["forces_block"]
    ref = forces_block_xla(*args)
    _exact(forces_kernel.forces_block_cuda(*args, tile_y=tile_y), ref,
           "forces block")
    _exact(forces_block(*args), ref, "forces_block dispatch")
    torch.cuda.synchronize()
    assert _build.launches["forces_block"] == before + 2


# K3's shapes by the route jacobi_route gives them on an H100: the
# persistent route in 3-D (ragged, batch 3 across batch edges, the 128^3
# plume, the 6x64^3 training targets) and in 2-D (the server's 128^2, a
# ragged batch of 2, 192^2, and x % 4 != 0 at several rows a block), and
# one launch a sweep past the shared-memory budget.
JACOBI_ROUTES = {(3, 1, 9, 13, 17): "persistent",
                 (2, 1, 19, 37, 61): "persistent",
                 (1, 1, 128, 128, 128): "persistent",
                 (6, 1, 64, 64, 64): "persistent",
                 (1, 1, 1, 128, 128): "persistent",
                 (2, 1, 1, 45, 61): "persistent",
                 (1, 1, 1, 192, 192): "persistent",
                 (1, 1, 1, 384, 381): "persistent",
                 (2, 1, 128, 128, 128): "sweep"}
JACOBI_SWEEPS = (0, 1, 2, 3, 8, 33, 34)


def _jacobi_case(dev, shape, seed=8):
    rng = np.random.default_rng(seed)
    flags = torch.tensor(_flags(rng, shape).astype(np.int32), device=dev)
    div = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                       device=dev)
    return flags, div


@pytest.mark.parametrize("shape", list(JACOBI_ROUTES))
def test_jacobi_kernel_matches_plain(dev, shape):
    """K3 on each route at 0-34 sweeps: bit-identical to its plain
    version (n = 1, 2, 3 catch a stale read of the global copies); one
    count per solve that sweeps."""
    flags, div = _jacobi_case(dev, shape)
    route = jacobi_route(shape, *device_limits(dev.index)).route
    assert route == JACOBI_ROUTES[shape]
    before = _build.launches["jacobi"]
    for n in JACOBI_SWEEPS:
        out, ref = jacobi_cuda(flags, div, n), jacobi_plain(flags, div, n)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), \
            f"{route} {n} sweeps: max abs err {(out - ref).abs().max()}"
    assert _build.launches["jacobi"] == before + len(JACOBI_SWEEPS) - 1


@pytest.mark.parametrize("shape", [(1, 1, 128, 128, 128), (1, 1, 1, 128, 128),
                                   (2, 1, 128, 128, 128)])
def test_jacobi_graph_replay_matches_eager(dev, shape):
    """A CUDA graph of a 34-sweep solve replays to the eager call's bits,
    and to the plain version's for a new div written in place."""
    flags, div = _jacobi_case(dev, shape, 12)
    eager = jacobi_cuda(flags, div, 34)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        jacobi_cuda(flags, div, 34)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = jacobi_cuda(flags, div, 34)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    div.mul_(-0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, jacobi_plain(flags, div, 34))


# K3 from a given p0 on each route: the persistent route at the plume,
# the training targets' batch, a slab of the 128^3 plume grown by 32 planes
# each side (the sharded jacobi-34 solve's round) and 2-D; the sweep route
# at 256^3.
JACOBI_P0_ROUTES = {(1, 1, 128, 128, 128): "persistent",
                    (6, 1, 64, 64, 64): "persistent",
                    (1, 1, 96, 128, 128): "persistent",
                    (1, 1, 1, 128, 128): "persistent",
                    (1, 1, 256, 256, 256): "sweep"}


@pytest.mark.parametrize("shape", list(JACOBI_P0_ROUTES))
def test_jacobi_from_p0_matches_plain(dev, shape):
    """K3 from a random p0 (border and obstacle cells not 0, which sweep 0
    reads as the plain version does) at 1, 2, 3 and 34 sweeps: equal to
    the bit to jacobi_plain from p0 (n = 1, 2, 3 catch a stale or zero
    halo row in another block's range); 0 sweeps give p0 back; p0 is not
    written."""
    flags, div = _jacobi_case(dev, shape, 14)
    assert jacobi_route(shape, *device_limits(dev.index)).route == \
        JACOBI_P0_ROUTES[shape]
    p0 = torch.randn(shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(3))
    keep = p0.clone()
    for n in (1, 2, 3, 34):
        out, ref = jacobi_cuda(flags, div, n, p0), \
            jacobi_plain(flags, div, n, p0)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), \
            f"{shape} {n} sweeps from p0: max abs err " \
            f"{(out - ref).abs().max()}"
    assert torch.equal(jacobi_cuda(flags, div, 0, p0), p0)
    assert torch.equal(p0, keep)


def test_jacobi_from_p0_graph_replay(dev):
    """A CUDA graph of a 34-sweep solve from p0 at 128^3 replays to the
    eager call's bits, and to the plain version's for a new p0 and div
    written in place."""
    shape = (1, 1, 128, 128, 128)
    flags, div = _jacobi_case(dev, shape, 15)
    p0 = jacobi_plain(flags, div, 5)
    eager = jacobi_cuda(flags, div, 34, p0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        jacobi_cuda(flags, div, 34, p0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = jacobi_cuda(flags, div, 34, p0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    p0.mul_(-2.0)
    div.mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, jacobi_plain(flags, div, 34, p0))


def test_wrappers_reject_bad_arguments(dev):
    c = _case(dev)
    m = is_fluid(c["flags"]).to(torch.float32)
    with pytest.raises(ValueError):
        mac_sweep.advect_sweep_fused_ep(c["u"].double(), c["s"], m, None,
                                        None, None, -0.1, 0.6, 1, False,
                                        False)
    with pytest.raises(ValueError):
        forces_kernel.prologue_cuda(c["u"].transpose(3, 4), c["flags"],
                                    c["s"], [0.0] * 3, [0.0] * 3, 0.0, 0.1)
    with pytest.raises(ValueError):
        forces_kernel.forces_block_cuda(c["u"], c["flags"].float(), c["s"],
                                        [0.0] * 3, [0.0] * 3, 0.0, 0.1)
    with pytest.raises(ValueError):
        jacobi_cuda(c["flags"].float(), c["s"], 3)
    with pytest.raises(ValueError):
        jacobi_cuda(c["flags"], c["s"], 3, c["s"][:, :, 1:])


# Launches per step of each projection: K1 twice, then K2's prologue
# (ConvNet) or forces block (jacobi, PCG), K3 for jacobi and the polish.
PROJECTIONS = {
    "convnet": ({}, {"prologue": 1}),
    "convnet_p8": (dict(polish_iters=8), {"prologue": 1, "jacobi": 1}),
    "jacobi34": (dict(sim_method="jacobi", max_iter=34),
                 {"forces_block": 1, "jacobi": 1}),
    "pcg": (dict(sim_method="pcg", max_iter=100, pcg_tol=1e-4),
            {"forces_block": 1}),
}


@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_rollout_kernels_match_plain(dev, name):
    """Batch-2 plume rollout: 3 steps with the kernels against 3 with the
    plain versions, and the launch counters of each projection."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs, rollout

    kw, per_step = PROJECTIONS[name]
    torch.manual_seed(0)
    mconf = ModelConfig(is_3d=True, dt=0.1, buoyancy_scale=2.0,
                        vorticity_confinement_amp=3.0,
                        maccormack_strength=0.6,
                        advection_method="maccormackOurs",
                        adaptive_window=False, advection_window=1, **kw)
    model = FluidNet(mconf, device=dev) if \
        mconf.sim_method == "convnet" else None
    c = _case(dev, 5)
    state = FluidState(u=c["u"] * 0.2, p=torch.zeros_like(c["s"]),
                       flags=c["flags"], density=c["s"])
    bcs = create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.2)
    _build.launches.clear()
    kern = rollout(state, mconf, 3, model, bcs)
    torch.cuda.synchronize()
    expect = {"mac_sweep_fwd": 3, "mac_sweep_bwd": 3}
    expect.update({k: 3 * v for k, v in per_step.items()})
    assert dict(_build.launches) == expect
    plain = rollout(state, mconf, 3, model, bcs, use_kernels=False)
    for field in ("u", "p", "density"):
        _close(getattr(kern, field), getattr(plain, field), field)


# rollout's CUDA graph chain (sim/chain.py), by case: mconf's knobs over
# the plume's, and the model's seed (None: no model).
CHAIN_CASES = {
    "m3d_v5_fast_trunk": ({}, 0),
    "tog_stage_path": (dict(model_type="tog"), 1),
    "tog_dil2_banked": (dict(model_type="tog", banks_num=2,
                             banks_type="dilate"), 3),
    "convnet_p8": (dict(polish_iters=8), 2),
    "jacobi34": (dict(sim_method="jacobi", max_iter=34), None),
}
CHAIN_SHAPE = (2, 1, 16, 20, 24)     # tog pools twice: extents of 4n


def _chain_case(dev, name):
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.models.fluidnet import random_model
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs

    knobs, seed = CHAIN_CASES[name]
    mconf = ModelConfig(is_3d=True, dt=0.1, buoyancy_scale=2.0,
                        vorticity_confinement_amp=3.0,
                        maccormack_strength=0.6,
                        advection_method="maccormackOurs",
                        adaptive_window=False, advection_window=1, **knobs)
    model = None if seed is None else random_model(mconf, seed, dev)
    rng = np.random.default_rng(7)
    b = CHAIN_SHAPE[0]
    state = FluidState(
        u=torch.tensor((rng.standard_normal((b, 3) + CHAIN_SHAPE[2:]) *
                        0.5).astype(np.float32), device=dev),
        p=torch.zeros(CHAIN_SHAPE, device=dev),
        flags=torch.tensor(_flags(rng, CHAIN_SHAPE).astype(np.int32),
                           device=dev),
        density=torch.tensor(rng.random(CHAIN_SHAPE).astype(np.float32),
                             device=dev))
    return mconf, model, state, create_plume_bcs(state, [1.0], u_scale=0.6,
                                                 rad=0.2)


def _steps_counted():
    from fluidnet_tpu_torch.utils import profiler
    return {k: profiler.rollout_steps[k]
            for k in ("eager", "replayed", "chains")}


def _moved(before):
    return {k: v - before[k] for k, v in _steps_counted().items()}


def _same_state(got, want, what):
    for field in ("u", "p", "density"):
        assert torch.equal(getattr(got, field), getattr(want, field)), \
            f"{what}: {field} differs"


@pytest.mark.parametrize("name", list(CHAIN_CASES))
def test_graph_rollout_equals_eager(dev, name):
    """4 calls of 3 steps on one FlagConsts (the first call's first step
    eager, then the capture, then replays) equal 12 eager steps
    (simulate) to the bit after every call; a state one call returned is
    unchanged after the later calls; the launch counter counts each
    replayed step as one eager step; save_every saves the replays'
    densities."""
    from fluidnet_tpu_torch.sim.simulate import FlagConsts, rollout, simulate

    mconf, model, state, bcs = _chain_case(dev, name)
    eager, ec = state, FlagConsts()
    _build.launches.clear()
    eager = simulate(eager, mconf, model, bcs, consts=ec)
    one = dict(_build.launches)
    wants = [eager]
    for _ in range(11):
        eager = simulate(eager, mconf, model, bcs, consts=ec)
        wants.append(eager)
    consts, out, kept = FlagConsts(), state, []
    before = _steps_counted()
    for call in range(4):
        if call == 1:
            _build.launches.clear()
        out = rollout(out, mconf, 3, model, bcs, consts=consts)
        kept.append((out, {f: getattr(out, f).clone()
                           for f in ("u", "p", "density")}))
        _same_state(out, wants[3 * call + 2], f"call {call}")
    torch.cuda.synchronize()
    assert dict(_build.launches) == {k: 9 * v for k, v in one.items()}
    assert _moved(before) == {"eager": 1, "replayed": 11, "chains": 1}
    for i, (got, snap) in enumerate(kept):
        for f, t in snap.items():
            assert torch.equal(getattr(got, f), t), f"call {i}'s {f} moved"
    end, frames = rollout(wants[5], mconf, 6, model, bcs, save_every=2,
                          consts=consts)
    _same_state(end, wants[11], "save_every")
    for j, fr in enumerate(frames):
        assert torch.equal(fr, wants[7 + 2 * j].density), f"frame {j}"


# Graphs a replayed step launches, by case: the step's own segments (PR
# 25: sim.advect, sim.step's BCs, sim.forces, the BCs again, sim.project,
# the final BCs and clamp, the copy-back), and on the banked stage path 6
# more inside sim.project (the input assembly, each bank's two stages,
# the join, the rest of the trunk).
CHAIN_GRAPHS = {"m3d_v5_fast_trunk": 7, "tog_stage_path": 7,
                "tog_dil2_banked": 13}


@pytest.mark.parametrize("name", list(CHAIN_GRAPHS))
def test_chain_segments_by_trunk(dev, name):
    """The model's spans cut the chain on the banked stage path only: the
    fast trunk's and the one-bank stage path's chains keep their graphs,
    the banked one's holds the bank and join spans, and each replay
    counts one forward of the trunk's path."""
    from fluidnet_tpu_torch.sim.simulate import FlagConsts, rollout
    from fluidnet_tpu_torch.utils import profiler

    mconf, model, state, bcs = _chain_case(dev, name)
    consts = FlagConsts()
    out = rollout(state, mconf, 2, model, bcs, consts=consts)
    program = consts.chain.program
    graphs = [x for x in program if isinstance(x, torch.cuda.CUDAGraph)]
    marks = [x[0] for x in program if not isinstance(x, torch.cuda.CUDAGraph)]
    assert len(graphs) == CHAIN_GRAPHS[name], marks
    assert any(m.startswith("model.") for m in marks) == \
        (name == "tog_dil2_banked")
    before = dict(profiler.trunk_forwards)
    rollout(out, mconf, 3, model, bcs, consts=consts)
    moved = {k: v - before.get(k, 0)
             for k, v in profiler.trunk_forwards.items()}
    assert {k: v for k, v in moved.items() if v} == {model.path: 3}


def test_graph_rollout_captures_anew_or_runs_eagerly(dev):
    """Flags changed in place, or a new model, capture the chain anew
    (and the new chain's steps equal the eager ones); PCG and the
    adaptive window past 1 run every step op by op."""
    import dataclasses

    from fluidnet_tpu_torch.models.fluidnet import random_model
    from fluidnet_tpu_torch.sim.simulate import FlagConsts, rollout, simulate

    mconf, model, state, bcs = _chain_case(dev, "m3d_v5_fast_trunk")
    consts = FlagConsts()
    before = _steps_counted()
    out = rollout(state, mconf, 3, model, bcs, consts=consts)
    out = rollout(out, mconf, 3, model, bcs, consts=consts)
    assert _moved(before) == {"eager": 1, "replayed": 5, "chains": 1}
    out.flags[:, :, 5, 5, 5] = 2
    out = rollout(out, mconf, 3, model, bcs, consts=consts)
    assert _moved(before) == {"eager": 2, "replayed": 7, "chains": 2}
    other = random_model(mconf, 5, dev)
    want = out
    for _ in range(3):
        want = simulate(want, mconf, other, bcs, consts=consts)
    out = rollout(out, mconf, 3, other, bcs, consts=consts)
    assert _moved(before) == {"eager": 3, "replayed": 9, "chains": 3}
    _same_state(out, want, "new model")
    for knobs in (dict(sim_method="pcg", max_iter=20, pcg_tol=1e-4),
                  dict(advection_window=2, adaptive_window=True)):
        m = dataclasses.replace(mconf, **knobs)
        kept = FlagConsts()
        before = _steps_counted()
        rollout(out, m, 3, model, bcs, consts=kept)
        assert _moved(before) == {"eager": 3, "replayed": 0, "chains": 0}
        assert kept.chain is None


# K5: every form the 2-D advection launches (ops/advect_fast.py), by
# (G, source channel counts, nearest, minmax).
WARP_FORMS = {"five_sources": (1, (1, 1, 1, 1, 1), False, (0, 1)),
              "warp_fluid": (1, (1, 1, 1), False, False),
              "group_minmax": (2, (1,), False, True),
              "group_two_sources": (2, (1, 1), False, True),
              "trilinear_shared": (1, (1,), False, False),
              "trilinear": (2, (1,), False, False),
              "gather_cells": (1, (2,), True, False),
              # Channel counts and bound-source pairs beyond the 2-D path's.
              "three_channels_minmax": (2, (3,), False, True),
              "eight_channels": (2, (8,), False, False),
              "pair_of_eight": (1, (1, 1, 6), False, (1, 0))}


def _warp_case(dev, shape, G, Fs, W, seed):
    """Sources with +-1e30 sentinels where flags are obstacles, positions up
    to W + 1 cells from the centres (past both borders and the window)."""
    rng = np.random.default_rng(seed)
    b, _, Z, Y, X = shape
    obst = rng.random((b, G, 1, Z, Y, X)) < 0.15
    srcs = []
    for i, F in enumerate(Fs):
        a = rng.standard_normal((b, G, F, Z, Y, X))
        if i < 2 and len(Fs) == 5:
            a = np.where(obst, 1e30 if i == 0 else -1e30, a)
        srcs.append(torch.tensor(a.astype(np.float32), device=dev))
    pos = []
    for n, axis in ((X, 4), (Y, 3), (Z, 2)):
        base = np.arange(n).reshape([n if a == axis else 1
                                     for a in range(5)]) + 0.5
        d = rng.uniform(-W - 1, W + 1, (b, G, Z, Y, X)) if n > 1 else \
            np.zeros((b, G, Z, Y, X))
        pos.append(torch.tensor((base + d).astype(np.float32), device=dev))
    return tuple(srcs) if len(srcs) > 1 else srcs[0], pos


@pytest.mark.parametrize("shape,windows", [((2, 1, 1, 45, 61), (1, 2)),
                                           ((1, 1, 9, 13, 17), (1, 2)),
                                           ((1, 1, 1, 45, 61), (1, 2)),
                                           ((2, 1, 19, 37, 61), (1, 2, 3))])
@pytest.mark.parametrize("form", list(WARP_FORMS))
def test_warp_kernel_matches_plain(dev, form, shape, windows):
    """K5 against warp_group_plain on the same CUDA inputs, 2-D and 3-D,
    max abs error 0, each launch counted once. Positions reach W + 1 cells
    from the centres: past the window and, at the border, below 0 and
    above n - 1. Odd extents (19x37x61, 45x61) leave a partial block of
    threads; W = 1, 2 and 3."""
    G, Fs, nearest, minmax = WARP_FORMS[form]
    before = _build.launches["warp"]
    for W in windows:
        fields, (px, py, pz) = _warp_case(dev, shape, G, Fs, W, 11 + W)
        if nearest:
            px, py, pz = (torch.floor(p) + 0.5 for p in (px, py, pz))
        ref = warp_group_plain(fields, px, py, pz, W, nearest, minmax)
        out = warp_group(fields, px, py, pz, W, nearest, minmax)
        torch.cuda.synchronize()
        _exact(out, ref, f"{form} W={W}")
    assert _build.launches["warp"] == before + len(windows)


def test_warp_rejects_bad_arguments(dev):
    fields, (px, py, pz) = _warp_case(dev, (1, 1, 1, 8, 9), 1, (1,), 1, 1)
    with pytest.raises(ValueError):
        warp_group(fields, px.transpose(3, 4).contiguous().transpose(3, 4),
                   py, pz, 1)
    with pytest.raises(ValueError):
        warp_group(fields.double(), px, py, pz, 1)
    with pytest.raises(ValueError):
        warp_group(fields, px, py, pz, 1, nearest=True, minmax=True)
    with pytest.raises(ValueError):
        warp_group(fields.expand(1, 1, 9, 1, 8, 9).contiguous(), px, py, pz,
                   1)


# K5 launches per 2-D step with 3 density channels, by advection method.
SERVE_K5_PER_STEP = {"maccormackOurs": 8, "maccormack": 20, "euler": 4,
                     "eulerOurs": 4}


@pytest.mark.parametrize("method", list(SERVE_K5_PER_STEP))
def test_rollout_2d_kernels_match_plain(dev, method):
    """The server's 2-D step (RGB density, adaptive window, buoyancy 1):
    3 steps with the kernels against 3 with the plain versions, and K5's
    launches per step."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.core.grids import FluidState, empty_domain
    from fluidnet_tpu_torch.models.fluidnet import random_model
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs, rollout

    torch.backends.cudnn.allow_tf32 = False
    mconf = ModelConfig(is_3d=False, dt=0.1, buoyancy_scale=1.0,
                        advection_method=method, conv_compute_dtype="float32")
    model = random_model(mconf, 0, dev)
    rng = np.random.default_rng(12)
    shape = (1, 1, 1, 40, 40)
    u = torch.tensor((rng.standard_normal((1, 2, 1, 40, 40)) * 6.0).astype(
        np.float32), device=dev)
    state = FluidState(u=u, p=torch.zeros(shape, device=dev),
                       flags=empty_domain(shape, False, device=dev),
                       density=torch.tensor(rng.random((1, 3, 1, 40, 40))
                                            .astype(np.float32), device=dev))
    bcs = create_plume_bcs(state, [1.0, 0.8, 0.3], u_scale=0.6, rad=0.15)
    _build.launches.clear()
    kern = rollout(state, mconf, 3, model, bcs)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"warp": 3 * SERVE_K5_PER_STEP[method]}
    plain = rollout(state, mconf, 3, model, bcs, use_kernels=False)
    for field in ("u", "p", "density"):
        _close(getattr(kern, field), getattr(plain, field), field)


# --- the training slice: K1's unfused forms, K6, K4, train gradients ------

@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
@pytest.mark.parametrize("is_bwd,ours,with_scalar,renorm", [
    (False, True, True, True), (True, True, True, True),
    (False, False, True, False), (True, False, True, False),
    (False, True, False, False), (True, False, False, False)])
def test_unfused_sweep_kernel_and_vjp_match_plain(dev, is_bwd, ours,
                                                  with_scalar, renorm, shape,
                                                  W):
    """K1's unfused form against sweep_plain, and its VJP (K6) against the
    plain VJP (K6's plain version), both to the bit, one launch each
    counted under the route's key."""
    c = _sweep_case(dev, shape, 13, W, ours)
    m, free = c["m"], c["free"]
    fwd_u = c["u"].roll(1, 4).contiguous() if is_bwd else None
    fwd_s = c["s"].roll(1, 3).contiguous() if is_bwd and with_scalar \
        else None
    s = c["s"] if with_scalar and not is_bwd else None
    args = (c["u"], s, m if with_scalar else None, fwd_u, fwd_s, free,
            0.1 if is_bwd else -0.1, W, ours, with_scalar, renorm)
    _exact(mac_sweep.sweep_cuda(*args), mac_sweep.sweep_plain(*args), "raw")
    grads = {}
    for plain in (False, True):
        a = list(args)
        xs = []
        for i in ((3, 4) if is_bwd else (0, 1)):
            if a[i] is not None:
                a[i] = a[i].clone().requires_grad_()
                xs.append(a[i])
        before = dict(_build.launches)
        out = mac_sweep.advect_sweep(*a, plain=plain)
        rng = torch.Generator().manual_seed(3)
        loss = sum((v * torch.randn(v.shape, generator=rng).to(dev)).sum()
                   for v in out.values())
        loss.backward()
        grads[plain] = [x.grad for x in xs]
        if not plain:
            key = _sweep_key(W, args[0].shape, "mac_sweep_unfused_" +
                             ("bwd" if is_bwd else "fwd"))
            assert _build.launches[key] == before.get(key, 0) + 1
            assert _build.launches["warp_transpose"] == \
                before.get("warp_transpose", 0) + (2 if with_scalar else 1)
    for g, p in zip(grads[False], grads[True]):
        _exact(g, p, "vjp")


@pytest.mark.parametrize("shape,windows", [
    ((2, 2, 2, 9, 13, 17), (1, 2)), ((2, 2, 2, 1, 13, 17), (1, 2)),
    ((2, 3, 1, 19, 37, 61), (1, 2, 3)), ((1, 1, 3, 1, 45, 61), (1, 2)),
    ((1, 2, 8, 9, 13, 17), (1, 2))])
@pytest.mark.parametrize("nearest", [False, True])
def test_warp_transpose_kernel_matches_plain(dev, shape, windows, nearest):
    """K6 against warp_transpose_plain, max abs error 0, positions inside
    the window and past it (below 0 and above n - 1 at the border), 3-D
    and 2-D, F = 1, 2, 3 and 8. 19x37x61 and 45x61 cut the 32 x 8 tiles
    raggedly on every axis; W = 3 takes the untiled kernel."""
    from fluidnet_tpu_torch.ops.cuda.warp_transpose import (
        warp_transpose_cuda, warp_transpose_plain)
    before = _build.launches["warp_transpose"]
    gen = torch.Generator(device=dev).manual_seed(shape[2])
    for W in windows:
        _, (px, py, pz) = _warp_case(dev, shape[:2] + shape[3:], shape[1],
                                     (1,), W, 20 + W)
        if nearest:
            px, py, pz = (torch.floor(p) + 0.5 for p in (px, py, pz))
        g = torch.randn(shape, device=dev, generator=gen)
        _exact(warp_transpose_cuda(g, px, py, pz, W, nearest),
               warp_transpose_plain(g, px, py, pz, W, nearest), f"W={W}")
    assert _build.launches["warp_transpose"] == before + len(windows)


@pytest.mark.parametrize("tile_y", forces_kernel.TILE_YS)
@pytest.mark.parametrize("shape", FORCES_SHAPES)
def test_vorticity_kernel_matches_plain_and_grad(dev, shape, tile_y):
    """K4 against vorticity_confinement_xla, max abs error 0, and its
    replayed gradient against autograd of the plain composition."""
    from fluidnet_tpu_torch.ops.cuda.forces_kernel import vorticity_cuda
    from fluidnet_tpu_torch.ops.forces import (vorticity_confinement,
                                               vorticity_confinement_xla)
    c = _forces_case(dev, shape, 14)
    before = _build.launches["vorticity"]
    _exact(vorticity_cuda(c["u"], c["flags"], 0.7, tile_y=tile_y),
           vorticity_confinement_xla(c["u"], c["flags"], 0.7), "u'")
    grads = []
    for fn in (vorticity_confinement, vorticity_confinement_xla):
        u = c["u"].clone().requires_grad_()
        (fn(u, c["flags"], 0.7) * c["u"]).sum().backward()
        grads.append(u.grad)
    _close(grads[0], grads[1], "grad")
    assert _build.launches["vorticity"] == before + 2


def test_train_loss_grad_kernels_match_plain(dev):
    """One 'full'-mode loss_fn at n = 2 with every kernel against one with
    every plain version (float32 convs, deterministic cuDNN): the loss and
    each parameter's gradient within 1e-4 relative L2; the launches per
    step (train/train.py): K1 fused 2n - 1 per direction (n forward, n - 1
    recomputed), K1 unfused and K6 for the n - 1 steps whose input depends
    on the parameters (the first step's does not: autograd skips its
    adjoint, as JAX's does), K2's prologue 2(n - 1), its forces block 1."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.models.fluidnet import random_model
    from fluidnet_tpu_torch.train.train import draw, loss_fn
    torch.backends.cudnn.deterministic = True
    mconf = ModelConfig(is_3d=True, advection_method="maccormackOurs",
                        adaptive_window=False, advection_window=1,
                        long_term_grad_mode="full",
                        conv_compute_dtype="float32")
    c = _case(dev, 15)
    batch = {"flags": c["flags"], "u_div": c["u"] * 0.2,
             "p_div": torch.zeros_like(c["s"]), "density": c["s"]}
    model = random_model(mconf, 1, dev)
    draws = draw(torch.Generator().manual_seed(4), mconf)
    draws = draws._replace(b_scale=torch.tensor(2.0),
                           v_amp=torch.tensor(3.0))
    n = 2
    res = {}
    for use_kernels in (True, False):
        _build.launches.clear()
        total, _ = loss_fn(model, batch, None, mconf, n, draws=draws,
                           use_kernels=use_kernels)
        grads = torch.autograd.grad(total, list(model.parameters()))
        torch.cuda.synchronize()
        res[use_kernels] = (total.detach(), grads, dict(_build.launches))
    assert res[False][2] == {}
    assert res[True][2] == {"mac_sweep_fwd": 2 * n - 1,
                            "mac_sweep_bwd": 2 * n - 1,
                            "mac_sweep_unfused_fwd": n - 1,
                            "mac_sweep_unfused_bwd": n - 1,
                            "warp_transpose": 4 * (n - 1),
                            "prologue": 2 * (n - 1), "forces_block": 1}
    for a, b in zip(res[True][1] + (res[True][0],),
                    res[False][1] + (res[False][0],)):
        rel = (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()
        assert rel <= 1e-4, rel


# --- the offline 3-D slice: K7 (the dyngather probe), the exact route ----

@pytest.mark.parametrize("shape", [(128, 128), (37, 61)])
@pytest.mark.parametrize("axis", [1, 0])
def test_dyngather_kernel_matches_plain(dev, shape, axis):
    """K7 against its plain version and np.take_along_axis, exactly, with
    int32 and int64 indices; one launch counted per call."""
    from fluidnet_tpu_torch.ops.cuda.dyngather import (
        take_along_axis, take_along_axis_plain)
    rng = np.random.default_rng(30 + axis)
    src = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(0, shape[axis], shape)
    before = _build.launches["dyngather"]
    for dtype in (torch.int32, torch.int64):
        s = torch.tensor(src, device=dev)
        i = torch.tensor(idx, device=dev, dtype=dtype)
        out = take_along_axis(s, i, axis)
        torch.cuda.synchronize()
        assert torch.equal(out, take_along_axis_plain(s, i, axis))
        np.testing.assert_array_equal(out.cpu().numpy(),
                                      np.take_along_axis(src, idx, axis))
    assert _build.launches["dyngather"] == before + 2


def test_pcg_solves_repeat_to_the_bit(dev):
    """Two PCG solves of one system (2 x 32 x 48 x 40, 15% obstacles: many
    enclosed components, whose means the null-space removal takes) give
    the same p and residual to the bit, with the labels computed in each
    solve and with one set of component_segments shared."""
    from fluidnet_tpu_torch.solvers.cg import solve_pcg
    from fluidnet_tpu_torch.solvers.components import (component_segments,
                                                       connected_components)
    rng = np.random.default_rng(8)
    shape = (2, 1, 32, 48, 40)
    flags = torch.tensor(_flags(rng, shape).astype(np.int32), device=dev)
    div = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                       device=dev)
    segs = component_segments(connected_components(flags))
    runs = [solve_pcg(flags, div, tol=1e-4, max_iter=60, labels=lab)
            for lab in (None, None, segs, segs)]
    for p, res in runs[1:]:
        assert torch.equal(p, runs[0][0])
        assert torch.equal(res, runs[0][1])


def test_exact_route_step_matches_cpu(dev):
    """One 3-D jacobi-34 step with advection_window 0 (the exact gather
    advection, plain PyTorch) on the card against the same step on the
    CPU: the same float32 operations, so within 1e-5 of each field's
    largest value; K1 is not launched. Every line trace of the step, run
    again on both devices from the CPU's inputs, takes the same decisions
    (hit, final cell, out of the domain, border hit, blocked, failed box
    test, back-offs); only the last bits of a position may differ, since
    the CPU's torch.sqrt is not correctly rounded in ~0.6% of values."""
    from fluidnet_tpu_torch.ops.trace_diff import (TRACE_KEYS, branch_diff,
                                                   record_traces)
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs, simulate
    mconf = ModelConfig(is_3d=True, sim_method="jacobi", max_iter=34,
                        dt=0.1, buoyancy_scale=2.0,
                        vorticity_confinement_amp=3.0,
                        advection_method="maccormackOurs",
                        adaptive_window=False, advection_window=0)
    c = _case(dev, 16)
    out, traces = {}, {}
    for d in (dev, torch.device("cpu")):
        state = FluidState(u=c["u"].to(d), p=torch.zeros_like(c["s"]).to(d),
                           flags=c["flags"].to(d), density=c["s"].to(d))
        bcs = create_plume_bcs(state, [1.0], u_scale=0.6, rad=0.2)
        _build.launches.clear()
        out[d.type], traces[d.type] = record_traces(
            lambda: simulate(state, mconf, None, bcs))
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert dict(_build.launches) == {"forces_block": 1, "jacobi": 1}
    for field in ("u", "p", "density"):
        _close(getattr(out["cuda"], field).cpu(),
               getattr(out["cpu"], field), field)
    off = branch_diff(traces["cpu"], traces["cuda"], dev)
    assert len(traces["cpu"]) == 8   # 2 scalar, 6 velocity traces
    assert all(off[k] == 0 for k in TRACE_KEYS if k != "position"), off


@pytest.mark.parametrize("z0, z1", [(19, 63), (25, 64)])
def test_slab_paths_at_a_z_origin(dev, z0, z1):
    """The kernels a z-sharded step without density runs, on a one-sided
    extended slab (planes z0 .. z1 of a 64-plane grid: a cut at both ends,
    and one ending on the grid's end): K1's unfused forward and backward
    velocity sweeps at the slab's z origin and K4 equal their plain
    versions to the bit, one launch each; their planes 10 away from a cut
    equal the whole grid's kernels' to the bit (K4's interior test, with
    no z origin, falls as the whole grid's). The exact route
    (maccormackOurs at window 0, the density and the velocity) at the
    slab's z origin on the card against the CPU: within 1e-5 of each
    field's largest value, every line trace taking the same decisions."""
    from fluidnet_tpu_torch.ops.advect import advect_scalar, advect_vel
    from fluidnet_tpu_torch.ops.advect_fast import advect_vel_fast
    from fluidnet_tpu_torch.ops.forces import vorticity_confinement_xla
    from fluidnet_tpu_torch.ops.trace_diff import (TRACE_KEYS, branch_diff,
                                                   record_traces)
    rng = np.random.default_rng(20)
    shape = (1, 1, 64, 24, 28)
    flags = torch.tensor(_flags(rng, shape).astype(np.int32), device=dev)
    u = torch.tensor((rng.standard_normal((1, 3) + shape[2:]) * 3.0)
                     .astype(np.float32), device=dev)
    s = torch.tensor(rng.random(shape).astype(np.float32), device=dev)
    fs, us, ss_ = (x[:, :, z0:z1].contiguous() for x in (flags, u, s))
    lo, hi = (10, z1 - z0 - 10 if z1 < shape[2] else z1 - z0)
    W = 1
    free, free_s = (chebyshev_free_space(f, W + 1) for f in (flags, fs))
    whole_u = advect_vel_fast(0.1, u, flags, "maccormackOurs", 0.6, W,
                              free=free)
    before = dict(_build.launches)
    got = advect_vel_fast(0.1, us, fs, "maccormackOurs", 0.6, W,
                          free=free_s, z0=z0)
    torch.cuda.synchronize()
    for key in ("mac_sweep_unfused_fwd", "mac_sweep_unfused_bwd"):
        assert _build.launches[key] == before.get(key, 0) + 1, key
    _exact(got, advect_vel_fast(0.1, us, fs, "maccormackOurs", 0.6, W,
                                free=free_s, plain=True, z0=z0),
           f"K1 unfused z0={z0}")
    _exact(got[:, :, lo:hi], whole_u[:, :, z0 + lo:z0 + hi],
           f"K1 unfused slab vs whole z0={z0}")
    before = _build.launches["vorticity"]
    got = forces_kernel.vorticity_cuda(us, fs, 0.3)
    torch.cuda.synchronize()
    assert _build.launches["vorticity"] == before + 1
    _exact(got, vorticity_confinement_xla(us, fs, 0.3), f"K4 z0={z0}")
    _exact(got[:, :, lo:hi], forces_kernel.vorticity_cuda(
        u, flags, 0.3)[:, :, z0 + lo:z0 + hi], f"K4 slab vs whole z0={z0}")
    out, traces = {}, {}
    for d in (dev, torch.device("cpu")):
        f, v, c = (x.to(d) for x in (fs, us, ss_))
        out[d.type], traces[d.type] = record_traces(lambda: (
            advect_scalar(0.1, c, v, f, "maccormackOurs", window=0, z0=z0),
            advect_vel(0.1, v, f, "maccormackOurs", window=0, z0=z0)))
    for a, b, what in zip(out["cuda"], out["cpu"], ("density", "u")):
        _close(a.cpu(), b, f"exact {what} z0={z0}")
    off = branch_diff(traces["cpu"], traces["cuda"], dev)
    assert len(traces["cpu"]) == 8   # 2 scalar, 6 velocity traces
    assert all(off[k] == 0 for k in TRACE_KEYS if k != "position"), off


def _rank_script():
    """scripts/torch_parallel_rank.py as a module."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_parallel_rank.py")
    spec = importlib.util.spec_from_file_location("torch_parallel_rank",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _transports(rep):
    """The transports a rank report names (its own, or its runs')."""
    if "transport" in rep:
        return {rep["transport"]}
    return {r["transport"] for r in rep["runs"].values()}


def _spawn(tmp_path, case, inputs, world, backend):
    """scripts/torch_parallel_rank.py --case `case` on `world` ranks of
    this host under `backend`, one timed rep: gloo (each rank on card
    rank % device_count, the exchanges staged through the host) or NCCL
    (skips without a card a rank; each rank on cuda:<rank>, device
    tensors). Checks every rank's backend, card and transport. Returns
    ([each rank's report], [each rank's saved tensors])."""
    n_cards = torch.cuda.device_count()
    if backend == "nccl" and n_cards < world:
        pytest.skip(f"NCCL needs a card a rank: {world} CUDA devices")
    torch.save(inputs, tmp_path / "in.pt")
    reports, saved, _ = _rank_script().spawn_local(
        ["--case", case, "--inputs", str(tmp_path / "in.pt"), "--reps",
         "1"], world, str(tmp_path), 300, "test", backend)
    for rank, rep in enumerate(reports):
        assert rep["backend"] == backend
        assert rep["device"] == (f"cuda:{rank}" if backend == "nccl" else
                                 f"cuda:{rank % n_cards}")
        assert _transports(rep) == {"nccl" if backend == "nccl" else
                                    "gloo, host-staged"}
    return reports, saved


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_sharded_paths_on_two_ranks(dev, tmp_path, backend):
    """parallel/ on 2 ranks (_spawn: gloo, the exchange staged through
    the host, both on one card when there is one; or NCCL, device
    tensors, a card a rank). A 1x24x20x28 grid with 15% obstacles cut at
    z 12, maccormackOurs at W = 1 and 2: each rank's exchanged planes equal its
    neighbours' (a torch.cat of the zero-padded grid's planes); each
    slab equal to the bit to the same halo-extended slab advected in this
    process, and within 1e-5 of each field's largest value of that slab
    advected by the kernels' plain versions; the gathered shards within 1e-5 of each field's largest value
    of the whole-grid advection (a slab's positions round at its own
    index magnitude); K1's two unfused sweeps and K5 twice a step, on
    each rank; the halo Jacobi (8 sweeps) equal to the bit to K3 and
    jacobi_plain on the whole grid."""
    from fluidnet_tpu_torch.ops.advect_fast import (advect_scalar_fast,
                                                    advect_vel_fast)
    rng = np.random.default_rng(29)
    shape = (1, 1, 24, 20, 28)
    flags = torch.tensor(_flags(rng, shape).astype(np.int32))
    u = torch.tensor(rng.standard_normal((1, 3) + shape[2:]) * 1.5,
                     dtype=torch.float32)
    d = torch.tensor(rng.random(shape), dtype=torch.float32)
    div = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    cases = [(1, 0.4), (2, 0.8)]
    inp = {"u": u, "density": d, "flags": flags, "cases": cases,
           "method": "maccormackOurs", "strength": 0.6,
           "jacobi": {"flags": flags, "div": div, "n_iter": 8}}
    rank_script = _rank_script()
    reports, saved = _spawn(tmp_path, "sharded", inp, 2, backend)
    u_c, d_c, f_c = u.to(dev), d.to(dev), flags.to(dev)
    for rank, s in enumerate(saved):
        want = rank_script.cut_slab(u, 2, rank, 4)
        assert torch.equal(s["halo"][0], want[:, :, :4])
        assert torch.equal(s["halo"][1], want[:, :, -4:])
    for W, dt in cases:
        for rank, s in enumerate(saved):
            want_u, want_d = rank_script.slab_reference(
                dt, u_c, d_c, f_c, 2, rank, "maccormackOurs", 0.6, W)
            assert torch.equal(s[W][0], want_u.cpu()), (W, rank)
            assert torch.equal(s[W][1], want_d.cpu()), (W, rank)
            plain_u, plain_d = rank_script.slab_reference(
                dt, u_c, d_c, f_c, 2, rank, "maccormackOurs", 0.6, W,
                plain=True)
            _close(s[W][0], plain_u.cpu(), f"u W={W} rank {rank} vs plain")
            _close(s[W][1], plain_d.cpu(),
                   f"density W={W} rank {rank} vs plain")
            assert reports[rank]["cases"][str(W)]["launches_per_step"] == {
                "mac_sweep_unfused_fwd": 1, "mac_sweep_unfused_bwd": 1,
                "warp": 2}
        whole_u = advect_vel_fast(dt, u_c, f_c, "maccormackOurs", 0.6, W)
        whole_d = advect_scalar_fast(dt, d_c, u_c, f_c, "maccormackOurs",
                                     False, 0.6, W)
        _close(torch.cat([s[W][0] for s in saved], 2), whole_u.cpu(),
               f"u W={W}")
        _close(torch.cat([s[W][1] for s in saved], 2), whole_d.cpu(),
               f"density W={W}")
    p = torch.cat([s["jacobi"] for s in saved], 2)
    assert torch.equal(p, jacobi_cuda(f_c, div.to(dev), 8).cpu())
    assert torch.equal(p, jacobi_plain(flags, div, 8))


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_slab_jacobi_on_two_ranks(dev, tmp_path, backend):
    """slab_jacobi_solve on 2 ranks (scripts/torch_parallel_rank.py --case
    jacobi; _spawn: gloo sharing the card, or NCCL on two cards, one
    a rank): a 2x24x20x28 grid with 15%
    obstacles cut at z 12, 5, 12, 30 and 34 sweeps (one to three rounds on
    slabs grown by up to 12 planes): each rank's p equal to the bit to K3
    on the whole grid and to its plain versions'; K3 launched once a
    round, and one exchange a round."""
    rng = np.random.default_rng(33)
    shape = (2, 1, 24, 20, 28)
    flags = torch.tensor(_flags(rng, shape).astype(np.int32))
    div = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    n_iters = [5, 12, 30, 34]
    reports, saved = _spawn(tmp_path, "jacobi", {
        "flags": flags, "div": div, "n_iters": n_iters}, 2, backend)
    f_c, d_c = flags.to(dev), div.to(dev)
    for n in n_iters:
        rounds = -(-n // min(n, 12))
        p = torch.cat([s[n] for s in saved], 2)
        assert torch.equal(p, jacobi_cuda(f_c, d_c, n).cpu()), n
        for rep in reports:
            r = rep["runs"][str(n)]
            assert r["launches"] == {"jacobi": rounds}, (n, r["launches"])
            assert r["comms"]["exchanges"] == rounds, (n, r["comms"])
            assert r["plain_equal"], n


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_sharded_train_step_on_two_ranks(dev, tmp_path, backend):
    """train_step(mesh=) on a 1 x 2 ('dp', 'sp') mesh of 2 ranks (scripts/
    torch_parallel_rank.py --case train_sp; _spawn: gloo sharing the card,
    or NCCL on two cards):
    m3d_v5's loss flags in float32, n = 2, a 2x32x16x16 batch with an
    obstacle box across the cut, the reject guard off. Against one
    process's loss_fn and train_step on the whole batch (deterministic
    cuDNN): the loss terms within rtol 1e-5, every gradient and every
    param after 2 steps within 1e-4 relative L2; each rank's gradients
    equal to the bit to its plain versions'; each rank launches what one
    process's step does (K1 fused 2n - 1 a direction, K1 unfused n - 1,
    K6 4(n - 1), K2's prologue 2(n - 1), its forces block once); the
    planted adjoint fault fails the gradient limit."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.train.train import (Draws, init_train_state,
                                                loss_fn, train_step)
    n = 2
    rng = np.random.default_rng(31)
    shape = (2, 1, 32, 16, 16)
    flags = np.ones(shape, np.int32)
    flags[:, :, [0, -1]] = flags[:, :, :, [0, -1]] = 2
    flags[..., [0, -1]] = 2
    flags[..., 13:19, 6:10, 4:8] = 2
    batch = {"flags": torch.tensor(flags),
             "u_div": torch.tensor(rng.standard_normal((2, 3) + shape[2:]) *
                                   0.5, dtype=torch.float32),
             "p_div": torch.tensor(rng.standard_normal(shape) * 0.1,
                                   dtype=torch.float32),
             "density": torch.tensor(rng.random(shape), dtype=torch.float32)}
    mconf = ModelConfig(
        is_3d=True, advection_method="maccormackOurs", adaptive_window=False,
        advection_window=1, maccormack_strength=0.75,
        long_term_div_lambda=1.0, long_term_grad_mode="full",
        loss_reject_threshold=0.0, conv_compute_dtype="float32")
    draws = Draws(torch.tensor(0.1), torch.tensor([0.0, -1.0, 0.0]),
                  torch.tensor(2.0), torch.tensor(0.0), torch.tensor(3.0))
    reports, saved = _spawn(tmp_path, "train_sp", {
        "batches": {"b": batch}, "draws": draws, "n": n, "model_seed": 5,
        "runs": [{"name": "f32", "mesh": (1, 2), "mconf": mconf,
                  "batch": "b"}]}, 2, backend)
    torch.backends.cudnn.deterministic = True
    try:
        b = {k: v.to(dev) for k, v in batch.items()}
        net = init_train_state(5, mconf, dev).model
        total, terms = loss_fn(net, b, None, mconf, n, draws=draws)
        grads = torch.autograd.grad(total, [
            p for _, p in net.jax_named_parameters()])
        st = init_train_state(5, mconf, dev)
        for _ in range(2):
            st, _ = train_step(st, b, None, mconf, n, draws=draws)
    finally:
        torch.backends.cudnn.deterministic = False

    def rel(a, b):
        return (torch.linalg.norm(a - b.cpu()) /
                torch.linalg.norm(b.cpu())).item()
    want = {"mac_sweep_fwd": 2 * n - 1, "mac_sweep_bwd": 2 * n - 1,
            "mac_sweep_unfused_fwd": n - 1, "mac_sweep_unfused_bwd": n - 1,
            "warp_transpose": 4 * (n - 1), "prologue": 2 * (n - 1),
            "forces_block": 1}
    for rep, s in zip(reports, saved):
        r, s = rep["runs"]["f32"], s["f32"]
        assert r["launches"] == want
        assert r["plain_equal"], r["plain_max_abs"]
        for k, v in terms.items():
            v = float(v.detach())
            assert abs(r["terms"][k] - v) <= 1e-5 * abs(v), k
        assert max(rel(a, g) for a, g in zip(s["grads"], grads)) <= 1e-4
        assert max(rel(a, p.detach()) for a, p in
                   zip(s["params"], st.params)) <= 1e-4
        assert max(rel(a, g) for a, g in zip(s["fault"], grads)) > 1e-4


# The z-sharded step on ranks (scripts/torch_parallel_rank.py --case
# step): tests/test_torch_sharded_sim.py's limits against one process's
# rollout on the card (the largest difference over the field's largest
# value, and the share of cells past STEP_ROUND of it); PCG's sums add
# in another order and CG carries the rounding: rtol 1e-4, atol 1e-5 of
# the field's largest value (tests/test_torch_sharded_pcg.py's rollout).
STEP_MAX, STEP_ROUND, STEP_FRAC = 1e-5, 1e-6, 1e-3
PCG_RTOL, PCG_ATOL = 1e-4, 1e-5
CANCEL = 1e-2
STEP_KNOBS = dict(is_3d=True, sim_method="convnet", dt=0.1,
                  buoyancy_scale=2.0, vorticity_confinement_amp=3.0,
                  maccormack_strength=0.6, advection_method="maccormackOurs",
                  adaptive_window=False, advection_window=1,
                  conv_compute_dtype="float32")
K1_FUSED = {"mac_sweep_fwd": 1, "mac_sweep_bwd": 1}
# Each route: mconf changes and the launches a rank makes a step.
STEP_ROUTES = {
    "convnet": ({}, dict(K1_FUSED, prologue=1)),
    "pcg": (dict(sim_method="pcg", max_iter=100, pcg_tol=1e-4),
            dict(K1_FUSED, forces_block=1)),
    "window0": (dict(advection_window=0), {"prologue": 1}),
}


def _plume_state(shape, seed):
    """A global (u, p, flags, density) on the host, made with numpy: a
    random velocity, pressure and density, an obstacle border and a box
    across every z cut of 2 and 4 slabs."""
    rng = np.random.default_rng(seed)
    B, _, Z, Y, X = shape
    flags = np.ones(shape, np.int32)
    flags[:, :, [0, -1]] = flags[:, :, :, [0, -1]] = 2
    flags[..., [0, -1]] = 2
    for cut in range(Z // 4, Z, Z // 4):
        flags[..., cut - 2:cut + 2, 3:6, 4:8] = 2
    return {"u": torch.tensor(rng.standard_normal((B, 3, Z, Y, X)) * 0.5,
                              dtype=torch.float32),
            "p": torch.tensor(rng.standard_normal(shape) * 0.1,
                              dtype=torch.float32),
            "flags": torch.tensor(flags),
            "density": torch.tensor(rng.random(shape), dtype=torch.float32)}


def _step_runs(dev, tmp_path, state, routes, steps, world, backend):
    """rollout_z_sharded of each of `routes` (STEP_ROUTES) for `steps`
    steps on `world` ranks, against one process's rollout on the card
    with the same weights (random_model, seed 3): every rank's slab
    equal to the bit to its rerun with the kernels' plain versions, its
    launches the route's a step, the first step's model inputs (u, K2's
    divergence) equal to the bit to the whole grid's own planes, and
    the gathered state within the route's limits. Returns the reports."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.models.fluidnet import random_model
    from fluidnet_tpu_torch.sim.simulate import rollout
    rs = _rank_script()
    runs = [{"name": r, "mconf": ModelConfig(**STEP_KNOBS).replace(
        **STEP_ROUTES[r][0]), "state": "s", "steps": steps, "fault": False,
        "model_seed": 3} for r in routes]
    reports, saved = _spawn(tmp_path, "step", {
        "states": {"s": state}, "runs": runs, "model": None}, world,
        backend)
    zl = state["u"].shape[2] // world
    for run in runs:
        name, m = run["name"], run["mconf"]
        st, bcs = rs.plume({"s": state}, "s")
        st = FluidState(**{k: getattr(st, k).to(dev)
                           for k in ("u", "p", "flags", "density")})
        bcs = type(bcs)(**{k: None if v is None else v.to(dev)
                           for k, v in vars(bcs).items()})
        net = None
        if m.sim_method == "convnet":
            net = rs.FirstInput(random_model(m, 3, dev))
        out = rollout(st, m, steps, net, bcs)
        for rank, rep in enumerate(reports):
            r = rep["runs"][name]
            assert r["plain_equal"], (name, rank, r["plain_max_abs"])
            assert r["launches"] == {k: v * steps for k, v in
                                     STEP_ROUTES[name][1].items()}, \
                (name, rank, r["launches"])
            if net is not None:
                own = slice(rank * zl, (rank + 1) * zl)
                s = saved[rank][name]
                assert torch.equal(s["first_u"],
                                   net.seen[:, :, own].cpu()), (name, rank)
                assert torch.equal(s["first_div"],
                                   net.div[:, :, own].cpu()), (name, rank)
        for k in ("u", "p", "density"):
            got = torch.cat([s[name][k] for s in saved], dim=2)
            want = getattr(out, k).cpu()
            scale = want.abs().max().item()
            err = (got - want).abs() / scale
            print(f"{backend} {name} {k}: max {err.max().item():.3e} of the "
                  f"field's max, share past {STEP_ROUND} "
                  f"{(err > STEP_ROUND).double().mean().item():.3e}")
            if m.sim_method == "pcg":
                assert torch.allclose(got, want, rtol=PCG_RTOL,
                                      atol=PCG_ATOL * scale), (name, k)
            else:
                assert err.max().item() <= STEP_MAX, (name, k)
                assert (err > STEP_ROUND).double().mean().item() <= \
                    STEP_FRAC, (name, k)
    return reports


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_sharded_step_on_two_ranks(dev, tmp_path, backend):
    """rollout_z_sharded on 2 ranks (_spawn: gloo sharing the card, or
    NCCL on two cards) of a 1x32x16x16 plume with boxes across the cut,
    2 steps of each route: the ConvNet at window 1 (G 13), PCG
    (labelling across the slabs, the CG loop's dots and component sums
    as all_reduces) and the exact route at window 0 (G 27 past a slab's
    16 planes), each held as _step_runs holds it."""
    _step_runs(dev, tmp_path, _plume_state((1, 1, 32, 16, 16), 41),
               ["convnet", "pcg", "window0"], 2, 2, backend)


@pytest.mark.parametrize("case", ["step", "train"])
def test_two_hop_exchange_on_four_ranks(dev, tmp_path, case):
    """NCCL on 4 cards, one a rank, on slabs of 8 planes at window 0
    (G 27, past the grid's 24 planes beyond a slab in a step: each
    exchange reaches three ranks away, where the grid has them), so that
    the exchange past the next rank and, in training, its adjoint move
    device tensors. "step": 2 steps of the exact route's
    rollout, held as _step_runs holds it (the ghost zone and the ranks it
    reaches checked). "train": train_step(mesh=) on a 1 x 4 mesh, m3d_v5's
    loss flags at window 0 in float32, n = 2, a 1x32x16x16 batch, against
    one process's loss_fn and train_step (torch's deterministic
    algorithms on both sides): terms within rtol 1e-5, gradients within
    1e-4 relative L2 (of CANCEL times the whole gradient's norm where a
    parameter's own is smaller) and the params after 2 steps within 1e-4
    relative L2, each rank's gradients
    equal to the bit to its plain versions', K2's launches alone
    (prologue 2(n - 1), forces block once); the dropped adjoint fails."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.train.train import (Draws, init_train_state,
                                                loss_fn, train_step)
    world, shape = 4, (1, 1, 32, 16, 16)
    state = _plume_state(shape, 43)
    if case == "step":
        reports = _step_runs(dev, tmp_path, state, ["window0"], 2, world,
                             "nccl")
        for rep in reports:
            r = rep["runs"]["window0"]
            # G 27, cut to the 24 planes beyond a slab: three ranks away.
            assert r["ghost"] == 24 and max(r["hops_per_step"]) == 3, r
        return
    n = 2
    batch = {"flags": state["flags"], "u_div": state["u"],
             "p_div": state["p"], "density": state["density"]}
    mconf = ModelConfig(
        is_3d=True, advection_method="maccormackOurs", adaptive_window=False,
        advection_window=0, maccormack_strength=0.75,
        long_term_div_lambda=1.0, long_term_grad_mode="full",
        loss_reject_threshold=0.0, conv_compute_dtype="float32")
    draws = Draws(torch.tensor(0.1), torch.tensor([0.0, -1.0, 0.0]),
                  torch.tensor(2.0), torch.tensor(0.0), torch.tensor(3.0))
    reports, saved = _spawn(tmp_path, "train_sp", {
        "batches": {"b": batch}, "draws": draws, "n": n, "model_seed": 5,
        "runs": [{"name": "w0", "mesh": (1, world), "mconf": mconf,
                  "batch": "b"}]}, world, "nccl")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        b = {k: v.to(dev) for k, v in batch.items()}
        net = init_train_state(5, mconf, dev).model
        total, terms = loss_fn(net, b, None, mconf, n, draws=draws)
        grads = torch.autograd.grad(total, [
            p for _, p in net.jax_named_parameters()])
        st = init_train_state(5, mconf, dev)
        for _ in range(2):
            st, _ = train_step(st, b, None, mconf, n, draws=draws)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False

    def rel(a, b):
        return (torch.linalg.norm(a - b.cpu()) /
                torch.linalg.norm(b.cpu())).item()

    def grad_err(got, want):
        """The worst parameter's gradient error over the larger of its
        one-process gradient's norm and CANCEL of the whole gradient's
        (tests/test_torch_sharded_exact.py's rule: a parameter whose
        gradient is a sum that cancels, the final bias, is held to the
        whole gradient's scale)."""
        whole = torch.linalg.norm(torch.cat([g.reshape(-1) for g in want]))
        return max((torch.linalg.norm(a - b.cpu()) / torch.maximum(
            torch.linalg.norm(b.cpu()), CANCEL * whole.cpu())).item()
            for a, b in zip(got, want))
    for rep, s in zip(reports, saved):
        r, s = rep["runs"]["w0"], s["w0"]
        assert r["ghost"] == 27 > r["slab"][2] == 8
        assert r["launches"] == {"prologue": 2 * (n - 1), "forces_block": 1}
        assert r["comms"]["adjoint_exchanges"] > 0, r["comms"]
        assert r["plain_equal"], r["plain_max_abs"]
        for k, v in terms.items():
            v = float(v.detach())
            assert abs(r["terms"][k] - v) <= 1e-5 * abs(v), k
        params = max(rel(a, p.detach()) for a, p in
                     zip(s["params"], st.params))
        print(f"nccl w0 train: gradients' worst error "
              f"{grad_err(s['grads'], grads):.3e} (each parameter's "
              f"relative L2 up to "
              f"{max(rel(a, g) for a, g in zip(s['grads'], grads)):.3e}), "
              f"params {params:.3e}, "
              f"dropped adjoint {grad_err(s['fault'], grads):.3e}")
        assert grad_err(s["grads"], grads) <= 1e-4
        assert params <= 1e-4
        assert grad_err(s["fault"], grads) > 1e-4
