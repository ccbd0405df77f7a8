"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels build on first use); every test
here is marked `cuda` and skips without a card. The machine with the card
has no JAX, so run this file without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Both sides run the same float32 operations (the kernels are built with
-fmad=false), so the tolerance is 1e-5 of each field's largest value;
K5 and K6 are held to a max abs error of 0, K6 on shapes that cut its
32 x 8 tiles raggedly.
Batch 2 and odd extents exercise the kernels' indexing.
"""

import numpy as np
import pytest
import torch

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.ops.advect_fast import chebyshev_free_space
from fluidnet_tpu_torch.ops.cuda import _build, forces_kernel, mac_sweep
from fluidnet_tpu_torch.ops.forces import forces_block, forces_block_xla
from fluidnet_tpu_torch.ops.warp import warp_group, warp_group_plain
from fluidnet_tpu_torch.solvers.cuda_jacobi import jacobi_cuda, jacobi_plain

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


@pytest.mark.parametrize("ours,renorm", [(True, True), (True, False),
                                         (False, False)])
def test_mac_sweep_kernel_matches_plain(dev, ours, renorm):
    c = _case(dev)
    m = is_fluid(c["flags"]).to(torch.float32)
    free = chebyshev_free_space(c["flags"], 2) if ours else None
    args = (c["u"], c["s"], m, None, None, free, -0.1, 0.6, 1, ours, renorm)
    before = dict(_build.launches)
    ref_f = mac_sweep.sweep_fused_ep_plain(*args)
    out_f = mac_sweep.advect_sweep_fused_ep(*args)
    bargs = (c["u"], c["s"], m, ref_f["u_w"].contiguous(),
             ref_f["s_val"].contiguous(), free, 0.1, 0.6, 1, ours, renorm)
    ref_b = mac_sweep.sweep_fused_ep_plain(*bargs)
    out_b = mac_sweep.advect_sweep_fused_ep(*bargs)
    torch.cuda.synchronize()
    for k in ref_f:
        _close(out_f[k], ref_f[k], f"fwd {k}")
    for k in ref_b:
        _close(out_b[k], ref_b[k], f"bwd {k}")
    assert _build.launches["mac_sweep_fwd"] == \
        before.get("mac_sweep_fwd", 0) + 1
    assert _build.launches["mac_sweep_bwd"] == \
        before.get("mac_sweep_bwd", 0) + 1


@pytest.mark.parametrize("with_bc", [False, True])
def test_prologue_kernel_matches_plain(dev, with_bc):
    c = _case(dev, 4)
    args = (c["u"], c["flags"], c["s"], [0.01, -0.2, 0.03],
            [0.0, -0.05, 0.02], 0.7, 0.1,
            c["u_bc"] if with_bc else None, c["u_inv"] if with_bc else None)
    before = _build.launches["prologue"]
    ref = forces_kernel.prologue_plain(*args)
    out = forces_kernel.prologue_cuda(*args)
    torch.cuda.synchronize()
    _close(out[0], ref[0], "u''")
    _close(out[1], ref[1], "div")
    assert _build.launches["prologue"] == before + 1


def test_forces_block_kernel_matches_plain(dev):
    """K2's forces-block form (epi=False) against forces_block_xla, direct
    and through the ops.forces.forces_block dispatch."""
    c = _case(dev, 6)
    args = (c["u"], c["flags"], c["s"], [0.01, -0.2, 0.03],
            [0.0, -0.05, 0.02], 0.7, 0.1)
    before = _build.launches["forces_block"]
    ref = forces_block_xla(*args)
    _close(forces_kernel.forces_block_cuda(*args), ref, "forces block")
    _close(forces_block(*args), ref, "forces_block dispatch")
    torch.cuda.synchronize()
    assert _build.launches["forces_block"] == before + 2


@pytest.mark.parametrize("shape", [(2, 1, 9, 13, 17), (2, 1, 1, 13, 17)])
def test_jacobi_kernel_matches_plain(dev, shape):
    """K3 in 3-D and 2-D at 0, 1, 2 and 34 sweeps: one count per solve."""
    rng = np.random.default_rng(8)
    flags = torch.tensor(_flags(rng, shape).astype(np.int32), device=dev)
    div = torch.tensor(rng.standard_normal(shape).astype(np.float32),
                       device=dev)
    before = _build.launches["jacobi"]
    for n in (0, 1, 2, 34):
        _close(jacobi_cuda(flags, div, n), jacobi_plain(flags, div, n),
               f"jacobi {n} sweeps")
    torch.cuda.synchronize()
    assert _build.launches["jacobi"] == before + 4


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

@pytest.mark.parametrize("is_bwd,ours,with_scalar,renorm", [
    (False, True, True, True), (True, True, True, True),
    (False, False, True, False), (True, False, True, False),
    (False, True, False, False), (True, False, False, False)])
def test_unfused_sweep_kernel_and_vjp_match_plain(dev, is_bwd, ours,
                                                  with_scalar, renorm):
    """K1's unfused form against sweep_plain, and its VJP (K6) against the
    plain VJP (K6's plain version), one launch each counted."""
    c = _case(dev, 13)
    m = is_fluid(c["flags"]).to(torch.float32)
    free = chebyshev_free_space(c["flags"], 2) if ours else None
    fwd_u = c["u"].roll(1, 4).contiguous() if is_bwd else None
    fwd_s = c["s"].roll(1, 3).contiguous() if is_bwd and with_scalar \
        else None
    s = c["s"] if with_scalar and not is_bwd else None
    args = (c["u"], s, m if with_scalar else None, fwd_u, fwd_s, free,
            0.1 if is_bwd else -0.1, 1, ours, with_scalar, renorm)
    _close(mac_sweep.sweep_cuda(*args), mac_sweep.sweep_plain(*args), "raw")
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
            key = "mac_sweep_unfused_" + ("bwd" if is_bwd else "fwd")
            assert _build.launches[key] == before.get(key, 0) + 1
            assert _build.launches["warp_transpose"] == \
                before.get("warp_transpose", 0) + (2 if with_scalar else 1)
    for g, p in zip(grads[False], grads[True]):
        _close(g, p, "vjp")


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


def test_vorticity_kernel_matches_plain_and_grad(dev):
    """K4 against vorticity_confinement_xla, and its replayed gradient
    against autograd of the plain composition."""
    from fluidnet_tpu_torch.ops.cuda.forces_kernel import vorticity_cuda
    from fluidnet_tpu_torch.ops.forces import (vorticity_confinement,
                                               vorticity_confinement_xla)
    c = _case(dev, 14)
    before = _build.launches["vorticity"]
    _close(vorticity_cuda(c["u"], c["flags"], 0.7),
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
