"""K6 (the adjoint of the windowed warp) of the PyTorch port against the
JAX package.

On the CPU the port's wrapper runs K6's plain version; it is held against
the JAX Pallas kernel `_warp_transpose_pallas` in interpret mode (as the
JAX suite runs it), in 3-D and 2-D, trilinear and nearest, windows 1 and 2,
with positions inside the window and past it (where the TPU kernel's tap
rules, which K6 follows, differ from `_warp_transpose_xla`'s). Then the
adjoint identity <warp(f), g> = <f, warp^T(g)> in float64 on the plain
versions, and warp_group's gradient against jax.vjp of the JAX warp_group.
One 3-D and one 2-D grid (1 x 2 groups), so the interpret-mode jit cache
is shared. Tolerance: rtol 1e-6, atol 1e-6 (the same float32 operations;
the two sum the taps in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.ops.pallas.warp import _warp_transpose_pallas
from fluidnet_tpu.ops.pallas.warp import warp_group as j_warp_group

from fluidnet_tpu_torch.ops.cuda import _build
from fluidnet_tpu_torch.ops.cuda.warp_transpose import (warp_transpose,
                                                        warp_transpose_plain)
from fluidnet_tpu_torch.ops.warp import warp_group, warp_group_plain

from tests.torch_port_util import assert_close, np_, tt

RTOL, ATOL = 1e-6, 1e-6
SHAPES = {"3d": (1, 2, 2, 6, 8, 12), "2d": (1, 2, 2, 1, 8, 12)}


def _case(shape, W, reach, nearest, seed):
    """g (b, G, F, Z, Y, X) and positions up to `reach` cells from the
    centres (z only in 3-D)."""
    rng = np.random.default_rng(seed)
    b, G, F, Z, Y, X = shape
    g = rng.standard_normal(shape).astype(np.float32)
    pos = []
    for n, axis in ((X, 4), (Y, 3), (Z, 2)):
        base = np.arange(n).reshape([n if a == axis else 1
                                     for a in range(5)]) + 0.5
        d = rng.uniform(-reach, reach, (b, G, Z, Y, X)) if n > 1 else \
            np.zeros((b, G, Z, Y, X))
        p = base + d
        if nearest:
            p = np.floor(p) + 0.5
        pos.append(p.astype(np.float32))
    return g, pos


@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("W", [1, 2])
def test_warp_transpose_matches_pallas(dim, nearest, W):
    """In-window positions (the callers' clamp) and past-window ones (up to
    W + 1.5 cells, past the borders too), against the Pallas kernel."""
    shape = SHAPES[dim]
    launches = sum(_build.launches.values())
    for reach, seed in ((W - 1e-3, 1), (W + 1.5, 2)):
        g, (px, py, pz) = _case(shape, W, reach, nearest, seed + 10 * W)
        ref = _warp_transpose_pallas(jnp.asarray(g), jnp.asarray(px),
                                     jnp.asarray(py), jnp.asarray(pz), W,
                                     nearest)
        out = warp_transpose(tt(g), tt(px), tt(py), tt(pz), W, nearest)
        assert out.shape == g.shape
        assert_close(out, ref, RTOL, ATOL, f"reach {reach}")
    # CPU tensors take the plain version: no kernel launch is counted.
    assert sum(_build.launches.values()) == launches


@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("nearest", [False, True])
def test_adjoint_identity_float64(dim, nearest):
    """<warp(f), g> == <f, warp^T(g)> on the plain versions, in float64,
    with positions inside the window (both tap rules agree there)."""
    W = 2
    g, pos = _case(SHAPES[dim], W, W - 1e-3, nearest, 5)
    rng = np.random.default_rng(6)
    f = torch.tensor(rng.standard_normal(g.shape))
    g = torch.tensor(g, dtype=torch.float64)
    px, py, pz = (torch.tensor(p, dtype=torch.float64) for p in pos)
    lhs = (warp_group_plain(f, px, py, pz, W, nearest) * g).sum()
    rhs = (f * warp_transpose_plain(g, px, py, pz, W, nearest)).sum()
    assert abs(float(lhs - rhs)) <= 1e-12 * float(abs(lhs) + 1.0)


@pytest.mark.parametrize("minmax", [False, True])
def test_warp_group_grad_matches_jax_vjp(minmax):
    """warp_group's gradient with respect to the fields (two sources, the
    min/max form too) against jax.vjp of the JAX warp_group; the positions
    get no gradient in either."""
    W = 1
    g_np, (px, py, pz) = _case(SHAPES["3d"], W, W - 1e-3, False, 7)
    rng = np.random.default_rng(8)
    f0 = rng.standard_normal(g_np.shape[:2] + (1,) + g_np.shape[3:]) \
        .astype(np.float32)
    f1 = rng.standard_normal(f0.shape).astype(np.float32)
    n_out = 2 + (2 if minmax else 0)
    cot = rng.standard_normal(f0.shape[:2] + (n_out,) + f0.shape[3:]) \
        .astype(np.float32)
    jp = [jnp.asarray(p) for p in (px, py, pz)]
    _, vjp = jax.vjp(lambda a, b: j_warp_group((a, b), *jp, window=W,
                                               minmax=minmax),
                     jnp.asarray(f0), jnp.asarray(f1))
    ref0, ref1 = vjp(jnp.asarray(cot))

    t0, t1 = tt(f0).requires_grad_(), tt(f1).requires_grad_()
    tp = [tt(p).requires_grad_() for p in (px, py, pz)]
    out = warp_group((t0, t1), *tp, W, minmax=minmax)
    (out * tt(cot)).sum().backward()
    assert_close(t0.grad, ref0, RTOL, ATOL, "source 0")
    assert_close(t1.grad, ref1, RTOL, ATOL, "source 1")
    assert all(p.grad is None for p in tp)
    assert np.isfinite(np_(out)).all()
