"""K5's plain version (fluidnet_tpu_torch.ops.warp) against the JAX
package's windowed warp (fluidnet_tpu.ops.pallas.warp, in Pallas interpret
mode on the CPU, S = 1 pinned by tests/conftest.py).

Every form the 2-D advection launches, at windows 1 and 2, on a
(2, 1, 1, 20, 36) grid with 15% obstacles, at positions that reach past
both borders and, in the 'far' forms, past the window (those corners
contribute nothing). One 3-D (1, 1, 6, 10, 12) case at window 1, trilinear
with min/max and nearest. Tolerance rtol 1e-6, atol 1e-6: both sides do the
same float32 operations per corner in the same order; XLA:CPU may fuse
differently.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fluidnet_tpu.ops.pallas import warp as jw

from fluidnet_tpu_torch.ops import warp as tw

from tests.torch_port_util import assert_close, random_flags, tt

RTOL = ATOL = 1e-6
SHAPE2 = (2, 1, 1, 20, 36)
SHAPE3 = (1, 1, 6, 10, 12)


def _positions(rng, shape, G, W, reach):
    """Cell centres displaced by up to `reach` cells per axis, (b, G, z, y,
    x) each; 2-D grids keep pz at the centre (as the advection does)."""
    b, _, Z, Y, X = shape
    out = []
    for ax, n in ((4, X), (3, Y), (2, Z)):
        idx = np.arange(n, dtype=np.float32) + 0.5
        idx = idx.reshape([1, 1] + [n if a == ax else 1 for a in (2, 3, 4)])
        d = rng.uniform(-reach, reach, (b, G, Z, Y, X)).astype(np.float32)
        if n == 1:
            d[:] = 0.0
        out.append((idx + d).astype(np.float32))
    return out


def _case(seed, shape, G, W, far=False):
    rng = np.random.default_rng(seed)
    flags = random_flags(rng, shape)
    reach = W + 1.5 if far else W - 1e-3
    px, py, pz = _positions(rng, shape, G, W, reach)
    return rng, flags, px, py, pz


def _fields(rng, shape, G, F):
    b, _, Z, Y, X = shape
    return rng.standard_normal((b, G, F, Z, Y, X)).astype(np.float32)


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [tt(x) for x in a]


def _form_five_sources(seed, shape, W, far):
    """maccormackOurs' forward sweep (advect_fast.py:235): bmin, bmax, s,
    s*m, m with minmax=(0, 1)."""
    rng, flags, px, py, pz = _case(seed, shape, 1, W, far)
    s = rng.random(shape).astype(np.float32)
    fl = (flags & 1) > 0
    m = fl.astype(np.float32)
    srcs = [np.where(fl, s, 1e30).astype(np.float32),
            np.where(fl, s, -1e30).astype(np.float32), s, s * m, m]
    srcs = [a[:, None] for a in srcs]
    j = jw.warp_group(tuple(_j(*srcs)), *_j(px, py, pz), window=W,
                      minmax=(0, 1))
    t = tw.warp_group(tuple(_t(*srcs)), *_t(px, py, pz), window=W,
                      minmax=(0, 1))
    return t, j


def _form_warp_fluid(seed, shape, W, far):
    rng, flags, px, py, pz = _case(seed, shape, 1, W, far)
    s = rng.random(shape).astype(np.float32)
    j = jw.warp_fluid(jnp.asarray(s), jnp.asarray(flags),
                      *_j(px[:, 0], py[:, 0], pz[:, 0]), window=W)
    t = tw.warp_fluid(tt(s), tt(flags), *_t(px[:, 0], py[:, 0], pz[:, 0]),
                      window=W)
    return t, j


def _form_group_minmax(seed, shape, W, far):
    """The velocity's forward sweep (advect_fast.py:367): G=2, F=1."""
    rng, _, px, py, pz = _case(seed, shape, 2, W, far)
    u = _fields(rng, shape, 2, 1)
    j = jw.warp_group(jnp.asarray(u), *_j(px, py, pz), window=W, minmax=True)
    t = tw.warp_group(tt(u), *_t(px, py, pz), window=W, minmax=True)
    return t, j


def _form_group_two_sources(seed, shape, W, far):
    """The velocity's backward sweep (advect_fast.py:378): G=2, Fs=(1, 1),
    minmax=True."""
    rng, _, px, py, pz = _case(seed, shape, 2, W, far)
    u, fwd = _fields(rng, shape, 2, 1), _fields(rng, shape, 2, 1)
    j = jw.warp_group(tuple(_j(u, fwd)), *_j(px, py, pz), window=W,
                      minmax=True)
    t = tw.warp_group(tuple(_t(u, fwd)), *_t(px, py, pz), window=W,
                      minmax=True)
    return t, j


def _form_trilinear_shared(seed, shape, W, far):
    rng, _, px, py, pz = _case(seed, shape, 1, W, far)
    s = rng.standard_normal(shape).astype(np.float32)
    args = (px[:, 0], py[:, 0], pz[:, 0])
    return (tw.warp_trilinear_shared(tt(s), *_t(*args), window=W),
            jw.warp_trilinear_shared(jnp.asarray(s), *_j(*args), window=W))


def _form_trilinear(seed, shape, W, far):
    """Euler velocity advection: per-component positions, G=2, F=1."""
    rng, _, px, py, pz = _case(seed, shape, 2, W, far)
    u = _fields(rng, shape, 2, 1)[:, :, 0]
    return (tw.warp_trilinear(tt(u), *_t(px, py, pz), window=W),
            jw.warp_trilinear(jnp.asarray(u), *_j(px, py, pz), window=W))


def _form_gather_cells(seed, shape, W, far):
    """The Manta clamp lookups (advect_fast.py:170, :266): two packed
    channels at integer cells up to W (far: W + 1) from each cell."""
    rng, _, _, _, _ = _case(seed, shape, 1, W, far)
    b, _, Z, Y, X = shape
    reach = W + 1 if far else W
    cells = []
    for ax, n in ((2, X), (1, Y), (0, Z)):
        base = np.arange(n).reshape([n if a == ax else 1 for a in range(3)])
        off = rng.integers(-reach, reach + 1, (b, Z, Y, X))
        cells.append(np.clip(base + off if n > 1 else 0 * off, 0,
                             n - 1).astype(np.int32))
    packed = rng.standard_normal((b, 2, Z, Y, X)).astype(np.float32)
    return (tw.gather_cells(tt(packed), *_t(*cells), window=W),
            jw.gather_cells(jnp.asarray(packed), *_j(*cells), window=W))


FORMS = {"five_sources": _form_five_sources,
         "warp_fluid": _form_warp_fluid,
         "group_minmax": _form_group_minmax,
         "group_two_sources": _form_group_two_sources,
         "trilinear_shared": _form_trilinear_shared,
         "trilinear": _form_trilinear,
         "gather_cells": _form_gather_cells}


@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("form", list(FORMS))
def test_warp_plain_matches_jax_2d(form, window):
    t, j = FORMS[form](100 + window, SHAPE2, window, False)
    assert t.shape == j.shape
    assert_close(t, j, RTOL, ATOL, form)


@pytest.mark.parametrize("form", ["five_sources", "group_minmax",
                                  "gather_cells"])
def test_warp_plain_matches_jax_2d_past_window(form):
    """Positions past the window: those corners contribute nothing."""
    t, j = FORMS[form](200, SHAPE2, 1, True)
    assert_close(t, j, RTOL, ATOL, form)


@pytest.mark.parametrize("form", ["group_minmax", "gather_cells"])
def test_warp_plain_matches_jax_3d(form):
    t, j = FORMS[form](300, SHAPE3, 1, False)
    assert_close(t, j, RTOL, ATOL, form)


def test_clamp_displacement():
    rng = np.random.default_rng(5)
    d = [rng.uniform(-4, 4, (2, 1, 3, 4)).astype(np.float32)
         for _ in range(3)]
    for W in (1, 2):
        for a, b in zip(tw.clamp_displacement(*_t(*d), W),
                        jw.clamp_displacement(*_j(*d), W)):
            assert_close(a, b, 0, 0)


def test_warp_group_rejects_nearest_minmax():
    f = tt(np.zeros((1, 1, 1, 1, 4, 4), np.float32))
    p = tt(np.full((1, 1, 1, 4, 4), 0.5, np.float32))
    with pytest.raises(ValueError):
        tw.warp_group(f, p, p, p, 1, nearest=True, minmax=True)
