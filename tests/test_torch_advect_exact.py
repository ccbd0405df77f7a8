"""The port's exact gather advection (ops/advect.py with window None / 0,
ops/line_trace.py, ops/interp.py) against the JAX package's
(fluidnet_tpu.ops.advect with window=None, plain XLA: no Pallas kernel),
and against the golden arrays of tests/fixtures/golden_ops.npz.

All six methods, the scalar with sample_outside_fluid both ways and the
MAC velocity, on a 2-D (2, 1, 1, 13, 14) and a 3-D (1, 1, 10, 13, 14)
grid with 15% obstacles (obstacle cells beside fluid everywhere) and a
velocity of up to ~3 cells a step, so that rays hit obstacles and leave
the domain. Both sides run the same float32 operations in the same order,
except that XLA:CPU contracts two multiply-adds of the line trace's fused
loop body (c + u * step and o + t * d) into FMAs, one rounding instead of
two; emulating those two FMAs makes the traced positions bit-identical.
So a traced position may differ by an ulp (~1e-6 at 10 cells), which
moves an interpolated value by up to that times the field's difference
across a cell. Tolerance: rtol 1e-5 and atol 1e-5 for the scalar (values
in [0, 1]); for the velocity atol 1e-6 x max|u| (~4e-5 here), since its
differences across a cell reach max|u|. A flipped branch moves a value by
up to a cell's difference, ~1e5 times more; a failure reports how many
cells differ. The golden arrays hold at atol 2e-5, as
tests/test_golden_fixtures.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidnet_tpu.ops import advect as j_advect
from fluidnet_tpu.ops.interp import cell_center_positions as j_centers
from fluidnet_tpu.ops.line_trace import line_trace as j_line_trace

from fluidnet_tpu_torch.ops import advect
from fluidnet_tpu_torch.ops.interp import cell_center_positions
from fluidnet_tpu_torch.ops.line_trace import line_trace

from tests.torch_port_util import DEV, np_, random_flags, tt

RTOL = ATOL = 1e-5
DT, STRENGTH = 0.1, 0.75
SHAPES = {"2d": (2, 1, 1, 13, 14), "3d": (1, 1, 10, 13, 14)}
METHODS = list(advect.METHODS)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "golden_ops.npz")


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, (tag, shape) in enumerate(SHAPES.items()):
        rng = np.random.default_rng(70 + i)
        flags = random_flags(rng, shape, p_obstacle=0.15)
        c = 3 if tag == "3d" else 2
        u = (rng.standard_normal((shape[0], c) + shape[2:]) * 10.0).astype(
            np.float32)
        s = rng.random(shape).astype(np.float32)
        out[tag] = (flags, u, s)
    return out


@pytest.fixture(scope="module")
def jax_vel(cases):
    """JAX's advect_vel(window=None) per grid and method. JAX maps rk2Ours
    and rk3Ours to maccormackOurs before computing anything
    (advect.py:447-448), so those share maccormackOurs' result."""
    memo = {}

    def get(tag, method):
        key = (tag, "maccormackOurs" if method in ("rk2Ours", "rk3Ours")
               else method)
        if key not in memo:
            flags, u, _ = cases[tag]
            memo[key] = np.asarray(j_advect.advect_vel(
                DT, jnp.asarray(u), jnp.asarray(flags), method=method,
                maccormack_strength=STRENGTH, window=None))
        return memo[key]
    return get


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = np_(got), np_(want)
    off = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not off.any(), (
        f"{what}: {int(off.sum())} of {off.size} cells differ beyond rtol "
        f"{rtol}, atol {atol}; max abs difference "
        f"{np.abs(got - want).max():.3e}")


@pytest.mark.parametrize("sof", [False, True])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("tag", list(SHAPES))
def test_advect_scalar_exact(cases, tag, method, sof):
    flags, u, s = cases[tag]
    kw = dict(method=method, sample_outside_fluid=sof,
              maccormack_strength=STRENGTH, window=None)
    j = j_advect.advect_scalar(DT, jnp.asarray(s), jnp.asarray(u),
                               jnp.asarray(flags), **kw)
    t = advect.advect_scalar(DT, tt(s), tt(u), tt(flags), **kw)
    assert t.shape == s.shape
    _close(t, j, f"{tag} {method} sample_outside_fluid={sof}")
    # window 0 is the exact path too.
    kw["window"] = 0
    assert torch.equal(advect.advect_scalar(DT, tt(s), tt(u), tt(flags),
                                            **kw), t)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("tag", list(SHAPES))
def test_advect_vel_exact(cases, jax_vel, tag, method):
    flags, u, _ = cases[tag]
    t = advect.advect_vel(DT, tt(u), tt(flags), method=method,
                          maccormack_strength=STRENGTH, window=None)
    _close(t, jax_vel(tag, method), f"{tag} {method} velocity",
           atol=1e-6 * float(np.abs(u).max()))


@pytest.mark.parametrize("method", ["euler", "maccormack", "eulerOurs",
                                    "maccormackOurs"])
@pytest.mark.parametrize("tag", ["2d", "3d"])
def test_advect_golden(tag, method):
    """The arrays of tests/make_fixtures.py (oracle-validated), with
    test_golden_fixtures.py's arguments and tolerance."""
    data = np.load(GOLDEN)
    flags, u, s = (tt(data[f"{tag}/{k}"]) for k in ("flags", "u", "s"))
    _close(advect.advect_scalar(0.3, s, u, flags, method=method,
                                window=None),
           data[f"{tag}/advect_s_{method}"], f"{tag} {method} scalar",
           rtol=0.0, atol=2e-5)
    _close(advect.advect_vel(0.25, u, flags, method=method, window=None),
           data[f"{tag}/advect_u_{method}"], f"{tag} {method} velocity",
           rtol=0.0, atol=2e-5)


@pytest.mark.parametrize("tag", list(SHAPES))
def test_line_trace(cases, tag):
    """Rays from every cell centre: short ones, ones that hit an obstacle,
    leave the domain, or are longer than max_steps cells (12 to 20
    cells); positions within 1e-5, hit flags equal."""
    flags, _, _ = cases[tag]
    shape = flags.shape
    rng = np.random.default_rng(90)
    b = shape[0]
    disp = rng.standard_normal((3, b) + shape[2:]) * 2.0
    far = rng.random((b,) + shape[2:]) < 0.2
    disp = np.where(far, disp / np.linalg.norm(disp, axis=0) *
                    rng.uniform(12, 20, far.shape), disp).astype(np.float32)
    if tag == "2d":
        disp[2] = 0.0
    jp = [jnp.broadcast_to(p, (b,) + shape[2:])
          for p in j_centers(shape, jnp.float32)]
    tp = [p.expand((b,) + shape[2:])
          for p in cell_center_positions(shape, torch.float32, DEV)]
    jh, *jpos = j_line_trace(*jp, *(jnp.asarray(d) for d in disp),
                             jnp.asarray(flags))
    th, *tpos = line_trace(*tp, *(tt(d) for d in disp), tt(flags))
    np.testing.assert_array_equal(np_(th), np_(jh))
    assert np_(th).any() and not np_(th).all()
    for axis, a, w in zip("xyz", tpos, jpos):
        _close(a, w, f"{tag} line_trace {axis}", rtol=0.0, atol=1e-5)


@pytest.mark.parametrize("sof", [False, True])
@pytest.mark.parametrize("tag", list(SHAPES))
def test_window_minmax_count(cases, tag, sof):
    """The Ours clamp's separable masked min / max / valid-cell count,
    held directly (exact: min, max and sums of small integers)."""
    flags, _, s = cases[tag]
    is_3d = tag == "3d"
    j = j_advect._window_minmax_count(jnp.asarray(s), jnp.asarray(flags),
                                      sof, is_3d)
    t = advect._window_minmax_count(tt(s), tt(flags), sof, is_3d)
    for name, a, w in zip(("min", "max", "count"), t, j):
        np.testing.assert_array_equal(np_(a), np_(w), err_msg=name)
    # Windows without a fluid cell exist (count 0), and revert to fwd.
    if not sof:
        assert (np_(t[2]) == 0).any()
