"""The port's 2-D windowed advection (ops/advect.py, ops/advect_fast.py on
K5's plain version) against the JAX package's (fluidnet_tpu.ops.advect with
a window, which runs advect_fast on the Pallas warp in interpret mode).

`advect_scalar` (one density channel of a batch-2 RGB density) and
`advect_vel` with windows 1 and 2, for maccormackOurs, maccormack, euler
and eulerOurs, on a (2, 1, 1, 18, 30) grid with 15% obstacles. The velocity
moves up to ~3 cells a step, so the window clamp, the free-space trace
clamp and the border clamps all act. Tolerance rtol 1e-5, atol 1e-5: the
same float32 operations in the same order on both sides, through up to two
warps, a renormalizing division and a clamp.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fluidnet_tpu.ops.advect import advect_scalar as j_advect_scalar
from fluidnet_tpu.ops.advect import advect_vel as j_advect_vel

from fluidnet_tpu_torch.ops.advect import advect_scalar, advect_vel

from tests.torch_port_util import assert_close, random_flags, tt

RTOL = ATOL = 1e-5
SHAPE = (2, 1, 1, 18, 30)
METHODS = ["maccormackOurs", "maccormack", "euler", "eulerOurs"]
DT, STRENGTH = 0.1, 0.75


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(60)
    flags = random_flags(rng, SHAPE, p_obstacle=0.15)
    u = (rng.standard_normal((2, 2) + SHAPE[2:]) * 12.0).astype(np.float32)
    rho = rng.random((2, 3) + SHAPE[2:]).astype(np.float32)
    return flags, u, rho


@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_advect_scalar_2d(case, method, window):
    flags, u, rho = case
    kw = dict(method=method, sample_outside_fluid=False,
              maccormack_strength=STRENGTH, window=window)
    j = j_advect_scalar(DT, jnp.asarray(rho[:, 1:2]), jnp.asarray(u),
                        jnp.asarray(flags), **kw)
    t = advect_scalar(DT, tt(rho)[:, 1:2], tt(u), tt(flags), **kw)
    assert t.shape == (2, 1) + SHAPE[2:]
    assert_close(t, j, RTOL, ATOL, f"{method} W={window}")


@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_advect_vel_2d(case, method, window):
    flags, u, _ = case
    kw = dict(method=method, maccormack_strength=STRENGTH, window=window)
    j = j_advect_vel(DT, jnp.asarray(u), jnp.asarray(flags), **kw)
    t = advect_vel(DT, tt(u), tt(flags), **kw)
    assert_close(t, j, RTOL, ATOL, f"{method} W={window}")


def test_advect_exact_path_raises(case):
    """A bad method raises on both paths. The exact path (window None),
    which raised before it was ported, runs and matches JAX's for Manta's
    maccormack (tests/test_torch_advect_exact.py covers every method)."""
    flags, u, rho = case
    for window in (None, 1):
        with pytest.raises(ValueError):
            advect_vel(DT, tt(u), tt(flags), method="bogus", window=window)
        with pytest.raises(ValueError):
            advect_scalar(DT, tt(rho)[:, :1], tt(u), tt(flags),
                          method="bogus", window=window)
    kw = dict(method="maccormack", window=None)
    j = j_advect_scalar(DT, jnp.asarray(rho[:, :1]), jnp.asarray(u),
                        jnp.asarray(flags), **kw)
    assert_close(advect_scalar(DT, tt(rho)[:, :1], tt(u), tt(flags), **kw),
                 j, RTOL, ATOL, "exact scalar")
    j = j_advect_vel(DT, jnp.asarray(u), jnp.asarray(flags), **kw)
    assert_close(advect_vel(DT, tt(u), tt(flags), **kw), j, RTOL, ATOL,
                 "exact velocity")
