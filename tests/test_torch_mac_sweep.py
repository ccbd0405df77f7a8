"""K1 (the fused-epilogue MacCormack sweep) of the PyTorch port against the
JAX package.

On the CPU the port's wrapper runs K1's plain PyTorch version; it is held
against the JAX Pallas kernel `advect_sweep_fused_ep` in interpret mode
(as the JAX suite runs it), forward and backward, and the port's
`advect_vel_scalar_fast` against the JAX one with fused_epilogue=True.
One grid, (1, c, 6, 8, 16) with 15% obstacles, so the interpret-mode jit
cache is shared. Tolerance: atol 1e-5, rtol 1e-5 (both sides run the same
float32 operations; XLA:CPU and PyTorch may round sums differently).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidnet_tpu.core.celltype import is_fluid as j_is_fluid
from fluidnet_tpu.ops.advect_fast import \
    advect_vel_scalar_fast as j_advect
from fluidnet_tpu.ops.advect_fast import \
    chebyshev_free_space as j_chebyshev
from fluidnet_tpu.ops.pallas.mac_sweep import \
    advect_sweep_fused_ep as j_sweep

from fluidnet_tpu_torch.ops.advect_fast import advect_vel_scalar_fast
from fluidnet_tpu_torch.ops.cuda import _build
from fluidnet_tpu_torch.ops.cuda.mac_sweep import advect_sweep_fused_ep

from tests.torch_port_util import assert_close, np_, random_flags, tt

RTOL, ATOL = 1e-5, 1e-5
DT, STRENGTH, W = 0.3, 0.6, 1
SHAPE = (1, 1, 6, 8, 16)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(23)
    flags = random_flags(rng, SHAPE, p_obstacle=0.15)
    u = (rng.standard_normal((1, 3) + SHAPE[2:]) * 0.9).astype(np.float32)
    s = rng.random(SHAPE).astype(np.float32)
    # m and free exactly as advect_vel_scalar_fast builds them (free is
    # weakly typed there), so the sweeps below and the ones inside the
    # JAX advection share one interpret-mode compile.
    jflags = jnp.asarray(flags)
    return {"flags": flags, "u": u, "s": s,
            "m": j_is_fluid(jflags).astype(jnp.float32),
            "free": j_chebyshev(jflags, W + 1)}


@pytest.fixture(scope="module")
def jax_sweeps(case):
    """One forward and one backward live Pallas sweep (interpret mode),
    'Ours' with the renormalized scalar, as the slice runs them."""
    c = {k: v if k in ("m", "free") else jnp.asarray(v)
         for k, v in case.items()}
    fwd = j_sweep(c["u"], c["s"], c["m"], None, None, c["free"], -DT,
                  STRENGTH, W, True, True)
    bwd = j_sweep(c["u"], c["s"], c["m"], fwd["u_w"], fwd["s_val"],
                  c["free"], DT, STRENGTH, W, True, True)
    return ({k: np_(v) for k, v in fwd.items()},
            {k: np_(v) for k, v in bwd.items()})


def test_sweep_forward_matches_pallas(case, jax_sweeps):
    launches = sum(_build.launches.values())
    out = advect_sweep_fused_ep(tt(case["u"]), tt(case["s"]), tt(case["m"]),
                                None, None, tt(case["free"]), -DT, STRENGTH,
                                W, True, True)
    ref = jax_sweeps[0]
    assert set(out) == set(ref)
    for k in ref:
        assert_close(out[k], ref[k], RTOL, ATOL, k)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert sum(_build.launches.values()) == launches


def test_sweep_backward_matches_pallas(case, jax_sweeps):
    fwd, ref = jax_sweeps
    out = advect_sweep_fused_ep(tt(case["u"]), tt(case["s"]), tt(case["m"]),
                                tt(fwd["u_w"]), tt(fwd["s_val"]),
                                tt(case["free"]), DT, STRENGTH, W, True,
                                True)
    assert set(out) == set(ref)
    for k in ref:
        assert_close(out[k], ref[k], RTOL, ATOL, k)


@pytest.mark.parametrize("method,sof", [("maccormackOurs", False),
                                        ("eulerOurs", False),
                                        ("euler", True)])
def test_advect_vel_scalar_fast_matches_jax(case, method, sof):
    """The whole fused advection (sweeps + final clamp), with obstacles."""
    s0, u0 = j_advect(DT, jnp.asarray(case["s"]), jnp.asarray(case["u"]),
                      jnp.asarray(case["flags"]), method, sof, STRENGTH, W,
                      fused_epilogue=True)
    s1, u1 = advect_vel_scalar_fast(DT, tt(case["s"]), tt(case["u"]),
                                    tt(case["flags"]), method, sof,
                                    STRENGTH, W)
    assert_close(s1, s0, RTOL, ATOL, "density")
    assert_close(u1, u0, RTOL, ATOL, "velocity")


def test_advect_unported_paths_raise(case):
    """Manta's maccormack has no combined form (JAX asserts); window 0 and
    2-D are not this function's. (rk2Ours, once unported, runs the unfused
    composition: test_torch_advect3d_grad.py holds it against JAX.)"""
    s, u, flags = tt(case["s"]), tt(case["u"]), tt(case["flags"])
    with pytest.raises(ValueError):
        advect_vel_scalar_fast(DT, s, u, flags, "maccormack", False, 0.6, W)
    with pytest.raises(NotImplementedError):
        advect_vel_scalar_fast(DT, s, u, flags, "eulerOurs", False, 0.6, 0)
    u2 = torch.zeros((1, 2, 1, 8, 16))
    with pytest.raises(NotImplementedError):
        advect_vel_scalar_fast(DT, torch.zeros((1, 1, 1, 8, 16)), u2,
                               torch.ones((1, 1, 1, 8, 16), dtype=torch.int32),
                               "eulerOurs", False, 0.6, W)
