"""The 3-D advection of the PyTorch port, values and gradients, against the
JAX package: advect_vel_scalar_fast with the fused epilogue (K1 fused
forward; the gradient replays the unfused composition, as JAX's
_fused_step custom VJP) and without it (K1's unfused sweeps, whose
gradient is K6; rk2Ours, which has no fused form, runs them too), and
advect_vel_fast's 3-D branch (mac_vel_sweep).

One (1, c, 6, 8, 16) grid with 15% obstacles and flow of ~1 cell a step
(the displacement clip and the free-space scale bind), with a still box
(u = 0, constant density) where the MacCormack clamp's bounds tie with the
corrected value: there jnp.clip's gradient splits between the tied
arguments, which torch.clamp's would not. Random cotangents on both
outputs. Tolerance: rtol 1e-5, atol 1e-5 (values), 2e-5 (gradients,
summed over the clamp's and the sweeps' orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.ops.advect_fast import advect_vel_fast as j_advect_vel
from fluidnet_tpu.ops.advect_fast import \
    advect_vel_scalar_fast as j_advect

from fluidnet_tpu_torch.ops.advect_fast import (advect_vel_fast,
                                                advect_vel_scalar_fast)

from tests.torch_port_util import assert_close, random_flags, tt

RTOL, ATOL, GATOL = 1e-5, 1e-5, 2e-5
DT, STRENGTH, W = 0.3, 0.75, 1
SHAPE = (1, 1, 6, 8, 16)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(61)
    flags = random_flags(rng, SHAPE, p_obstacle=0.15)
    u = (rng.standard_normal((1, 3) + SHAPE[2:]) * 3.0).astype(np.float32)
    s = rng.random(SHAPE).astype(np.float32)
    u[:, :, :, :4, :6] = 0.0          # a still box: clamp ties
    s[:, :, :, :4, :6] = 0.5
    return {"flags": flags, "u": u, "s": s,
            "cot_s": rng.standard_normal(SHAPE).astype(np.float32),
            "cot_u": rng.standard_normal(u.shape).astype(np.float32)}


@pytest.mark.parametrize("method,fused", [("maccormackOurs", True),
                                          ("maccormackOurs", False),
                                          ("eulerOurs", True),
                                          ("rk2Ours", False)])
def test_advect_vel_scalar_fast_grad_matches_jax(case, method, fused):
    flags = jnp.asarray(case["flags"])
    (s0, u0), vjp = jax.vjp(
        lambda s, u: j_advect(DT, s, u, flags, method, False, STRENGTH, W,
                              fused_epilogue=fused),
        jnp.asarray(case["s"]), jnp.asarray(case["u"]))
    gs0, gu0 = vjp((jnp.asarray(case["cot_s"]), jnp.asarray(case["cot_u"])))

    s = tt(case["s"]).requires_grad_()
    u = tt(case["u"]).requires_grad_()
    s1, u1 = advect_vel_scalar_fast(DT, s, u, tt(case["flags"]), method,
                                    False, STRENGTH, W, fused_epilogue=fused)
    assert_close(s1, s0, RTOL, ATOL, "density")
    assert_close(u1, u0, RTOL, ATOL, "velocity")
    ((s1 * tt(case["cot_s"])).sum() +
     (u1 * tt(case["cot_u"])).sum()).backward()
    assert_close(s.grad, gs0, RTOL, GATOL, "grad density")
    assert_close(u.grad, gu0, RTOL, GATOL, "grad velocity")


@pytest.mark.parametrize("method", ["maccormackOurs", "maccormack"])
def test_advect_vel_fast_3d_grad_matches_jax(case, method):
    flags = jnp.asarray(case["flags"])
    u0, vjp = jax.vjp(lambda u: j_advect_vel(DT, u, flags, method, STRENGTH,
                                             W), jnp.asarray(case["u"]))
    (gu0,) = vjp(jnp.asarray(case["cot_u"]))
    u = tt(case["u"]).requires_grad_()
    u1 = advect_vel_fast(DT, u, tt(case["flags"]), method, STRENGTH, W)
    assert_close(u1, u0, RTOL, ATOL, "velocity")
    (u1 * tt(case["cot_u"])).sum().backward()
    assert_close(u.grad, gu0, RTOL, GATOL, "grad velocity")


def test_clamp_tie_gradient():
    """The MacCormack clamp's gradient at ties, as jnp.clip has it: x = lo
    = hi gives x 1/4, x = lo < hi 1/2 (torch.clamp would give 1)."""
    x = torch.zeros(3, requires_grad=True)
    lo = torch.tensor([0.0, 0.0, -1.0])
    hi = torch.tensor([0.0, 1.0, 1.0])
    torch.minimum(torch.maximum(x, lo), hi).sum().backward()
    jg = jax.grad(lambda a: jnp.clip(a, jnp.asarray(lo.numpy()),
                                     jnp.asarray(hi.numpy())).sum())(
        jnp.zeros(3))
    assert_close(x.grad, jg, 0, 0, "clip gradient at ties")
    assert x.grad.tolist() == [0.25, 0.5, 1.0]
