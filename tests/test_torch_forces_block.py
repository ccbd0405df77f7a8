"""K2's forces-block form (epi=False) of the PyTorch port against the JAX
package.

On the CPU the port's `forces_block` runs K2's plain version
(`forces_block_xla`); it is held against the JAX Pallas
`forces_block_pallas` (interpret mode, the epi=False `_fb_kernel`) and
against the JAX `forces_block_xla`, with and without Stick and Empty
cells, at tests/test_prologue.py's tolerances: rtol 1e-5, atol 1e-6.
Per-sample force scales ((B, 3) gravity vectors, a (B,) amp) take the
plain composition on both sides and are held against JAX's
`forces_block_xla`. One grid, (b, c, 10, 16, 24).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fluidnet_tpu.ops.forces import forces_block as j_forces_block
from fluidnet_tpu.ops.forces import forces_block_xla as j_forces_block_xla
from fluidnet_tpu.ops.pallas.forces_kernel import forces_block_pallas

from fluidnet_tpu_torch.ops.cuda import _build
from fluidnet_tpu_torch.ops.forces import forces_block

from tests.torch_port_util import assert_close, random_flags, tt

RTOL, ATOL = 1e-5, 1e-6
Z, Y, X = 10, 16, 24
BUOY_G = np.asarray([0.0, -0.17, 0.02], np.float32)
GRAV_G = np.asarray([0.01, -0.05, 0.0], np.float32)
AMP, DT = 0.6, 0.25


def _case(b, with_stick):
    rng = np.random.default_rng(41 + b)
    flags = random_flags(rng, (b, 1, Z, Y, X), stick_empty=with_stick)
    u = rng.standard_normal((b, 3, Z, Y, X)).astype(np.float32)
    rho = rng.random((b, 1, Z, Y, X)).astype(np.float32)
    return flags, u, rho


@pytest.mark.parametrize("with_stick", [False, True])
def test_forces_block_matches_pallas_and_xla(with_stick):
    flags, u, rho = _case(1, with_stick)
    launches = sum(_build.launches.values())
    out = forces_block(tt(u), tt(flags), tt(rho), BUOY_G, GRAV_G, AMP, DT)
    assert sum(_build.launches.values()) == launches  # CPU: plain version
    assert out.shape == u.shape
    jargs = [jnp.asarray(a) for a in (u, flags, rho, BUOY_G, GRAV_G)] + [
        jnp.asarray(AMP, jnp.float32), DT]
    assert_close(out, forces_block_pallas(*jargs), RTOL, ATOL,
                 "vs forces_block_pallas")
    assert_close(out, j_forces_block_xla(*jargs), RTOL, ATOL,
                 "vs forces_block_xla")


def test_forces_block_per_sample_scales():
    """(B, 3) buoyancy/gravity vectors and a (B,) amp: the plain
    composition, per sample; a (3,) vector with a (B,) amp counts as
    per-sample too."""
    flags, u, rho = _case(2, True)
    buoy = np.stack([BUOY_G, BUOY_G * 0.5])
    grav = np.stack([GRAV_G, -GRAV_G])
    amp = np.asarray([AMP, 0.25], np.float32)
    for b_g, g_g in ((buoy, grav), (BUOY_G, GRAV_G)):
        out = forces_block(tt(u), tt(flags), tt(rho), b_g, g_g, amp, DT)
        jargs = [jnp.asarray(a) for a in (u, flags, rho, b_g, g_g, amp)]
        assert_close(out, j_forces_block_xla(*jargs, DT), RTOL, ATOL,
                     "per-sample scales vs forces_block_xla")
        assert_close(out, j_forces_block(*jargs, DT), RTOL, ATOL,
                     "per-sample scales vs forces_block")
