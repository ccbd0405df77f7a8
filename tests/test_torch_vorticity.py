"""Vorticity confinement alone (K4's plain version) of the PyTorch port,
and its gradient, against the JAX package.

On the CPU the port's ops.forces.vorticity_confinement runs K4's plain
version (vorticity_confinement_xla); the JAX one, 3-D with a scalar
strength, runs the Pallas kernel _vc_kernel in interpret mode, whose VJP
replays vorticity_confinement_xla (forces_kernel.py:670-676). Two cases on
one (2, 3, 6, 8, 10) grid with 15% obstacles, Stick and Empty cells: dense
random flow, and a sparse one (a few nonzero faces), where most cells'
|curl| and |grad |curl|| sit below the vec3 epsilon and the guarded square
roots decide the values and keep the gradient finite. Tolerance: rtol
1e-5, atol 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidnet_tpu.ops.forces import vorticity_confinement as j_vc

from fluidnet_tpu_torch.ops.forces import vorticity_confinement

from tests.torch_port_util import assert_close, random_flags, tt

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (2, 1, 6, 8, 10)
AMP = 0.7


def _case(kind):
    rng = np.random.default_rng(71)
    flags = random_flags(rng, SHAPE, stick_empty=True)
    u = rng.standard_normal((2, 3) + SHAPE[2:]).astype(np.float32)
    if kind == "sparse":
        u = np.where(rng.random(u.shape) < 0.03, u, 0.0).astype(np.float32)
    cot = rng.standard_normal(u.shape).astype(np.float32)
    return flags, u, cot


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_vorticity_confinement_matches_pallas_and_vjp(kind):
    flags, u, cot = _case(kind)
    jflags = jnp.asarray(flags)
    ref, vjp = jax.vjp(lambda x: j_vc(x, jflags, AMP), jnp.asarray(u))
    (gref,) = vjp(jnp.asarray(cot))

    tu = tt(u).requires_grad_()
    out = vorticity_confinement(tu, tt(flags), AMP)
    assert_close(out, ref, RTOL, ATOL, "u'")
    (out * tt(cot)).sum().backward()
    assert np.isfinite(tu.grad.numpy()).all()
    assert_close(tu.grad, gref, RTOL, ATOL, "grad u")
