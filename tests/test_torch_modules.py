"""The port's auxiliary modules (fluidnet_tpu_torch.models.modules) and
ops.sdf.rectangular_blur against the JAX package, in the cases of
tests/test_modules_extras.py: the same numpy inputs through both, outputs
within rtol 1e-6 (atol 1e-6 where a sum of terms can land near zero: the
blurs, which take differences of cumulative sums, and the residual
block's float32 convolutions, summed in another order by XLA:CPU and
PyTorch's CPU conv). Gradients of the scale-invariant loss are held to
JAX's at the same tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.models import modules as JM
from fluidnet_tpu.models.fluidnet import _conv as j_conv
from fluidnet_tpu.models.fluidnet import _init_conv
from fluidnet_tpu.ops.sdf import rectangular_blur as j_blur

from fluidnet_tpu_torch.models import modules as M
from fluidnet_tpu_torch.models.fluidnet import _conv
from fluidnet_tpu_torch.ops.sdf import rectangular_blur

from tests.torch_port_util import assert_close, np_, random_flags, tt

RTOL = 1e-6


def _linear_field():
    zz, yy, xx = np.meshgrid(np.arange(4), np.arange(8), np.arange(8),
                             indexing="ij")
    f = (2.0 * xx + 3.0 * yy - zz).astype(np.float32)[None, None]
    u = np.stack([2.0 * xx, 3.0 * yy, -zz]).astype(np.float32)[None]
    return f, u


@pytest.mark.parametrize("steps", [None, (0.5, 2.0, 4.0)])
def test_finite_elements_and_divergence(steps):
    f, u = _linear_field()
    rng = np.random.default_rng(0)
    g = rng.standard_normal((2, 2, 4, 6, 7)).astype(np.float32)
    for a in (f, g, g[:, :, :1]):
        assert_close(M.finite_elements(tt(a), steps),
                     JM.finite_elements(jnp.asarray(a), steps), RTOL, 0)
    for a in (u, g[:, :, :1], rng.standard_normal((2, 3, 4, 6, 7))
              .astype(np.float32)):
        assert_close(M.central_divergence(tt(a), steps),
                     JM.central_divergence(jnp.asarray(a), steps), RTOL, 0)
    np.testing.assert_allclose(np_(M.central_divergence(tt(u))), 4.0,
                               atol=1e-5)


def test_mse_si_and_lerp_losses():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 1, 1, 8, 8)).astype(np.float32)
    for lam in (0.5, 1.0):
        assert_close(M.mse_si_loss(tt(a + 1.0), tt(a), lam),
                     JM.mse_si_loss(jnp.asarray(a + 1.0), jnp.asarray(a),
                                    lam), RTOL, 1e-7)
    assert float(M.lerp_loss(2.0, 4.0, 0.25)) == 2.5
    x = tt(a + 0.1).requires_grad_()
    (gx,) = torch.autograd.grad(M.mse_si_loss(x, tt(a)), [x])
    jg = jax.grad(lambda v: JM.mse_si_loss(v, jnp.asarray(a)))(
        jnp.asarray(a + 0.1))
    assert_close(gx, jg, RTOL, 1e-9)


def test_apply_scale_and_std():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 1, 4, 4)).astype(np.float32)
    s = np.asarray([1.0, 2.0, 4.0], np.float32)
    for invert in (True, False):
        assert_close(M.apply_scale(tt(x), tt(s), invert),
                     JM.apply_scale(jnp.asarray(x), jnp.asarray(s), invert),
                     RTOL, 0)
    assert_close(M.standard_deviation(tt(x)),
                 JM.standard_deviation(jnp.asarray(x)), RTOL, 0)


@pytest.mark.parametrize("z", [1, 2])
def test_upsample_and_normalizations(z):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 2, z, 4, 4)).astype(np.float32)
    up = M.upsample_nearest(tt(x), 2)
    assert tuple(up.shape) == (1, 2, 2 * z if z > 1 else 1, 8, 8)
    assert_close(up, JM.upsample_nearest(jnp.asarray(x), 2), 0, 0)
    for r in (1, 2):
        assert_close(M.normalize_subtractive(tt(x), r),
                     JM.normalize_subtractive(jnp.asarray(x), r), RTOL,
                     1e-6)
        assert_close(M.normalize_divisive(tt(x), r),
                     JM.normalize_divisive(jnp.asarray(x), r), RTOL, 1e-6)


@pytest.mark.parametrize("is_3d", [False, True])
@pytest.mark.parametrize("rad", [1, 2])
def test_rectangular_blur(is_3d, rad):
    rng = np.random.default_rng(3 + rad)
    shape = (2, 3, 5 if is_3d else 1, 6, 9)
    x = rng.standard_normal(shape).astype(np.float32)
    out = rectangular_blur(tt(x), rad, is_3d)
    assert_close(out, j_blur(jnp.asarray(x), rad, is_3d), RTOL, 1e-6)
    # A constant field blurs to itself; the edges replicate.
    c = rectangular_blur(torch.full(shape, 3.0), rad, is_3d)
    np.testing.assert_allclose(np_(c), 3.0, rtol=1e-6)


def test_residual_block():
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    jp = {"conv1": _init_conv(k1, 4, 4, 3, 2),
          "conv2": _init_conv(k2, 4, 4, 3, 2)}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    for params in (jp, dict(jp, proj=_init_conv(k3, 4, 4, 1, 2))):
        y = JM.residual_block(params, jnp.asarray(x), lambda p, a: j_conv(
            a, p, 2, compute_dtype=jnp.float32))
        tp = jax.tree_util.tree_map(tt, params)
        out = M.residual_block(tp, tt(x), lambda p, a: _conv(
            a, p["w"], p["b"], 2, compute_dtype=torch.float32))
        assert out.shape == x.shape
        assert_close(out, y, RTOL, 1e-6)


def test_select_fluid_input_and_inject_tensor():
    rng = np.random.default_rng(5)
    shape = (2, 1, 1, 6, 7)
    flags = random_flags(rng, shape, p_obstacle=0.2, stick_empty=True)
    x = rng.standard_normal((2, 2) + shape[2:]).astype(np.float32)
    assert_close(M.select_fluid_input(tt(x), tt(flags)),
                 JM.select_fluid_input(jnp.asarray(x), jnp.asarray(flags)),
                 0, 0)
    inj = rng.standard_normal(x.shape).astype(np.float32)
    mask = (rng.random(x.shape) < 0.5).astype(np.float32)
    assert_close(M.inject_tensor(tt(x), tt(inj), tt(mask)),
                 JM.inject_tensor(jnp.asarray(x), jnp.asarray(inj),
                                  jnp.asarray(mask)), RTOL, 0)
