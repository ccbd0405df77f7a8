"""The PyTorch port's 2-D ConvNet (the generic stage path) against JAX
`apply_model`, on the same params and inputs, (2, 1, 1, 16, 20) grids.

Tolerances:
  - float32 convs: rtol 1e-4, atol 1e-5 (five convolutions summed in
    another order by XLA:CPU and PyTorch's CPU conv);
  - bfloat16 convs: atol 6e-2 * max|p|, |U| of the JAX result, as
    tests/test_torch_model.py holds the 3-D trunk. Both sides round each
    conv's result to bf16 and add the bias in float32, but their
    accumulation orders differ, so a hidden activation may land one bf16
    ulp (2^-8 relative) apart, and the head's weighted sum cancels much of
    the magnitude;
  - the bundled data/models_bundled/m2d checkpoint (bf16, as trained) at the
    same bf16 tolerance, read by the port's own reader.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.core.config import InputChannels as JInputChannels
from fluidnet_tpu.core.config import ModelConfig as JModelConfig
from fluidnet_tpu.models.fluidnet import apply_model, init_model

from fluidnet_tpu_torch.core.config import InputChannels, ModelConfig
from fluidnet_tpu_torch.models.fluidnet import FluidNet, from_jax_params
from fluidnet_tpu_torch.utils.checkpoint import load_mconf, load_params

from tests.torch_port_util import DEV, assert_close, np_, random_flags, tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M2D = os.path.join(REPO, "data", "models_bundled", "m2d")
SHAPE = (2, 1, 1, 16, 20)


def _mconfs(model_type, dtype):
    kw = dict(is_3d=False, model_type=model_type, conv_compute_dtype=dtype)
    if model_type == "yang":
        return (JModelConfig(nonlin_type="sigmoid",
                             input_channels=JInputChannels(u_div=False), **kw),
                ModelConfig(nonlin_type="sigmoid",
                            input_channels=InputChannels(u_div=False), **kw))
    return JModelConfig(**kw), ModelConfig(**kw)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    flags = random_flags(rng, SHAPE, p_obstacle=0.1, stick_empty=True)
    p = rng.standard_normal(SHAPE).astype(np.float32)
    u = rng.standard_normal((2, 2) + SHAPE[2:]).astype(np.float32)
    return p, u, flags


def _assert_close(tp, tu, jp, ju, dtype):
    if dtype == "float32":
        assert_close(tp, jp, 1e-4, 1e-5, "p")
        assert_close(tu, ju, 1e-4, 1e-5, "U")
    else:
        for a, b, name in ((tp, jp, "p"), (tu, ju, "U")):
            b = np_(b)
            assert_close(a, b, 0, 6e-2 * np.abs(b).max(), name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_type", ["default", "yang"])
def test_fluidnet_2d_matches_apply_model(dtype, model_type):
    jm, tm = _mconfs(model_type, dtype)
    params = init_model(jax.random.PRNGKey(3), jm)
    p, u, flags = _inputs(70)
    jp, ju = apply_model(params, jm, jnp.asarray(p), jnp.asarray(u),
                         jnp.asarray(flags))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tm,
                            device=DEV)
    assert isinstance(model.final, torch.nn.Conv2d)
    with torch.no_grad():
        tp, tu = model(tt(p), tt(u), tt(flags))
    assert tp.shape == p.shape and tu.shape == u.shape
    _assert_close(tp, tu, jp, ju, dtype)


def test_m2d_checkpoint_matches_apply_model():
    """The bundled 2-D model, as the server loads it."""
    from fluidnet_tpu.train.train import init_train_state
    from fluidnet_tpu.utils.checkpoint import load_checkpoint
    tm = load_mconf(M2D)
    assert not tm.is_3d and tm.conv_compute_dtype == "bfloat16"
    jm = JModelConfig(**{k: getattr(tm, k) for k in (
        "is_3d", "model_type", "conv_compute_dtype", "nonlin_type")},
        input_channels=JInputChannels(**vars(tm.input_channels)))
    state, jm, _ = load_checkpoint(M2D, init_train_state(
        jax.random.PRNGKey(0), jm))
    ours = load_params(M2D)
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    p, u, flags = _inputs(71)
    jp, ju = apply_model(state.params, jm, jnp.asarray(p), jnp.asarray(u),
                         jnp.asarray(flags))
    model = FluidNet(tm, device=DEV).load_jax_params(ours)
    with torch.no_grad():
        tp, tu = model(tt(p), tt(u), tt(flags))
    _assert_close(tp, tu, jp, ju, "bfloat16")
