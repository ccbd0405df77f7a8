"""The PyTorch port's ConvNet and checkpoint reader against the JAX package.

`FluidNet.load_jax_params` + `FluidNet.forward` are held against JAX
`apply_model` on the same params and inputs, with and without the
prologue's precomputed divergence, for the fast-trunk models (3-D default
and yang). Tolerances:
  - float32 trunk: rtol 1e-4, atol 1e-5 (five convolutions summed in
    another order by XLA:CPU and PyTorch's CPU conv);
  - bfloat16 trunk: atol 6e-2 * max|p|, |U| of the JAX result. Both trunks
    keep activations and bias adds in bf16 between layers, but the JAX
    z-fold sums the three kz partial convs in bf16 (two extra roundings
    per layer) where conv3d rounds once, so hidden activations may differ
    by a bf16 ulp or two (2^-8 relative). The head's weighted sum then
    cancels most of their magnitude (yang's sigmoid activations sit near
    0.5 while p is ~0.06), which leaves up to ~4% of max|p| (measured).
The msgpack reader must give exactly flax's arrays.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from fluidnet_tpu.core.config import InputChannels as JInputChannels
from fluidnet_tpu.core.config import ModelConfig as JModelConfig
from fluidnet_tpu.models.fluidnet import apply_model, init_model
from fluidnet_tpu.ops.boundary import set_wall_bcs as j_set_wall_bcs
from fluidnet_tpu.ops.divergence import \
    velocity_divergence as j_velocity_divergence

from fluidnet_tpu_torch.core.config import InputChannels, ModelConfig
from fluidnet_tpu_torch.models.fluidnet import FluidNet, from_jax_params
from fluidnet_tpu_torch.utils.checkpoint import (load_mconf, load_params,
                                                 load_state)

from tests.torch_port_util import (DEV, assert_close, np_, random_flags,
                                   tt)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLED = os.path.join(REPO, "data", "models_bundled")
SHAPE = (2, 1, 8, 10, 12)


def _mconfs(model_type, dtype):
    kw = dict(is_3d=True, model_type=model_type, conv_compute_dtype=dtype)
    if model_type == "yang":
        return (JModelConfig(nonlin_type="sigmoid",
                             input_channels=JInputChannels(u_div=False), **kw),
                ModelConfig(nonlin_type="sigmoid",
                            input_channels=InputChannels(u_div=False), **kw))
    return JModelConfig(**kw), ModelConfig(**kw)


def _inputs(seed=40):
    rng = np.random.default_rng(seed)
    flags = random_flags(rng, SHAPE, p_obstacle=0.1, stick_empty=True)
    p = rng.standard_normal(SHAPE).astype(np.float32)
    u = rng.standard_normal((2, 3) + SHAPE[2:]).astype(np.float32)
    return p, u, flags


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trunk_close(tp, tu, jp, ju, dtype):
    if dtype == "float32":
        assert_close(tp, jp, 1e-4, 1e-5, "p")
        assert_close(tu, ju, 1e-4, 1e-5, "U")
    else:
        for a, b, name in ((tp, jp, "p"), (tu, ju, "U")):
            b = np.asarray(b)
            assert_close(a, b, 0, 6e-2 * np.abs(b).max(), name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_type", ["default", "yang"])
@pytest.mark.parametrize("precomputed", [False, True])
def test_fluidnet_matches_apply_model(dtype, model_type, precomputed):
    jm, tm = _mconfs(model_type, dtype)
    params = init_model(jax.random.PRNGKey(1), jm)
    p, u, flags = _inputs()
    jf = jnp.asarray(flags)
    ju = jnp.asarray(u)
    div = None
    if precomputed:
        # What the projection prologue hands the model: wall-BC'ed u and
        # its divergence.
        ju = j_set_wall_bcs(ju, jf)
        div = j_velocity_divergence(ju, jf)
    jp_out, ju_out = apply_model(params, jm, jnp.asarray(p), ju, jf,
                                 precomputed_div=div)
    model = from_jax_params(_tree_np(params), tm, device=DEV)
    with torch.no_grad():
        tp_out, tu_out = model(tt(p), tt(ju), tt(flags),
                               precomputed_div=None if div is None
                               else tt(div))
    assert tp_out.dtype == torch.float32 and tp_out.shape == p.shape
    _assert_trunk_close(tp_out, tu_out, jp_out, ju_out, dtype)


@pytest.mark.parametrize("name", ["m3d_v5_bestRollout", "m3d_v5_lastEpoch",
                                  "m3d", "m2d"])
def test_msgpack_reader_matches_flax(name):
    path = os.path.join(BUNDLED, name, "state.msgpack")
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    ours = load_state(os.path.dirname(path))

    def same(a, b, where):
        assert type(a) is type(b) or (isinstance(a, np.ndarray) and
                                      isinstance(b, np.ndarray)), where
        if isinstance(a, dict):
            assert list(a) == list(b), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}/{i}")
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, where
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            assert a == b, where
    same(ours, ref, name)


def test_bundled_checkpoint_matches_jax_loader():
    """load_params gives the JAX loader's params (lists restored), and the
    bench model computes the same projection from them (bf16 trunk, as
    the checkpoint was trained)."""
    from fluidnet_tpu.train.train import init_train_state
    from fluidnet_tpu.utils.checkpoint import load_checkpoint
    path = os.path.join(BUNDLED, "m3d_v5_bestRollout")
    tm = load_mconf(path)
    ours = load_params(path)
    jm = JModelConfig(**{k: getattr(tm, k) for k in ("is_3d", "model_type",
                                                      "conv_compute_dtype",
                                                      "nonlin_type")})
    state, jm, _ = load_checkpoint(path, init_train_state(
        jax.random.PRNGKey(0), jm))
    ref = _tree_np(state.params)
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)

    p, u, flags = _inputs(41)
    jp_out, ju_out = apply_model(state.params, jm, jnp.asarray(p),
                                 jnp.asarray(u), jnp.asarray(flags))
    model = FluidNet(tm, device=DEV).load_jax_params(ours)
    with torch.no_grad():
        tp_out, tu_out = model(tt(p), tt(u), tt(flags))
    _assert_trunk_close(tp_out, tu_out, np_(jp_out), np_(ju_out),
                        tm.conv_compute_dtype)
