"""The training slice of the PyTorch port against the JAX package: the loss
(sdf, fluid_loss, loss_fn), every parameter's gradient through the
'full'-mode unroll, three optimizer steps, the reject guard, 'last' mode.

m3d_v5's training mconf (scripts/train3d_v5.sh: maccormackOurs, W = 1,
MacCormack strength 0.75, border weights 4 over width 3, randomized
buoyancy / vorticity / dt, 'full' gradients, Adam at lr 5e-4 with eps
1e-4) on a batch of 2 random 3-D scenes of 8 x 10 x 12 cells (15%
obstacles, a still box where the MacCormack clamp's bounds tie), with
n_future = 2. dt and the forces are drawn by JAX (a key whose draws turn
buoyancy and vorticity on) and passed to both sides. The JAX side runs as
its suite does (tests/conftest.py: the unfused sweeps and prologue,
interpret-mode Pallas); its value_and_grad is jitted once per dtype and
reused for the optimizer steps. Tolerances are stated per test.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.core.config import ModelConfig as JModelConfig
from fluidnet_tpu.ops.sdf import signed_distance_field as j_sdf
from fluidnet_tpu.train import train as jtrain
from fluidnet_tpu.train.loss import fluid_loss as j_fluid_loss
from fluidnet_tpu.models.fluidnet import init_model

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.models.fluidnet import from_jax_params
from fluidnet_tpu_torch.ops.sdf import signed_distance_field
from fluidnet_tpu_torch.train.loss import fluid_loss
from fluidnet_tpu_torch.train.train import (Draws, Optimizer,
                                            init_train_state, loss_fn,
                                            sample_future_steps, train_step)

from tests.torch_port_util import DEV, assert_close, np_, random_flags, tt

SHAPE = (2, 1, 8, 10, 12)
N_FUTURE = 2
M3D_V5 = dict(is_3d=True, advection_method="maccormackOurs",
              adaptive_window=False, advection_window=1,
              maccormack_strength=0.75, train_buoyancy_prob=0.5,
              train_buoyancy_scale=2.0,
              train_vorticity_confinement_prob=0.3,
              train_vorticity_confinement_amp=3.0, long_term_div_lambda=1.0,
              long_term_grad_mode="full", loss_div_lambda=1.0,
              loss_reject_threshold=0.1)
TERMS = ("total", "p", "u", "div", "long_term_div")


def _optim(m, lr=5e-4):
    return m.replace(optim=m.optim.__class__(learning_rate=lr))


def _mconfs(dtype, **kw):
    j = JModelConfig(**M3D_V5, conv_compute_dtype=dtype).replace(**kw)
    t = ModelConfig(**M3D_V5, conv_compute_dtype=dtype).replace(**kw)
    return _optim(j), _optim(t)


def _key_with_forces(jm):
    """A key whose force draws turn buoyancy and vorticity on."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        _, kforce = jax.random.split(key)
        _, b, _, v = jtrain._random_forces(kforce, jm)
        if float(b) > 0 and float(v) > 0:
            return key
    raise AssertionError("no key turns both forces on")


def _draws(key, jm):
    kdt, kforce = jax.random.split(key)
    dt = jtrain._random_dt(kdt, jm)
    g, b, gs, v = jtrain._random_forces(kforce, jm)
    return Draws(*(torch.tensor(np.asarray(a, np.float32))
                   for a in (dt, g, b, gs, v)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(81)
    flags = random_flags(rng, SHAPE, p_obstacle=0.15)
    u = (rng.standard_normal((2, 3) + SHAPE[2:]) * 0.5).astype(np.float32)
    u[:, :, 1:4, 1:5, 1:6] = 0.0         # still: clamp ties
    density = rng.random(SHAPE).astype(np.float32)
    density[:, :, 1:4, 1:5, 1:6] = 0.5
    return {"flags": flags, "u_div": u,
            "p_div": (rng.standard_normal(SHAPE) * 0.1).astype(np.float32),
            "density": density}


def _tbatch(batch):
    return {k: tt(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup(batch):
    """Per dtype: the JAX mconf, the port's, the params, the key, the
    port's draws and the jitted JAX value_and_grad (compiled once)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jm, tm = _mconfs(dtype)
        key = _key_with_forces(jm)
        vg = jax.jit(jax.value_and_grad(jtrain.loss_fn, has_aux=True),
                     static_argnames=("mconf", "n_future"))
        out[dtype] = {"jm": jm, "tm": tm, "key": key, "vg": vg,
                      "params": init_model(jax.random.PRNGKey(3), jm),
                      "draws": _draws(key, jm)}
    return out


def _named(tree, name):
    for k in name.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _largest(tree):
    return max(float(np.abs(np_(x)).max())
               for x in jax.tree_util.tree_leaves(tree))


def _grads(model, batch, tm, draws, n_future):
    params = [t for _, t in model.jax_named_parameters()]
    total, terms = loss_fn(model, _tbatch(batch), None, tm, n_future,
                           draws=draws)
    grads = torch.autograd.grad(total, params)
    return terms, dict(zip([k for k, _ in model.jax_named_parameters()],
                           grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_terms_and_grads_match_jax(batch, setup, dtype):
    """Every loss term and every parameter's gradient. float32 convs:
    terms rtol 1e-5; gradients rtol 1e-4, atol 1e-4 of the parameter's
    largest. bfloat16 convs (the recipe's): terms rtol 1e-3 against JAX's
    bf16 terms; each parameter's gradient within 6e-2 relative L2 of JAX's
    float32 gradient. Not of JAX's bf16 one: JAX reduces the bias
    cotangents in bf16, and on the final bias (a sum that mostly cancels)
    its bf16 gradient sits 0.35 away from its own float32 one."""
    s = setup[dtype]
    (_, jterms), _ = s["vg"](s["params"], _jbatch(batch), s["key"],
                             s["jm"], N_FUTURE)
    s32 = setup["float32"]
    _, jgrads = s32["vg"](s32["params"], _jbatch(batch), s32["key"],
                          s32["jm"], N_FUTURE)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                   s["params"]), s["tm"],
                            device=DEV)
    terms, grads = _grads(model, batch, s["tm"], s["draws"], N_FUTURE)
    bf16 = dtype == "bfloat16"
    scale = _largest(jgrads)
    for k in TERMS:
        assert_close(terms[k].detach(), jterms[k], 1e-3 if bf16 else 1e-5,
                     1e-7, k)
    assert float(terms["long_term_div"].detach()) > 0
    for name, g in grads.items():
        ref = np_(_named(jgrads, name))
        if bf16:
            rel = np.linalg.norm(np_(g) - ref) / np.linalg.norm(ref)
            assert rel <= 6e-2, f"{name}: relative L2 {rel}"
        else:
            assert_close(g, ref, 1e-4, 1e-4 * scale, name)


def test_three_adam_steps_with_binding_clip(batch, setup):
    """Three train_steps (clip at 1e-3, so it binds every step) against the
    JAX step's ops: value_and_grad, make_optimizer's chain, apply_updates,
    the reject guard (off here). Params and Adam's moments: rtol 1e-4,
    atol 1e-7."""
    s = setup["float32"]
    jm = s["jm"].replace(grad_norm_threshold=1e-3, loss_reject_threshold=0.0)
    tm = s["tm"].replace(grad_norm_threshold=1e-3, loss_reject_threshold=0.0)
    params = s["params"]
    opt = jtrain.make_optimizer(jm)
    opt_state = opt.init(params)
    state = init_train_state(0, tm, DEV, model=from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tm, device=DEV))
    for i in range(3):
        (_, jterms), grads = s["vg"](params, _jbatch(batch), s["key"], jm,
                                     N_FUTURE)
        gn = float(jtrain.optax.global_norm(grads))
        assert gn > 1e-3
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jtrain.optax.apply_updates(params, updates)
        state, terms = train_step(state, _tbatch(batch), None, tm, N_FUTURE,
                                  draws=s["draws"])
        assert_close(terms["grad_norm"], gn, 1e-4, 0, f"step {i} norm")
        assert float(terms["rejected"]) == 0.0
        for name, p in state.model.jax_named_parameters():
            assert_close(p.detach(), _named(params, name), 1e-4, 1e-7,
                         f"step {i}: {name}")
    assert state.step == 3
    inner = opt_state[1].inner_state[0]
    names = [k for k, _ in state.model.jax_named_parameters()]
    assert int(state.opt_state["count"]) == int(inner.count) == 3
    for key in ("mu", "nu"):
        for name, t in zip(names, state.opt_state[key]):
            ref = np_(_named(getattr(inner, key), name))
            assert_close(t, ref, 1e-4, 1e-4 * np.abs(ref).max(),
                         f"{key} {name}")


def test_reject_guard_keeps_params_and_state(batch, setup):
    """A loss above loss_reject_threshold: params and optimizer state stay,
    the step advances, 'rejected' is 1 (train.py:279-311)."""
    s = setup["float32"]
    tm = s["tm"].replace(loss_reject_threshold=1e-12)
    state = init_train_state(0, tm, DEV, model=from_jax_params(
        jax.tree_util.tree_map(np.asarray, s["params"]), tm, device=DEV))
    before = [p.detach().clone() for p in state.params]
    opt_before = {k: v.clone() for k, v in state.opt_state.items()
                  if not isinstance(v, list)}
    state, terms = train_step(state, _tbatch(batch), None, tm, N_FUTURE,
                              draws=s["draws"])
    assert float(terms["rejected"]) == 1.0 and state.step == 1
    for a, b in zip(before, state.params):
        assert torch.equal(a, b)
    assert int(state.opt_state["count"]) == int(opt_before["count"]) == 0
    assert all(not m.abs().max() > 0 for m in state.opt_state["mu"])


def test_last_mode_matches_jax(batch, setup):
    """'last' mode at n_future = 1: the unroll without gradients, the
    gradient through the final model only. float32: terms rtol 1e-5,
    gradients rtol 1e-4, atol 1e-4 of the largest."""
    s = setup["float32"]
    jm = s["jm"].replace(long_term_grad_mode="last")
    tm = s["tm"].replace(long_term_grad_mode="last")
    (_, jterms), jgrads = jax.jit(
        jax.value_and_grad(jtrain.loss_fn, has_aux=True),
        static_argnames=("mconf", "n_future"))(
        s["params"], _jbatch(batch), s["key"], jm, 1)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, s["params"]),
                            tm, device=DEV)
    terms, grads = _grads(model, batch, tm, s["draws"], 1)
    for k in TERMS:
        assert_close(terms[k].detach(), jterms[k], 1e-5, 1e-7, k)
    scale = _largest(jgrads)
    for name, g in grads.items():
        assert_close(g, _named(jgrads, name), 1e-4, 1e-4 * scale, name)


def test_sample_future_steps_and_weight_decay_fault():
    """The horizon draws follow random.Random as JAX's do; a nonzero weight
    decay is refused (fault F10: the JAX chain would add +wd * p with no
    learning rate)."""
    jm, tm = JModelConfig(), ModelConfig()
    ra, rb = random.Random(5), random.Random(5)
    assert [jtrain.sample_future_steps(ra, jm) for _ in range(50)] == \
        [sample_future_steps(rb, tm) for _ in range(50)]
    with pytest.raises(ValueError, match="F10"):
        Optimizer(tm.replace(optim=tm.optim.__class__(weight_decay=1e-4)))


def test_sdf_and_fluid_loss_match_jax(batch):
    """signed_distance_field and fluid_loss (every lambda on, border
    weights) alone: rtol 1e-5 (mean reductions in other orders), atol
    1e-7."""
    flags = batch["flags"]
    assert_close(signed_distance_field(tt(flags), 3),
                 j_sdf(jnp.asarray(flags), 3), 1e-6, 1e-7, "sdf")
    rng = np.random.default_rng(9)
    fields = [rng.standard_normal(s).astype(np.float32) for s in
              (SHAPE, (2, 3) + SHAPE[2:], SHAPE, (2, 3) + SHAPE[2:])]
    kw = dict(loss_p_lambda=0.5, loss_u_lambda=0.25)
    total, terms = fluid_loss(ModelConfig(is_3d=True, **kw),
                              *map(tt, fields), tt(flags))
    jtotal, jterms = j_fluid_loss(JModelConfig(is_3d=True, **kw),
                                  *map(jnp.asarray, fields),
                                  jnp.asarray(flags))
    assert_close(total, jtotal, 1e-5, 1e-7, "total")
    for k in ("p", "u", "div"):
        assert_close(terms[k], jterms[k], 1e-5, 1e-7, k)
