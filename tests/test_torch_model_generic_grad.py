"""The gradient of every parameter of the port's generic stage path
through train.loss_fn against JAX's, at n = 2: the 3-D tog model and the
3-D two-bank mres model with batch norm and the pressure skip, float32
convs, batch norm redrawn from the seed, on the (2, 1, 8, 12, 16) grids
of tests/test_torch_model_generic.py. m3d_v5's training mconf as
tests/test_torch_train.py (full gradients through the unroll, every force
on); dt and the forces are drawn by JAX and passed to both sides. The JAX
side runs as its suite does (tests/conftest.py: the unfused sweeps and
prologue, interpret-mode Pallas). Tolerances: loss terms rtol 1e-5,
atol 1e-7; each gradient rtol 1e-4 and atol 1e-4 of that parameter's
largest JAX gradient (batch norm's statistics included: they train,
fault F11).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.train import train as jtrain

from fluidnet_tpu_torch.models.fluidnet import from_jax_params
from fluidnet_tpu_torch.train.train import Draws, loss_fn

from tests.test_torch_model_generic import SHAPE, _at, _mconfs, _params
from tests.torch_port_util import DEV, assert_close, np_, random_flags, tt

N_FUTURE = 2
M3D_V5 = dict(advection_method="maccormackOurs", adaptive_window=False,
              advection_window=1, maccormack_strength=0.75,
              train_buoyancy_prob=0.5, train_buoyancy_scale=2.0,
              train_vorticity_confinement_prob=0.3,
              train_vorticity_confinement_amp=3.0, long_term_div_lambda=1.0,
              long_term_grad_mode="full", loss_div_lambda=1.0,
              loss_reject_threshold=0.1)


def _key_with_forces(jm):
    """A key whose force draws turn buoyancy and vorticity on."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        _, kforce = jax.random.split(key)
        _, b, _, v = jtrain._random_forces(kforce, jm)
        if float(b) > 0 and float(v) > 0:
            return key
    raise AssertionError("no key turns both forces on")


def _batch():
    rng = np.random.default_rng(81)
    flags = random_flags(rng, SHAPE, p_obstacle=0.15)
    u = (rng.standard_normal((2, 3) + SHAPE[2:]) * 0.5).astype(np.float32)
    return {"flags": flags, "u_div": u,
            "p_div": (rng.standard_normal(SHAPE) * 0.1).astype(np.float32),
            "density": rng.random(SHAPE).astype(np.float32)}


@pytest.mark.parametrize("case", ["tog_3d", "mres_bn_skip_3d"])
def test_loss_fn_grads_match_jax(case):
    jm, tm = _mconfs(case, **M3D_V5)
    params = _params(jm, seed=3)
    batch = _batch()
    key = _key_with_forces(jm)
    vg = jax.jit(jax.value_and_grad(jtrain.loss_fn, has_aux=True),
                 static_argnames=("mconf", "n_future"))
    (_, jterms), jgrads = vg(params, {k: jnp.asarray(v) for k, v in
                                      batch.items()}, key, jm, N_FUTURE)
    kdt, kforce = jax.random.split(key)
    draws = Draws(*(torch.tensor(np.asarray(a, np.float32)) for a in
                    (jtrain._random_dt(kdt, jm),
                     *jtrain._random_forces(kforce, jm))))
    model = from_jax_params(params, tm, device=DEV)
    named = model.jax_named_parameters()
    total, terms = loss_fn(model, {k: tt(v) for k, v in batch.items()},
                           None, tm, N_FUTURE, draws=draws)
    grads = torch.autograd.grad(total, [t for _, t in named])
    for k in ("total", "p", "u", "div", "long_term_div"):
        assert_close(terms[k].detach(), jterms[k], 1e-5, 1e-7, k)
    assert float(terms["long_term_div"].detach()) > 0
    for (name, _), g in zip(named, grads):
        ref = np_(_at(jgrads, name))
        assert_close(g, ref, 1e-4, 1e-4 * np.abs(ref).max(), name)
