"""The exact advection's training gradient (advection_window 0) of the
PyTorch port against the JAX package's.

JAX differentiates its exact route (ops/advect.py, ops/line_trace.py, a
fori_loop of masked march steps) through XLA; the port's is plain
PyTorch that autograd differentiates, clamps as jnp.clip's
min(max(.)). Here loss_fn with m3d_v5's training mconf at window 0
(maccormackOurs, 'full' gradients, n_future = 2, float32 convolutions) on
a batch of 2 random 12^3 scenes with 15% obstacles and a flow of up to a
few cells a step, so that rays hit obstacles and leave the domain; the
draws (dt, buoyancy, vorticity on) come from JAX and go to both sides.
JAX's value_and_grad compiles in a thread while the port runs.

XLA:CPU contracts two multiply-adds of the line trace's loop body into
FMAs (tests/test_torch_advect_exact.py), so a traced position may differ
from the port's by an ulp; each side's traces are compared ray by ray
(JAX's line_trace run on the port's recorded inputs: hit flags and final
cells), and the losses and gradients hold to a stated tolerance.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.core.config import ModelConfig as JModelConfig
from fluidnet_tpu.models.fluidnet import init_model
from fluidnet_tpu.ops.line_trace import line_trace as j_line_trace
from fluidnet_tpu.train import train as jtrain

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.models.fluidnet import from_jax_params
from fluidnet_tpu_torch.ops.line_trace import line_trace
from fluidnet_tpu_torch.ops.trace_diff import record_traces
from fluidnet_tpu_torch.train.train import loss_fn

from tests.test_torch_train import (M3D_V5, TERMS, _draws, _key_with_forces,
                                    _named, _optim)
from tests.torch_port_util import DEV, np_, random_flags, tt

SHAPE = (2, 1, 12, 12, 12)
N_FUTURE = 2
EXACT = dict(M3D_V5, advection_window=0, conv_compute_dtype="float32")
# Loss terms: relative. Gradients: relative L2 per parameter against
# JAX's (the traced positions' ulps reach them through the
# interpolation weights).
TERM_RTOL, GRAD_REL_L2 = 1e-5, 1e-5
# Rays (of every line trace of the loss's forward) whose hit flag or final
# cell differs from JAX's trace of the same inputs.
MAX_RAYS_APART = 0


def _batch(seed):
    rng = np.random.default_rng(seed)
    flags = random_flags(rng, SHAPE, p_obstacle=0.15)
    u = (rng.standard_normal((2, 3) + SHAPE[2:]) * 3.0).astype(np.float32)
    return {"flags": flags, "u_div": u,
            "p_div": (rng.standard_normal(SHAPE) * 0.1).astype(np.float32),
            "density": rng.random(SHAPE).astype(np.float32)}


@pytest.fixture(scope="module")
def run():
    """(JAX's loss terms and gradients, compiled in a thread; the port's,
    with the port's line traces)."""
    jm = _optim(JModelConfig(**EXACT))
    tm = _optim(ModelConfig(**EXACT))
    key = _key_with_forces(jm)
    params = init_model(jax.random.PRNGKey(3), jm)
    batch = _batch(17)
    jres = []

    def jax_side():
        vg = jax.jit(jax.value_and_grad(jtrain.loss_fn, has_aux=True),
                     static_argnames=("mconf", "n_future"))
        (_, terms), grads = vg(params, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, key, jm, N_FUTURE)
        jres.append((jax.tree_util.tree_map(np.asarray, terms),
                     jax.tree_util.tree_map(np.asarray, grads)))
    thread = threading.Thread(target=jax_side)
    thread.start()
    try:
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                tm, device=DEV)
        names = [k for k, _ in model.jax_named_parameters()]
        wrt = [t for _, t in model.jax_named_parameters()]
        (total, terms), traces = record_traces(lambda: loss_fn(
            model, {k: tt(v) for k, v in batch.items()}, None, tm, N_FUTURE,
            draws=_draws(key, jm)))
        grads = torch.autograd.grad(total, wrt)
        tres = ({k: float(v.detach()) for k, v in terms.items()},
                dict(zip(names, grads)), traces)
    finally:
        thread.join()
    return jres[0], tres


def _rel_l2(got, want):
    return float(np.linalg.norm(np_(got) - want) / np.linalg.norm(want))


def test_exact_loss_terms_and_grads_match_jax(run):
    """Every loss term within TERM_RTOL of JAX's, every parameter's
    gradient within GRAD_REL_L2 relative L2 of JAX's, all finite."""
    jres, tres = run
    (jterms, jgrads), (terms, grads, _) = jres, tres
    for k in TERMS:
        print(f"{k}: port {terms[k]:.7e}, JAX {float(jterms[k]):.7e}")
        np.testing.assert_allclose(terms[k], jterms[k], rtol=TERM_RTOL,
                                   atol=1e-7, err_msg=k)
    assert terms["long_term_div"] > 0
    worst = max((_rel_l2(g, _named(jgrads, n)), n) for n, g in grads.items())
    print(f"gradients: worst relative L2 {worst[0]:.3e} ({worst[1]})")
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, _named(jgrads, name)) <= GRAD_REL_L2, name


def test_exact_line_traces_match_jax(run):
    """Each line trace the port's forward ran (2 for the density and 6 for
    the velocity a step, 2 steps), run again by JAX from the same inputs:
    at most MAX_RAYS_APART rays whose hit flag or final cell differs; rays
    that hit an obstacle or the border are among them."""
    _, tres = run
    traces = tres[2]
    assert len(traces) == 8 * N_FUTURE
    trace = jax.jit(j_line_trace, static_argnames="max_steps")
    apart = hits = 0
    for args, kw in traces:
        th, *tpos = line_trace(*args, **kw)
        jh, *jpos = trace(*(jnp.asarray(np_(a)) for a in args), **kw)
        cells = sum((np.trunc(np_(a)) != np.trunc(np.asarray(b)))
                    for a, b in zip(tpos, jpos)).astype(bool)
        apart += int((cells | (np_(th) != np.asarray(jh))).sum())
        hits += int(np_(th).sum())
    print(f"line traces: {len(traces)}, rays that hit {hits}, rays apart "
          f"from JAX {apart}")
    assert hits > 0
    assert apart <= MAX_RAYS_APART

