"""K1's unfused forms (advect_sweep, mac_vel_sweep) of the PyTorch port, and
their gradient, against the JAX package.

On the CPU the port runs K1's plain version, held against the JAX Pallas
sweep in interpret mode: every raw output channel of the forward and
backward sweeps, with the scalar and its renormalisation, 'Ours' and not,
and the velocity-only form. Their gradients are held against jax.vjp with a
random cotangent on EVERY output, the bounds (u_mn, u_mx, s_mn, s_mx) and
s_den included: the JAX VJP (_sweep_bwd_rule) drops those and freezes the
positions, so autograd through the plain sweep would differ. One grid,
(1, c, 6, 8, 16) with 15% obstacles and flow of ~1 cell a sweep (the
displacement clip binds). Tolerance: rtol 1e-5, atol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidnet_tpu.core.celltype import is_fluid as j_is_fluid
from fluidnet_tpu.ops.advect_fast import \
    chebyshev_free_space as j_chebyshev
from fluidnet_tpu.ops.pallas.mac_sweep import advect_sweep as j_sweep

from fluidnet_tpu_torch.ops.cuda.mac_sweep import (advect_sweep,
                                                   mac_vel_sweep)

from tests.torch_port_util import assert_close, random_flags, tt

RTOL, ATOL = 1e-5, 1e-5
DT, W = 0.3, 1
SHAPE = (1, 1, 6, 8, 16)
# (backward sweep, ours, with_scalar, renorm)
CASES = {"fwd_ours_renorm": (False, True, True, True),
         "bwd_ours_renorm": (True, True, True, True),
         "fwd_plain_scalar": (False, False, True, False),
         "bwd_plain_scalar": (True, False, True, False),
         "fwd_vel_ours": (False, True, False, False),
         "bwd_vel": (True, False, False, False)}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(31)
    flags = random_flags(rng, SHAPE, p_obstacle=0.15)
    jflags = jnp.asarray(flags)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"u": f(1, 3, *SHAPE[2:]) * 3.0,
            "s": rng.random(SHAPE).astype(np.float32),
            "fwd_u": f(1, 3, *SHAPE[2:]), "fwd_s": f(*SHAPE),
            "m": np.asarray(j_is_fluid(jflags).astype(jnp.float32)),
            "free": np.asarray(j_chebyshev(jflags, W + 1), np.float32)}


def _inputs(case, is_bwd, ours, with_scalar):
    """(u, s, m, fwd_u, fwd_s, free) for one form; None where unused."""
    return (case["u"],
            case["s"] if with_scalar and not is_bwd else None,
            case["m"] if with_scalar else None,
            case["fwd_u"] if is_bwd else None,
            case["fwd_s"] if with_scalar and is_bwd else None,
            case["free"] if ours else None)


@pytest.mark.parametrize("name", list(CASES))
def test_sweep_and_vjp_match_jax(case, name):
    is_bwd, ours, with_scalar, renorm = CASES[name]
    u, s, m, fu, fs, free = _inputs(case, is_bwd, ours, with_scalar)
    dcoef = DT if is_bwd else -DT
    diff = ("fwd_u", "fwd_s") if is_bwd else ("u", "s")

    def jfn(a, b):
        args = {"u": u, "s": s, "fwd_u": fu, "fwd_s": fs, "m": m,
                "free": free, diff[0]: a, diff[1]: b}
        j = {k: None if v is None else jnp.asarray(v)
             for k, v in args.items()}
        return j_sweep(j["u"], j["s"], j["m"], j["fwd_u"], j["fwd_s"],
                       j["free"], dcoef, W, ours, with_scalar, renorm, False)
    primals = [case[diff[0]], case[diff[1]] if with_scalar else None]
    ref, vjp = jax.vjp(jfn, *primals)
    rng = np.random.default_rng(40)
    cots = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in ref.items()}
    jgrads = vjp({k: jnp.asarray(v) for k, v in cots.items()})

    targs = {k: tt(v) if v is not None else None for k, v in
             zip(("u", "s", "m", "fwd_u", "fwd_s", "free"),
                 (u, s, m, fu, fs, free))}
    for k in diff:
        if targs[k] is not None:
            targs[k].requires_grad_()
    targs["u"].requires_grad_()
    if with_scalar:
        out = advect_sweep(targs["u"], targs["s"], targs["m"],
                           targs["fwd_u"], targs["fwd_s"], targs["free"],
                           dcoef, W, ours, with_scalar, renorm)
    else:
        keys = ("u_w", "u_mn", "u_mx")
        out = dict(zip(keys, mac_vel_sweep(targs["u"], targs["fwd_u"],
                                           targs["free"], dcoef, W, ours)))
    assert set(out) == set(ref)
    for k in ref:
        assert_close(out[k], ref[k], RTOL, ATOL, k)
    sum((out[k] * tt(cots[k])).sum() for k in out).backward()
    for k, jg in zip(diff, jgrads):
        if jg is None:
            continue
        assert_close(targs[k].grad, jg, RTOL, ATOL, f"grad {k}")
    if is_bwd:
        # The backward sweep reads u only for its bounds: no gradient.
        assert targs["u"].grad is None or \
            not targs["u"].grad.abs().max() > 0
