"""K3 (the fixed-sweep Jacobi solve) and solve_jacobi of the PyTorch port
against the JAX package.

On the CPU the port's `jacobi_cuda` runs K3's plain version; it is held
against the JAX Pallas `jacobi_pallas` (interpret mode, called directly as
tests/test_solvers.py:127-147 does, at its shapes: (1,1,12,16,128) and
2-D (2,1,1,16,128)) and against JAX `solve_jacobi(allow_pallas=False)`, at
atol 1e-6 (test_solvers.py's tolerance: the same float32 operations, which
XLA:CPU rounds differently by ~1e-7 a sweep). The tolerance-terminated
loop is held against JAX's `while_loop`: p at rtol 1e-5 / atol 1e-6, the
residual at rtol 1e-4 (its sum of squares is ordered differently).
Random obstacles (15%), divergence of a random wall-BC'ed velocity.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidnet_tpu.ops.boundary import set_wall_bcs as j_set_wall_bcs
from fluidnet_tpu.ops.divergence import velocity_divergence as j_div
from fluidnet_tpu.solvers.jacobi import solve_jacobi as j_solve_jacobi
from fluidnet_tpu.solvers.pallas_jacobi import jacobi_pallas

from fluidnet_tpu_torch.ops.cuda import _build
from fluidnet_tpu_torch.solvers.cuda_jacobi import jacobi_cuda, jacobi_plain
from fluidnet_tpu_torch.solvers.jacobi import solve_jacobi

from tests.torch_port_util import assert_close, random_flags, tt

SWEEPS = 25


def _case(is3d):
    rng = np.random.default_rng(61 if is3d else 62)
    shape = (1, 1, 12, 16, 128) if is3d else (2, 1, 1, 16, 128)
    flags = random_flags(rng, shape)
    C = 3 if is3d else 2
    u = rng.standard_normal((shape[0], C) + shape[2:]).astype(np.float32)
    jflags = jnp.asarray(flags)
    div = j_div(j_set_wall_bcs(jnp.asarray(u), jflags), jflags)
    return flags, np.asarray(div)


@pytest.mark.parametrize("is3d", [True, False])
def test_jacobi_plain_matches_pallas_and_loop(is3d):
    flags, div = _case(is3d)
    before = sum(_build.launches.values())
    p = jacobi_cuda(tt(flags), tt(div), SWEEPS)
    assert sum(_build.launches.values()) == before  # CPU: plain version
    assert_close(p, jacobi_plain(tt(flags), tt(div), SWEEPS), 0, 0,
                 "jacobi_cuda on the CPU is jacobi_plain")
    ref_pallas = jacobi_pallas(jnp.asarray(flags), jnp.asarray(div), SWEEPS)
    assert_close(p, ref_pallas, 0, 1e-6, "vs jacobi_pallas")
    ref_loop, _ = j_solve_jacobi(jnp.asarray(flags), jnp.asarray(div),
                                 p_tol=0.0, max_iter=SWEEPS,
                                 allow_pallas=False)
    assert_close(p, ref_loop, 0, 1e-6, "vs solve_jacobi(allow_pallas=False)")
    # The p_tol == 0 route of solve_jacobi is K3, residual 0.
    tp, tres = solve_jacobi(tt(flags), tt(div), p_tol=0.0, max_iter=SWEEPS)
    assert_close(tp, p, 0, 0, "solve_jacobi(p_tol=0)")
    assert tres.item() == 0.0
    assert sum(_build.launches.values()) == before


@pytest.mark.parametrize("is3d", [True, False])
@pytest.mark.parametrize("p_tol,max_iter", [(0.5, 400), (1e-4, 20),
                                            (0.0, 12)])
def test_solve_jacobi_loop_matches_jax(is3d, p_tol, max_iter):
    """The while_loop semantics: ended by the tolerance (0.5, reached in
    ~25 sweeps), by max_iter (1e-4 in 20), and the fixed count with
    allow_pallas=False. Few sweeps: XLA:CPU rounds the sweep differently
    from PyTorch by ~1e-7 a sweep, which adds up over hundreds."""
    flags, div = _case(is3d)
    tp, tres = solve_jacobi(tt(flags), tt(div), p_tol=p_tol,
                            max_iter=max_iter, allow_pallas=False)
    jp, jres = j_solve_jacobi(jnp.asarray(flags), jnp.asarray(div),
                              p_tol=p_tol, max_iter=max_iter,
                              allow_pallas=False)
    assert_close(tp, jp, 1e-5, 1e-6, "p")
    assert_close(tres, jres, 1e-4, 0, "residual")
    if p_tol > 0:
        assert tres.item() < p_tol or max_iter == 20


def test_solve_jacobi_no_iterations():
    flags, div = _case(True)
    tp, tres = solve_jacobi(tt(flags), tt(div), p_tol=1e-5, max_iter=0)
    jp, jres = j_solve_jacobi(jnp.asarray(flags), jnp.asarray(div),
                              p_tol=1e-5, max_iter=0)
    assert_close(tp, jp, 0, 0, "p")
    assert tres.item() == float(jres) == torch.finfo(torch.float32).max
