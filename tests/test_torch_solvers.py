"""The PCG solver and the connected components of the PyTorch port against
the JAX package (plain PyTorch on both sides' XLA code; no kernel).

One grid, (2, 1, 12, 12, 12): batch 2 exercises the per-batch segments.
Labels must match exactly. Component means: rtol 1e-5, atol 1e-6 (sums in
another order: index_add_ against segment_sum). PCG: rtol 1e-4, atol 2e-5
on p (O(1) values): every iteration takes dot products over ~1700 cells,
which PyTorch and XLA sum in different orders, and CG carries those
rounding differences from one iteration to the next; the residual at
rtol 1e-3.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fluidnet_tpu.core.celltype import CellType
from fluidnet_tpu.ops.boundary import set_wall_bcs as j_set_wall_bcs
from fluidnet_tpu.ops.divergence import velocity_divergence as j_div
from fluidnet_tpu.solvers.cg import solve_pcg as j_solve_pcg
from fluidnet_tpu.solvers.components import component_mean as j_cmean
from fluidnet_tpu.solvers.components import \
    connected_components as j_components
from fluidnet_tpu.solvers.components import \
    normalize_pressure_mean as j_normalize

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.solvers.cg import solve_pcg
from fluidnet_tpu_torch.solvers.components import (component_mean,
                                                   connected_components,
                                                   normalize_pressure_mean)

from tests.torch_port_util import assert_close, np_, random_flags, tt

SHAPE = (2, 1, 12, 12, 12)
OB, FL, EM = (int(CellType.TypeObstacle), int(CellType.TypeFluid),
              int(CellType.TypeEmpty))


def _flags(kind):
    """'walls': two enclosed components per batch (a wall at x = 5, and in
    batch 1 a second at y = 7); 'random': 30% obstacles, many components;
    'empty': a few Empty cells (Dirichlet links) and 10% obstacles."""
    rng = np.random.default_rng({"walls": 71, "random": 72,
                                 "empty": 73}[kind])
    if kind == "walls":
        flags = random_flags(rng, SHAPE, p_obstacle=0.0)
        flags[..., :, 5] = OB
        flags[1, ..., 7, :] = OB
        return flags
    if kind == "random":
        return random_flags(rng, SHAPE, p_obstacle=0.3)
    flags = random_flags(rng, SHAPE, p_obstacle=0.1)
    empty = (rng.random(SHAPE) < 0.03) & (flags == FL)
    return np.where(empty, EM, flags).astype(np.int32)


def _div(flags, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((SHAPE[0], 3) + SHAPE[2:]).astype(np.float32)
    jflags = jnp.asarray(flags)
    return np.asarray(j_div(j_set_wall_bcs(jnp.asarray(u), jflags), jflags))


@pytest.mark.parametrize("kind", ["walls", "random", "empty"])
def test_connected_components_and_means(kind):
    flags = _flags(kind)
    labels = connected_components(tt(flags))
    jlabels = j_components(jnp.asarray(flags))
    assert np_(labels).dtype == np_(jlabels).dtype == np.int32
    np.testing.assert_array_equal(np_(labels), np_(jlabels))
    if kind == "walls":
        assert len(np.unique(np_(labels)[0])) == 3  # 2 components + n
        assert len(np.unique(np_(labels)[1])) == 5  # 4 components + n

    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    fl = np.asarray(flags) & FL > 0
    assert_close(component_mean(tt(x), labels, is_fluid(tt(flags))),
                 j_cmean(jnp.asarray(x), jlabels, jnp.asarray(fl)), 1e-5,
                 1e-6, "component_mean")
    for lab in (None, labels):
        assert_close(normalize_pressure_mean(tt(x), tt(flags), lab),
                     j_normalize(jnp.asarray(x), jnp.asarray(flags)), 1e-5,
                     1e-6, "normalize_pressure_mean")


@pytest.mark.parametrize("kind,tol,max_iter", [
    ("walls", 1e-4, 100),    # enclosed (singular) components
    ("empty", 1e-4, 100),    # Dirichlet links through Empty cells
    ("random", 0.0, 12),     # fixed count: both loops run 12 iterations
    ("random", 0.5, 100),    # ended by the tolerance
])
def test_solve_pcg_matches_jax(kind, tol, max_iter):
    flags = _flags(kind)
    div = _div(flags, 80)
    tp, tres = solve_pcg(tt(flags), tt(div), tol=tol, max_iter=max_iter)
    jp, jres = j_solve_pcg(jnp.asarray(flags), jnp.asarray(div), tol=tol,
                           max_iter=max_iter)
    assert_close(tp, jp, 1e-4, 2e-5, "p")
    assert_close(tres, jres, 1e-3, 0, "residual")
    if tol > 0 and max_iter == 100:
        assert tres.item() <= tol
    # Labels passed in (as rollout does) give the same solve.
    tp2, _ = solve_pcg(tt(flags), tt(div), tol=tol, max_iter=max_iter,
                       labels=connected_components(tt(flags)))
    assert_close(tp2, tp, 0, 0, "labels passed in")


def test_solve_pcg_no_null_space_removal():
    flags = _flags("empty")
    div = _div(flags, 81)
    for precond in ("jacobi", "none"):
        tp, tres = solve_pcg(tt(flags), tt(div), tol=0.0, max_iter=10,
                             precond=precond, remove_null_space=False)
        jp, jres = j_solve_pcg(jnp.asarray(flags), jnp.asarray(div),
                               tol=0.0, max_iter=10, precond=precond,
                               remove_null_space=False)
        assert_close(tp, jp, 1e-4, 2e-5, f"p ({precond})")
        assert_close(tres, jres, 1e-3, 0, f"residual ({precond})")
    with pytest.raises(ValueError):
        solve_pcg(tt(flags), tt(div), precond="ic0")
