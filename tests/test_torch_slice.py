"""The whole ported slice against the JAX package: the 3-D plume step
(`simulate`) and its `rollout`, with the ConvNet, the ConvNet plus Jacobi
polish, jacobi-34 and PCG projections.

Plume BCs, the bench's knobs (maccormackOurs, W=1, fixed window, dt 0.1,
buoyancy 2.0, vorticity 3.0, MacCormack strength 0.6), a random-init
default model with float32 convs, a 16^3 domain with 5% interior
obstacles and a random initial velocity and density. The JAX side runs
with FLUIDNET_FUSED_EPILOGUE=1 and FLUIDNET_FUSED_PROLOGUE=1 (the
package's defaults, which tests/conftest.py turns off for the rest of the
suite; the knobs are read at trace time), so both sides take the same
fused path: K1 twice per step, then K2's prologue (ConvNet) or its forces
block (jacobi, PCG). Tolerance: rtol 1e-4, atol 1e-5 (one step holds a
float32 convnet or a solver, whose sums XLA:CPU and PyTorch order
differently, plus the kernels' parity budgets).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.core.config import ModelConfig as JModelConfig
from fluidnet_tpu.core.grids import FluidState as JFluidState
from fluidnet_tpu.models.fluidnet import apply_model, init_model
from fluidnet_tpu.sim.simulate import create_plume_bcs as j_plume_bcs
from fluidnet_tpu.sim.simulate import rollout as j_rollout
from fluidnet_tpu.sim.simulate import simulate as j_simulate

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.models.fluidnet import from_jax_params
from fluidnet_tpu_torch.sim.simulate import (create_plume_bcs, rollout,
                                             simulate)

from tests.torch_port_util import (DEV, assert_close, np_, random_flags,
                                   tt)

RTOL, ATOL = 1e-4, 1e-5
N = 16
BENCH_KNOBS = dict(is_3d=True, sim_method="convnet", dt=0.1,
                   buoyancy_scale=2.0, vorticity_confinement_amp=3.0,
                   maccormack_strength=0.6,
                   advection_method="maccormackOurs", adaptive_window=False,
                   advection_window=1, conv_compute_dtype="float32")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(50)
    flags = random_flags(rng, (1, 1, N, N, N), p_obstacle=0.05)
    u = (rng.standard_normal((1, 3, N, N, N)) * 0.5).astype(np.float32)
    density = rng.random((1, 1, N, N, N)).astype(np.float32)
    p = np.zeros((1, 1, N, N, N), np.float32)
    jm = JModelConfig(**BENCH_KNOBS)
    params = init_model(jax.random.PRNGKey(2), jm)

    jstate = JFluidState(u=jnp.asarray(u), p=jnp.asarray(p),
                         flags=jnp.asarray(flags),
                         density=jnp.asarray(density))
    tstate = FluidState(u=tt(u), p=tt(p), flags=tt(flags),
                        density=tt(density))
    tm = ModelConfig(**BENCH_KNOBS)
    return {
        "jm": jm, "params": params, "jstate": jstate,
        "jbcs": j_plume_bcs(jstate, [1.0], u_scale=0.6, rad=0.15),
        "jmodel": lambda pr, pp, uu, ff, **kw: apply_model(pr, jm, pp, uu,
                                                           ff, **kw),
        "tm": tm, "tstate": tstate,
        "tbcs": create_plume_bcs(tstate, [1.0], u_scale=0.6, rad=0.15),
        "tmodel": from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                  tm, device=DEV),
    }


@pytest.fixture
def fused_knobs(monkeypatch):
    monkeypatch.setenv("FLUIDNET_FUSED_EPILOGUE", "1")
    monkeypatch.setenv("FLUIDNET_FUSED_PROLOGUE", "1")


def _assert_state_close(ts, js, what):
    for name in ("u", "p", "density"):
        assert_close(getattr(ts, name), getattr(js, name), RTOL, ATOL,
                     f"{what}: {name}")
    np.testing.assert_array_equal(np_(ts.flags), np_(js.flags))


def test_simulate_two_steps(case, fused_knobs):
    js, ts = case["jstate"], case["tstate"]
    for step in range(2):
        js = j_simulate(js, case["jm"], case["jmodel"], case["params"],
                        case["jbcs"])
        ts = simulate(ts, case["tm"], case["tmodel"], case["tbcs"])
        assert torch.isfinite(ts.u).all()
        _assert_state_close(ts, js, f"step {step + 1}")


def test_rollout_three_steps(case, fused_knobs):
    js, jframes = j_rollout(case["jstate"], case["jm"], 3, case["jmodel"],
                            case["params"], case["jbcs"], save_every=1)
    ts, tframes = rollout(case["tstate"], case["tm"], 3, case["tmodel"],
                          case["tbcs"], save_every=1)
    _assert_state_close(ts, js, "rollout")
    assert tframes.shape == jframes.shape == (3, 1, 1, N, N, N)
    assert_close(tframes, jframes, RTOL, ATOL, "density frames")
    assert_close(rollout(case["tstate"], case["tm"], 3, case["tmodel"],
                         case["tbcs"]).u, ts.u, 0, 0, "save_every=0")


# The certification projections of bench.py:184-195 and the hybrid.
PROJECTIONS = {"jacobi34": dict(sim_method="jacobi", max_iter=34),
               "pcg": dict(sim_method="pcg", max_iter=100, pcg_tol=1e-4),
               "convnet_p8": dict(polish_iters=8)}


@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_simulate_two_steps_projections(case, fused_knobs, name):
    kw = PROJECTIONS[name]
    jm, tm = case["jm"].replace(**kw), case["tm"].replace(**kw)
    net = name.startswith("convnet")
    js, ts = case["jstate"], case["tstate"]
    for step in range(2):
        js = j_simulate(js, jm, case["jmodel"] if net else None,
                        case["params"] if net else None, case["jbcs"])
        ts = simulate(ts, tm, case["tmodel"] if net else None, case["tbcs"])
        assert torch.isfinite(ts.u).all()
        _assert_state_close(ts, js, f"{name} step {step + 1}")


@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_rollout_three_steps_projections(case, fused_knobs, name):
    kw = PROJECTIONS[name]
    jm, tm = case["jm"].replace(**kw), case["tm"].replace(**kw)
    net = name.startswith("convnet")
    js = j_rollout(case["jstate"], jm, 3, case["jmodel"] if net else None,
                   case["params"] if net else None, case["jbcs"])
    ts = rollout(case["tstate"], tm, 3, case["tmodel"] if net else None,
                 case["tbcs"])
    _assert_state_close(ts, js, f"{name} rollout")


@pytest.mark.parametrize("kw", [dict(adaptive_window=True,
                                     advection_window=2),
                                dict(no_density=True)])
def test_unported_branches_raise(case, fused_knobs, kw):
    """The two 3-D branches the first slices left unported, which now run
    and match JAX for one step: the adaptive advection window (W = 1 is
    taken when max|u| dt fits a cell), and a step without density (the
    velocity on K1's unfused sweep, vorticity confinement alone on K4's
    plain version)."""
    js, ts = case["jstate"], case["tstate"]
    jbcs, tbcs = case["jbcs"], case["tbcs"]
    if kw.pop("no_density", False):
        js, ts = js.replace(density=None), ts.replace(density=None)
    jm, tm = case["jm"].replace(**kw), case["tm"].replace(**kw)
    js = j_simulate(js, jm, case["jmodel"], case["params"], jbcs)
    ts = simulate(ts, tm, case["tmodel"], tbcs)
    for name in ("u", "p") + (("density",) if ts.density is not None
                              else ()):
        assert_close(getattr(ts, name), getattr(js, name), RTOL, ATOL, name)
