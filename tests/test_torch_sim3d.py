"""The port's offline 3-D entry point (fluidnet_tpu_torch.cli.sim3d) and
the exact advection route (advection_window 0) through `simulate` and
`rollout`, against the JAX package.

sim3d: both packages' `main` at --res 16, --num_frames 7, --decimation 3,
around a box-and-sphere OBJ voxelized by the port at dim 10 and written as
.binvox, with the JAX side's fused knobs on (FLUIDNET_FUSED_EPILOGUE /
_PROLOGUE, which tests/conftest.py turns off; the port always runs the
fused forms). The model is the bundled m3d_v5_bestRollout's weights with
float32 convolutions (a copy of its checkpoint whose mconf says float32):
the JAX bf16 trunk sums its three kz partial convolutions in bf16, two
roundings the port's trunk does not make (tests/test_torch_model.py), and
after 7 steps those move a few density cells by ~1e-5 at values of ~4e-3,
past the tolerance below. The bundled bf16 checkpoint itself runs through
the port's main alone. Tolerance: rtol 1e-4, atol 1e-5 (the slice tests':
float32 convolutions and solves summed in other orders over 7 steps); the
geometry file equal.

The exact route: one 3-D ConvNet step around the same obstacle, one 2-D
step and a 3-step 3-D jacobi rollout with advection_window 0, each against
JAX's (jit-compiled; no Pallas sweep on that route), same tolerance.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.cli import sim3d as j_sim3d
from fluidnet_tpu.core.config import ModelConfig as JModelConfig
from fluidnet_tpu.core.grids import FluidState as JFluidState
from fluidnet_tpu.models.fluidnet import apply_model, init_model
from fluidnet_tpu.sim.simulate import create_plume_bcs as j_plume_bcs
from fluidnet_tpu.sim.simulate import rollout as j_rollout
from fluidnet_tpu.sim.simulate import simulate as j_simulate

from fluidnet_tpu_torch.cli import sim3d
from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.io.vbox import read_vbox
from fluidnet_tpu_torch.io.voxelize import save_binvox, voxelize_obj
from fluidnet_tpu_torch.models.fluidnet import from_jax_params
from fluidnet_tpu_torch.sim.simulate import (create_plume_bcs, rollout,
                                             simulate)

from chip_smoke import write_scene_obj
from tests.torch_port_util import (BUNDLED_3D, DEV, assert_close,
                                   float32_copy, random_flags, tt)

RTOL, ATOL = 1e-4, 1e-5
RES = 16
BUNDLED = BUNDLED_3D
DENSITY = "density_output_dt0.1.vbox"
GEOM = "geom_output.vbox"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("sim3d")
    obj = str(root / "scene.obj")
    write_scene_obj(obj)
    binvox = str(root / "scene.binvox")
    save_binvox(binvox, voxelize_obj(obj, dim=10))
    return root, binvox, float32_copy(BUNDLED, str(root / "m3d_v5_f32"))


def _args(binvox, model, out_dir):
    return ["--res", str(RES), "--num_frames", "7", "--decimation", "3",
            "--model", model, "--voxel_model", binvox, "--out_dir", out_dir]


@pytest.fixture(scope="module")
def runs(scene):
    root, binvox, model = scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLUIDNET_FUSED_EPILOGUE", "1")
        mp.setenv("FLUIDNET_FUSED_PROLOGUE", "1")
        j_sim3d.main(_args(binvox, model, str(root / "jax")))
    sim3d.main(_args(binvox, model, str(root / "port")) +
               ["--device", "cpu"])
    return root


def test_sim3d_vbox_matches_jax(runs):
    t, twhd = read_vbox(str(runs / "port" / DENSITY))
    j, jwhd = read_vbox(str(runs / "jax" / DENSITY))
    assert twhd == jwhd == (RES,) * 3
    assert t.shape == j.shape == (2, RES, RES, RES)   # (7 - 1) // 3 frames
    assert np.isfinite(t).all() and t.max() > 0.5
    assert_close(t, j, RTOL, ATOL, "density frames")
    tg, _ = read_vbox(str(runs / "port" / GEOM))
    jg, _ = read_vbox(str(runs / "jax" / GEOM))
    np.testing.assert_array_equal(tg, jg)
    # The obstacle border and the voxelized obstacle.
    border = RES ** 3 - (RES - 2) ** 3
    assert tg.shape == (1, RES, RES, RES) and border < tg.sum() < 2 * border


def test_build_scene_matches_jax(scene):
    _, binvox, _ = scene
    ts, tb = sim3d.build_scene(RES, binvox, device="cpu")
    js, jb = j_sim3d.build_scene(RES, binvox)
    np.testing.assert_array_equal(ts.flags.numpy(), np.asarray(js.flags))
    for name in ("u_bc", "u_bc_inv_mask", "density_bc",
                 "density_bc_inv_mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))


def test_sim3d_bundled_bf16_runs(scene, tmp_path):
    """The bundled (bf16) checkpoint through the port's main: the frames
    the header declares, finite, and the plume's density in them."""
    _, binvox, _ = scene
    out = str(tmp_path / "out")
    ms = sim3d.main(["--res", str(RES), "--num_frames", "5",
                     "--decimation", "2", "--model", BUNDLED,
                     "--voxel_model", binvox, "--out_dir", out,
                     "--device", "cpu"])
    frames, whd = read_vbox(os.path.join(out, DENSITY))
    assert ms > 0 and whd == (RES,) * 3 and frames.shape[0] == 2
    assert np.isfinite(frames).all() and frames.max() > 0.5


KNOBS = dict(dt=0.1, buoyancy_scale=2.0 * RES / 128,
             vorticity_confinement_amp=3.0, maccormack_strength=0.6,
             advection_method="maccormackOurs", adaptive_window=False,
             advection_window=0, conv_compute_dtype="float32")


def _exact_case(scene, is_3d):
    """A ConvNet (random init, float32), the plume and, in 3-D, the
    voxelized obstacle; a random initial velocity and density."""
    rng = np.random.default_rng(40 + is_3d)
    if is_3d:
        flags = np.asarray(j_sim3d.build_scene(RES, scene[1])[0].flags)
        shape = flags.shape
        u = rng.standard_normal((1, 3) + shape[2:]) * 0.5
    else:
        shape = (1, 1, 1, RES, RES)
        flags = random_flags(rng, shape, p_obstacle=0.1)
        u = rng.standard_normal((1, 2) + shape[2:]) * 2.0
    u = u.astype(np.float32)
    rho = rng.random(shape).astype(np.float32)
    p = np.zeros(shape, np.float32)
    jm = JModelConfig(is_3d=is_3d, **KNOBS)
    params = init_model(jax.random.PRNGKey(3), jm)
    js = JFluidState(u=jnp.asarray(u), p=jnp.asarray(p),
                     flags=jnp.asarray(flags), density=jnp.asarray(rho))
    ts = FluidState(u=tt(u), p=tt(p), flags=tt(flags), density=tt(rho))
    tm = ModelConfig(is_3d=is_3d, **KNOBS)
    return {"jm": jm, "params": params, "js": js, "tm": tm, "ts": ts,
            "jbcs": j_plume_bcs(js, [1.0], u_scale=0.6 * RES / 128,
                                rad=0.15),
            "tbcs": create_plume_bcs(ts, [1.0], u_scale=0.6 * RES / 128,
                                     rad=0.15),
            "tmodel": from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             params),
                                      tm, device=DEV)}


def _j_model(jm):
    return lambda pr, p, u, f, **kw: apply_model(pr, jm, p, u, f, **kw)


@pytest.mark.parametrize("is_3d", [True, False])
def test_simulate_exact_route_matches_jax(scene, is_3d, monkeypatch):
    monkeypatch.setenv("FLUIDNET_FUSED_EPILOGUE", "1")
    monkeypatch.setenv("FLUIDNET_FUSED_PROLOGUE", "1")
    c = _exact_case(scene, is_3d)
    jm = c["jm"]
    step = jax.jit(lambda s, prm, b: j_simulate(s, jm, _j_model(jm), prm,
                                                b))
    js = step(c["js"], c["params"], c["jbcs"])
    ts = simulate(c["ts"], c["tm"], c["tmodel"], c["tbcs"])
    for name in ("u", "p", "density"):
        assert torch.isfinite(getattr(ts, name)).all()
        assert_close(getattr(ts, name), getattr(js, name), RTOL, ATOL, name)
    # grad=True records the exact route for autograd: the same state, and
    # a finite gradient of it with respect to the initial velocity.
    u0 = c["ts"].u.clone().requires_grad_(True)
    gs = simulate(c["ts"].replace(u=u0), c["tm"], c["tmodel"], c["tbcs"],
                  grad=True)
    for name in ("u", "p", "density"):
        assert torch.equal(getattr(gs, name).detach(), getattr(ts, name))
    g, = torch.autograd.grad(gs.density.sum() + gs.u.square().sum(), u0)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_rollout_exact_route_matches_jax(scene, monkeypatch):
    """3 jacobi-34 steps (K3's plain version) around the obstacle."""
    monkeypatch.setenv("FLUIDNET_FUSED_EPILOGUE", "1")
    monkeypatch.setenv("FLUIDNET_FUSED_PROLOGUE", "1")
    c = _exact_case(scene, True)
    jm = c["jm"].replace(sim_method="jacobi", max_iter=34)
    tm = c["tm"].replace(sim_method="jacobi", max_iter=34)
    js = jax.jit(lambda s, b: j_rollout(s, jm, 3, None, None, b))(
        c["js"], c["jbcs"])
    ts = rollout(c["ts"], tm, 3, None, c["tbcs"])
    for name in ("u", "p", "density"):
        assert_close(getattr(ts, name), getattr(js, name), RTOL, ATOL, name)
