"""The PyTorch port's core and physics-glue modules against the JAX package.

Each test hands the same seeded numpy inputs to a fluidnet_tpu function and
to its fluidnet_tpu_torch counterpart and compares the outputs. Tolerance,
unless a test says otherwise: rtol 1e-5, atol 1e-6 (float32 elementwise
ops in the same order; only library-level rounding may differ). Grids are
(1, 1, 10, 16, 24) in 3-D and (1, 1, 1, 16, 24) in 2-D.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidnet_tpu.core import celltype as jcell
from fluidnet_tpu.core import config as jconfig
from fluidnet_tpu.core import grids as jgrids
from fluidnet_tpu.ops import boundary as jboundary
from fluidnet_tpu.ops import divergence as jdivergence
from fluidnet_tpu.ops import forces as jforces
from fluidnet_tpu.ops import interp as jinterp
from fluidnet_tpu.ops import prologue as jprologue
from fluidnet_tpu.ops import stencil as jst
from fluidnet_tpu.ops.advect_fast import \
    chebyshev_free_space as j_chebyshev
from fluidnet_tpu.ops.velocity_update import velocity_update as j_vel_update
from fluidnet_tpu.sim.simulate import (apply_boundaries as j_apply_bcs,
                                      create_plume_bcs as j_plume_bcs)

from fluidnet_tpu_torch.core import celltype as tcell
from fluidnet_tpu_torch.core import config as tconfig
from fluidnet_tpu_torch.core import grids as tgrids
from fluidnet_tpu_torch.ops import boundary as tboundary
from fluidnet_tpu_torch.ops import divergence as tdivergence
from fluidnet_tpu_torch.ops import forces as tforces
from fluidnet_tpu_torch.ops import interp as tinterp
from fluidnet_tpu_torch.ops import prologue as tprologue
from fluidnet_tpu_torch.ops import stencil as tst
from fluidnet_tpu_torch.ops import velocity_update as tvu
from fluidnet_tpu_torch.ops.advect_fast import \
    chebyshev_free_space as t_chebyshev
from fluidnet_tpu_torch.sim import simulate as tsim

from tests.torch_port_util import DEV, assert_close, random_flags, tt

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLED = os.path.join(REPO, "data", "models_bundled")


def _case(seed, is3d, stick_empty=True, outflow=False):
    rng = np.random.default_rng(seed)
    Z, Y, X = (10, 16, 24) if is3d else (1, 16, 24)
    flags = random_flags(rng, (1, 1, Z, Y, X), stick_empty=stick_empty)
    if outflow:
        out = rng.random(flags.shape) < 0.2
        flags = np.where(out & ((flags & 4) > 0), flags | 16, flags)
    C = 3 if is3d else 2
    u = rng.standard_normal((1, C, Z, Y, X)).astype(np.float32)
    rho = rng.random((1, 1, Z, Y, X)).astype(np.float32)
    p = rng.standard_normal((1, 1, Z, Y, X)).astype(np.float32)
    return flags, u, rho, p


# --- 1. core/celltype ------------------------------------------------------

def test_celltype_bits():
    assert {e.name: int(e) for e in tcell.CellType} == \
        {e.name: int(e) for e in jcell.CellType}
    rng = np.random.default_rng(0)
    flags = rng.integers(0, 1 << 16, (1, 1, 4, 5, 6)).astype(np.int32)
    for name in ("is_fluid", "is_obstacle", "is_empty", "is_outflow",
                 "is_stick", "is_inflow"):
        for f in (flags, flags.astype(np.float32)):
            np.testing.assert_array_equal(
                getattr(tcell, name)(tt(f)).numpy(),
                np.asarray(getattr(jcell, name)(jnp.asarray(f))), name)


# --- 2. core/config --------------------------------------------------------

@pytest.mark.parametrize("cls", ["ModelConfig", "InputChannels",
                                 "OptimConfig"])
def test_config_fields_match(cls):
    jf = [(f.name, jconfig.to_dict(f.default)) for f in
          dataclasses.fields(getattr(jconfig, cls))]
    tf = [(f.name, tconfig.to_dict(f.default)) for f in
          dataclasses.fields(getattr(tconfig, cls))]
    assert tf == jf


@pytest.mark.parametrize("name", ["m3d_v5_bestRollout", "m3d_v5_lastEpoch",
                                  "m3d", "m2d"])
def test_config_from_dict_matches(name):
    from fluidnet_tpu.utils.checkpoint import load_mconf as j_load_mconf
    from fluidnet_tpu_torch.utils.checkpoint import load_mconf
    path = os.path.join(BUNDLED, name)
    with open(os.path.join(path, "mconf.json")) as f:
        d = json.load(f)["mconf"]
    tm = tconfig.from_dict(d)
    assert tconfig.to_dict(tm) == jconfig.to_dict(j_load_mconf(path))
    assert load_mconf(path) == tm
    assert tm.replace(dt=0.5).dt == 0.5


# --- 3. core/grids ---------------------------------------------------------

@pytest.mark.parametrize("is3d", [False, True])
def test_grids(is3d):
    shape = (2, 1, 10, 16, 24) if is3d else (2, 1, 1, 16, 24)
    for bnd in (1, 2):
        np.testing.assert_array_equal(
            tgrids.border_mask(shape, is3d, bnd, DEV).numpy(),
            np.asarray(jgrids.border_mask(shape, is3d, bnd)))
        tflags = tgrids.empty_domain(shape, is3d, bnd, DEV)
        assert tflags.dtype == torch.int32
        np.testing.assert_array_equal(
            tflags.numpy(), np.asarray(jgrids.empty_domain(shape, is3d,
                                                           bnd)))
    flags, _, _, _ = _case(3, is3d)
    np.testing.assert_array_equal(
        tgrids.flags_to_occupancy(tt(flags)).numpy(),
        np.asarray(jgrids.flags_to_occupancy(jnp.asarray(flags))))
    assert tgrids.get_dx(shape) == jgrids.get_dx(shape)
    assert tgrids.get_dx(tt(flags)) == jgrids.get_dx(jnp.asarray(flags))
    u = torch.zeros((2, 3 if is3d else 2) + shape[2:])
    assert tgrids.check_shapes(u, torch.zeros(shape)) == is3d
    with pytest.raises(ValueError):
        tgrids.check_shapes(u, torch.zeros((2, 1, 3, 3, 3)))
    st = tgrids.FluidState(u=u, p=torch.zeros(shape),
                           flags=tgrids.empty_domain(shape, is3d,
                                                   device=DEV))
    assert st.is_3d == is3d and st.replace(density=u).density is u


def test_constructors_default_to_cuda():
    """Without a device the public constructors build on the CUDA device;
    with no CUDA device they raise instead of building on the CPU."""
    from fluidnet_tpu_torch.core.config import ModelConfig
    from fluidnet_tpu_torch.models.fluidnet import FluidNet, from_jax_params
    shape = (1, 1, 4, 5, 6)
    mconf = ModelConfig(is_3d=True)
    makers = [lambda: tgrids.empty_domain(shape, True),
              lambda: tgrids.border_mask(shape, True),
              lambda: tinterp.cell_center_positions(shape)[0],
              lambda: FluidNet(mconf).final.weight]
    cpu_net = FluidNet(mconf, device=DEV)
    assert cpu_net.final.weight.device.type == "cpu"
    params = {"stages": [[{"conv": {"w": st[0].weight.detach().numpy(),
                                    "b": st[0].bias.detach().numpy()}}]
                         for st in cpu_net.stages],
              "final": {"conv": {"w": cpu_net.final.weight.detach().numpy(),
                                 "b": cpu_net.final.bias.detach().numpy()}}}
    makers.append(lambda: from_jax_params(params, mconf).final.weight)
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


# --- 4. ops/stencil --------------------------------------------------------

@pytest.mark.parametrize("fn", ["xm", "xp", "ym", "yp", "zm", "zp"])
def test_stencil_shifts(fn):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 5, 6, 7)).astype(np.float32)
    m = rng.random((2, 1, 5, 6, 7)) < 0.5
    for fill in (0, 1.0, -np.inf):
        assert_close(getattr(tst, fn)(tt(a), fill),
                     getattr(jst, fn)(jnp.asarray(a), fill), 0, 0, fn)
    for fill in (False, True):
        np.testing.assert_array_equal(
            getattr(tst, fn)(tt(m), fill).numpy(),
            np.asarray(getattr(jst, fn)(jnp.asarray(m), fill)))
    for off in (-2, 3):
        assert_close(tst.shift(tt(a), off, -2, 0.5),
                     jst.shift(jnp.asarray(a), off, -2, 0.5), 0, 0)


# --- 5. ops/interp ---------------------------------------------------------

@pytest.mark.parametrize("is3d", [False, True])
def test_interp_mac_and_positions(is3d):
    _, u, _, _ = _case(5, is3d)
    fns = ["get_at_mac_x", "get_at_mac_y"] + (["get_at_mac_z"] if is3d
                                              else [])
    for fn in fns:
        assert_close(getattr(tinterp, fn)(tt(u), is3d),
                     getattr(jinterp, fn)(jnp.asarray(u), is3d), RTOL,
                     ATOL, fn)
    for a, b in zip(tinterp.cell_center_positions(u.shape, device=DEV),
                    jinterp.cell_center_positions(u.shape)):
        assert_close(a, b, 0, 0)


# --- 6.-8. setWallBcs, divergence, velocityUpdate ----------------------------

@pytest.mark.parametrize("is3d", [False, True])
def test_set_wall_bcs(is3d):
    flags, u, _, _ = _case(6, is3d)
    assert_close(tboundary.set_wall_bcs(tt(u), tt(flags)),
                 jboundary.set_wall_bcs(jnp.asarray(u), jnp.asarray(flags)),
                 RTOL, ATOL)


@pytest.mark.parametrize("is3d", [False, True])
def test_velocity_divergence(is3d):
    flags, u, _, _ = _case(7, is3d)
    assert_close(tdivergence.velocity_divergence(tt(u), tt(flags)),
                 jdivergence.velocity_divergence(jnp.asarray(u),
                                                 jnp.asarray(flags)),
                 RTOL, ATOL)


@pytest.mark.parametrize("is3d", [False, True])
def test_velocity_update_empty_outflow(is3d):
    flags, u, _, p = _case(8, is3d, outflow=True)
    assert ((flags & 4) > 0).any() and ((flags & 16) > 0).any()
    assert_close(tvu.velocity_update(tt(u), tt(flags), tt(p)),
                 j_vel_update(jnp.asarray(u), jnp.asarray(flags),
                                     jnp.asarray(p)), RTOL, ATOL)


# --- 9. ops/forces ----------------------------------------------------------

@pytest.mark.parametrize("is3d", [False, True])
def test_forces(is3d):
    flags, u, rho, _ = _case(9, is3d)
    tf, jf = tt(flags), jnp.asarray(flags)
    tu, ju = tt(u), jnp.asarray(u)
    g = np.asarray([0.02, -0.17, 0.05], np.float32)
    dt = 0.25
    assert_close(tforces.add_buoyancy(tu, tf, tt(rho), g, dt),
                 jforces.add_buoyancy(ju, jf, jnp.asarray(rho), g, dt),
                 RTOL, ATOL, "add_buoyancy")
    assert_close(tforces.add_gravity(tu, tf, g, dt),
                 jforces.add_gravity(ju, jf, g, dt), RTOL, ATOL,
                 "add_gravity")
    cent_t = tforces.get_centered(tu, is3d)
    cent_j = jforces.get_centered(ju, is3d)
    assert_close(cent_t, cent_j, RTOL, ATOL, "get_centered")
    assert_close(tforces._curl(cent_t, is3d), jforces._curl(cent_j, is3d),
                 RTOL, ATOL, "_curl")
    assert_close(tforces.vorticity_confinement_xla(tu, tf, 0.6),
                 jforces.vorticity_confinement_xla(ju, jf, 0.6), RTOL,
                 ATOL, "vorticity_confinement_xla")
    force = np.random.default_rng(10).standard_normal(
        (1, 3) + u.shape[2:]).astype(np.float32)
    assert_close(tforces._add_force_field(tu, tf, tt(force), is3d),
                 jforces._add_force_field(ju, jf, jnp.asarray(force), is3d),
                 RTOL, ATOL, "_add_force_field")
    assert_close(
        tforces.forces_block_xla(tu, tf, tt(rho), g, -g, 0.6, dt),
        jforces.forces_block_xla(ju, jf, jnp.asarray(rho), g, -g,
                                 jnp.asarray(0.6, jnp.float32), dt),
        RTOL, ATOL, "forces_block_xla")


def test_forces_batched_scales_raise():
    """Per-sample (B, 3) gravity vectors and (B,) strengths: the plain
    force ops take them as JAX does; the fused prologue still raises."""
    flags, u, rho, _ = _case(11, True)
    b = u.shape[0]
    g = np.linspace(-0.2, 0.1, 3 * b, dtype=np.float32).reshape(b, 3)
    amp = np.linspace(0.3, 0.9, b, dtype=np.float32)
    tf, jf, tu, ju = tt(flags), jnp.asarray(flags), tt(u), jnp.asarray(u)
    assert_close(tforces.add_buoyancy(tu, tf, tt(rho), g, 0.1),
                 jforces.add_buoyancy(ju, jf, jnp.asarray(rho), g, 0.1),
                 RTOL, ATOL, "add_buoyancy, (B, 3)")
    assert_close(tforces.add_gravity(tu, tf, g, 0.1),
                 jforces.add_gravity(ju, jf, g, 0.1), RTOL, ATOL,
                 "add_gravity, (B, 3)")
    assert_close(tforces.vorticity_confinement_xla(tu, tf, amp),
                 jforces.vorticity_confinement_xla(ju, jf, amp), RTOL, ATOL,
                 "vorticity_confinement_xla, (B,)")
    with pytest.raises(NotImplementedError):
        tprologue.projection_prologue(tt(u), tt(flags), tt(rho),
                                      np.zeros(3), np.zeros(3),
                                      np.ones(1), 0.1)


# --- 11. ops/prologue, plain path --------------------------------------------

@pytest.mark.parametrize("with_bc", [False, True])
def test_prologue_ref_matches_prologue_xla(with_bc):
    flags, u, rho, _ = _case(12, True)
    rng = np.random.default_rng(13)
    u_bc = u_inv = None
    if with_bc:
        u_bc = (rng.standard_normal((1, 3, 10, 4, 24)) * 0.3).astype(
            np.float32)
        u_inv = (rng.random((1, 3, 10, 4, 24)) < 0.5).astype(np.float32)
    buoy_g = np.asarray([0.0, -0.17, 0.02], np.float32)
    grav_g = np.asarray([0.01, -0.05, 0.0], np.float32)
    jb = [None if a is None else jnp.asarray(a) for a in (u_bc, u_inv)]
    tb = [None if a is None else tt(a) for a in (u_bc, u_inv)]
    tu, tdiv = tprologue.projection_prologue(
        tt(u), tt(flags), tt(rho), buoy_g, grav_g, 0.6, 0.25, *tb)
    ju, jdiv = jprologue.prologue_xla(
        jnp.asarray(u), jnp.asarray(flags), jnp.asarray(rho),
        jnp.asarray(buoy_g), jnp.asarray(grav_g),
        jnp.asarray(0.6, jnp.float32), 0.25, *jb)
    assert_close(tu, ju, RTOL, ATOL, "u''")
    assert_close(tdiv, jdiv, RTOL, ATOL, "div")


# --- 13. / 15. free space, boundaries, plume BCs ---------------------------

@pytest.mark.parametrize("is3d", [False, True])
def test_chebyshev_free_space(is3d):
    flags, _, _, _ = _case(14, is3d)
    for max_d in (2, 3):
        assert_close(t_chebyshev(tt(flags), max_d),
                     j_chebyshev(jnp.asarray(flags), max_d), 0, 0)


def test_plume_bcs_and_apply_boundaries():
    flags, u, rho, p = _case(15, True)
    tstate = tgrids.FluidState(u=tt(u), p=tt(p), flags=tt(flags),
                               density=tt(rho))
    jstate = jgrids.FluidState(u=jnp.asarray(u), p=jnp.asarray(p),
                               flags=jnp.asarray(flags),
                               density=jnp.asarray(rho))
    tb = tsim.create_plume_bcs(tstate, [1.0], u_scale=0.6, rad=0.2)
    jb = j_plume_bcs(jstate, [1.0], u_scale=0.6, rad=0.2)
    for f in dataclasses.fields(tb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert_close(a, b, 0, 0, f.name)
    rng = np.random.default_rng(16)
    p_bc = rng.standard_normal((1, 1, 10, 16, 24)).astype(np.float32)
    p_inv = (rng.random((1, 1, 10, 16, 24)) < 0.5).astype(np.float32)
    tb = dataclasses.replace(tb, p_bc=tt(p_bc), p_bc_inv_mask=tt(p_inv))
    jb = jb.__class__(**{**{f.name: getattr(jb, f.name)
                            for f in dataclasses.fields(jb)},
                         "p_bc": jnp.asarray(p_bc),
                         "p_bc_inv_mask": jnp.asarray(p_inv)})
    ts = tsim.apply_boundaries(tstate, tb)
    js = j_apply_bcs(jstate, jb)
    for name in ("u", "p", "density"):
        assert_close(getattr(ts, name), getattr(js, name), RTOL, ATOL, name)
