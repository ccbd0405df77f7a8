"""The port's 2-D interactive demo against the JAX package: the 2-D
`simulate` step and `rollout` (the server's step), the demo server
(cli/serve.py: DemoSim, validate_toggle, the HTTP endpoints) and the
headless demo (cli/demo2d.py).

The step runs the server's knobs on a (1, 1, 1, 24, 24) grid with 5%
obstacles and plume BCs: three density channels, maccormackOurs with the
adaptive window (2, taken from the m2d checkpoint), buoyancy 1 and
vorticity 0 passed as overrides as the server does, and the bundled m2d
weights with float32 convs (the bf16 trunk is held in
test_torch_model2d.py). A calm initial velocity takes window 1, a strong
one window 2. Tolerance rtol 1e-4, atol 1e-5: one step holds a float32
convnet or a solver, whose sums XLA:CPU and PyTorch order differently.
JAX runs the Pallas warp in interpret mode.
"""

import json
import threading
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidnet_tpu.cli import demo2d as j_demo2d
from fluidnet_tpu.cli import serve as j_serve
from fluidnet_tpu.core.config import InputChannels as JInputChannels
from fluidnet_tpu.core.config import ModelConfig as JModelConfig
from fluidnet_tpu.core.grids import FluidState as JFluidState
from fluidnet_tpu.models.fluidnet import apply_model
from fluidnet_tpu.sim.simulate import create_plume_bcs as j_plume_bcs
from fluidnet_tpu.sim.simulate import rollout as j_rollout
from fluidnet_tpu.sim.simulate import simulate as j_simulate

from fluidnet_tpu_torch.cli import demo2d, serve
from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.models.fluidnet import FluidNet
from fluidnet_tpu_torch.sim import simulate as tsim
from fluidnet_tpu_torch.utils.checkpoint import load_mconf, load_params

from tests.torch_port_util import (DEV, assert_close, np_, random_flags,
                                   tt)

RTOL, ATOL = 1e-4, 1e-5
N = 24
M2D = "data/models_bundled/m2d"
RGB = [1.0, 0.8, 0.3]
SERVE_KNOBS = dict(dt=0.1, buoyancy_scale=1.0, vorticity_confinement_amp=0.0,
                   advection_method="maccormackOurs", max_iter=34,
                   conv_compute_dtype="float32")
PROJ = {"convnet": dict(sim_method="convnet"),
        "jacobi34": dict(sim_method="jacobi", max_iter=34),
        "pcg": dict(sim_method="pcg", max_iter=100, pcg_tol=1e-4)}


@pytest.fixture(scope="module")
def case():
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, M2D)
    tm = load_mconf(path).replace(**SERVE_KNOBS)
    assert tm.adaptive_window and tm.advection_window == 2
    jm = JModelConfig(**{k: getattr(tm, k) for k in (
        "is_3d", "model_type", "conv_compute_dtype", "nonlin_type", "dt",
        "buoyancy_scale", "vorticity_confinement_amp", "advection_method",
        "advection_window", "adaptive_window", "maccormack_strength",
        "max_iter")}, input_channels=JInputChannels(**vars(
            tm.input_channels)))
    params = load_params(path)
    rng = np.random.default_rng(80)
    shape = (1, 1, 1, N, N)
    flags = random_flags(rng, shape, p_obstacle=0.05)
    base = rng.standard_normal((1, 2, 1, N, N)).astype(np.float32)
    density = rng.random((1, 3, 1, N, N)).astype(np.float32)
    p = np.zeros(shape, np.float32)
    states = {}
    for name, scale in (("calm", 0.5), ("strong", 4.0)):
        u = base * scale
        js = JFluidState(u=jnp.asarray(u), p=jnp.asarray(p),
                         flags=jnp.asarray(flags),
                         density=jnp.asarray(density))
        ts = FluidState(u=tt(u), p=tt(p), flags=tt(flags),
                        density=tt(density))
        states[name] = (js, ts)
    js, ts = states["calm"]
    return {"jm": jm, "tm": tm, "params": params, "states": states,
            "jbcs": j_plume_bcs(js, RGB, u_scale=0.6, rad=0.15),
            "tbcs": tsim.create_plume_bcs(ts, RGB, u_scale=0.6, rad=0.15),
            "tmodel": FluidNet(tm, device=DEV).load_jax_params(params)}


def _jmodel(jm):
    return lambda pr, pp, uu, ff, **kw: apply_model(pr, jm, pp, uu, ff, **kw)


def _assert_state_close(ts, js, what):
    for name in ("u", "p", "density"):
        assert_close(getattr(ts, name), getattr(js, name), RTOL, ATOL,
                     f"{what}: {name}")


def _steps(case, proj, strength, n, vort=0.0):
    jm, tm = case["jm"].replace(**PROJ[proj]), case["tm"].replace(
        **PROJ[proj])
    net = proj == "convnet"
    js, ts = case["states"][strength]
    consts = tsim.FlagConsts()
    for step in range(n):
        js = j_simulate(js, jm, _jmodel(jm) if net else None,
                        case["params"] if net else None, case["jbcs"],
                        dt=jnp.asarray(0.1, jnp.float32),
                        buoyancy_scale=jnp.asarray(1.0, jnp.float32),
                        vorticity_amp=jnp.asarray(vort, jnp.float32))
        ts = tsim.simulate(ts, tm, case["tmodel"] if net else None,
                           case["tbcs"], dt=0.1, buoyancy_scale=1.0,
                           vorticity_amp=vort, consts=consts)
        assert torch.isfinite(ts.u).all()
        _assert_state_close(ts, js, f"{proj} {strength} step {step + 1}")
    # The windows taken: the free space is cached per window + 1.
    return {max_d - 1 for max_d in consts.free_space}


@pytest.mark.parametrize("proj,strength", [("convnet", "strong"),
                                           ("jacobi34", "calm"),
                                           ("pcg", "strong")])
def test_simulate_2d_step(case, proj, strength):
    """One step of each projection; the calm state takes window 1, the
    strong one window 2."""
    windows = _steps(case, proj, strength, 1)
    assert windows == ({1} if strength == "calm" else {2})


def test_simulate_2d_vorticity(case):
    """A vorticity amp > 0: the 2-D confinement (XLA form) runs."""
    _steps(case, "convnet", "calm", 1, vort=2.0)


def test_rollout_2d_three_steps(case):
    """rollout with the m2d mconf's own scales (buoyancy 1 from the
    knobs, no overrides) against JAX's scanned rollout."""
    jm, tm = case["jm"], case["tm"]
    js, ts = case["states"]["calm"]
    jout, jframes = j_rollout(js, jm, 3, _jmodel(jm), case["params"],
                              case["jbcs"], save_every=1)
    tout, tframes = tsim.rollout(ts, tm, 3, case["tmodel"], case["tbcs"],
                                 save_every=1)
    _assert_state_close(tout, jout, "rollout")
    assert tuple(tframes.shape) == (3, 1, 3, 1, N, N)
    assert_close(tframes, jframes, RTOL, ATOL, "density frames")


# --- the demo server -----------------------------------------------------

def _frames(sim, n):
    for _ in range(n):
        sim.advance()


def test_validate_toggle_matches_jax():
    cases = [("sim_method", "jacobi"), ("advection", "euler"),
             ("dt", "half"), ("buoyancy", "cycle"), ("plume", "toggle"),
             ("max_iter", "12"), ("vorticity", "x"), ("bogus", "1"),
             ("dt", "")]
    for k, v in cases:
        outcome = []
        for fn in (j_serve.validate_toggle, serve.validate_toggle):
            try:
                fn(k, v)
                outcome.append("ok")
            except ValueError:
                outcome.append("bad")
        assert outcome[0] == outcome[1], (k, v, outcome)
    # The string fields take only values a step can run (the JAX server
    # accepts any string and its sim thread then stops).
    for k, v in (("sim_method", "bogus"), ("advection", "rk4")):
        j_serve.validate_toggle(k, v)
        with pytest.raises(ValueError):
            serve.validate_toggle(k, v)


def test_demosim_matches_jax():
    """The same interactions through JAX's DemoSim and the port's: a
    splat and the dt / buoyancy / plume toggles, jacobi at 24^2."""
    jsim = j_serve.DemoSim(res=N, sim_method="jacobi", max_iter=4,
                           target_fps=1000.0)
    tsim_ = serve.DemoSim(res=N, sim_method="jacobi", max_iter=4,
                          target_fps=1000.0, device=DEV)
    script = [[], [("splat", {"x": 0.4, "y": 0.6, "fx": 0.1, "fy": -0.05})],
              [("toggle", {"k": "dt", "v": "half"}),
               ("toggle", {"k": "buoyancy", "v": "cycle"})],
              [("toggle", {"k": "plume", "v": "toggle"})]]
    for events in script:
        for kind, payload in events:
            jsim.enqueue(kind, dict(payload))
            tsim_.enqueue(kind, dict(payload))
        with jsim.lock:
            pending, jsim.queue = jsim.queue, []
        for kind, payload in pending:
            jsim._apply(kind, payload)
        m = jsim.mconf
        jsim.state = jsim.step(jsim.state, jsim.params, jsim.bcs,
                               jnp.asarray(m.dt),
                               jnp.asarray(m.buoyancy_scale),
                               jnp.asarray(m.vorticity_confinement_amp))
        tsim_.advance()
    for name in ("u", "p", "density"):
        assert_close(getattr(tsim_.state, name), getattr(jsim.state, name),
                     RTOL, ATOL, name)
    assert tsim_.stats() == {**jsim.stats(), "frame": 4, "fps":
                             tsim_.stats()["fps"]}


def test_demosim_splat_and_toggles():
    sim = serve.DemoSim(res=N, model=M2D, target_fps=1000.0, device=DEV)
    assert sim.mconf.sim_method == "convnet"
    _frames(sim, 2)
    u0 = np_(sim.state.u).copy()
    sim.enqueue("splat", {"x": 0.5, "y": 0.5, "fx": 0.2, "fy": -0.1})
    _frames(sim, 1)
    assert not np.allclose(np_(sim.state.u), u0)
    for k, v in (("dt", "half"), ("buoyancy", "cycle"), ("plume", "toggle"),
                 ("sim_method", "pcg"), ("advection", "euler")):
        sim.enqueue("toggle", {"k": k, "v": v})
    sim.enqueue("toggle", {"k": "dt", "v": "nonsense"})   # logged, ignored
    _frames(sim, 1)
    m = sim.mconf
    assert (m.dt, m.buoyancy_scale, m.sim_method, m.advection_method) == \
        (0.05, 2.0, "pcg", "euler")
    assert sim.plume is False and sim.bcs is None
    assert sim.stats()["frame"] == 4
    assert torch.isfinite(sim.state.u).all()


def _png_size(data):
    """(width, height) of a PNG, checking its chunks' CRCs with zlib."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, size = 8, None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        assert zlib.crc32(tag + body) & 0xffffffff == crc
        if tag == b"IHDR":
            size = (int.from_bytes(body[:4], "big"),
                    int.from_bytes(body[4:8], "big"))
        pos += 12 + n
    return size


def test_http_endpoints():
    sim = serve.DemoSim(res=N, sim_method="jacobi", max_iter=4,
                        target_fps=1000.0, device=DEV)
    _frames(sim, 1)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(sim))
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(base + "/").read().decode()
        assert "fluidnet_tpu_torch" in page and "/frame.png" in page
        png = urllib.request.urlopen(base + "/frame.png").read()
        assert _png_size(png) == (N, N)
        stats = json.loads(urllib.request.urlopen(base + "/stats").read())
        assert stats["res"] == N and stats["frame"] == 1
        for path in ("/splat?x=0.5&y=0.5&fx=0.1&fy=0.1",
                     "/toggle?k=vorticity&v=cycle"):
            req = urllib.request.Request(base + path, method="POST")
            assert urllib.request.urlopen(req).status == 200
        assert len(sim.queue) == 2
        for path in ("/splat?x=bad", "/toggle?k=bogus&v=1"):
            req = urllib.request.Request(base + path, method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()


# --- the headless demo ---------------------------------------------------

def test_demo2d_helpers_match_jax():
    spec = "2:sim_method=jacobi,dt=0.05;4:plume=0,vorticity=2;6:advection=euler"
    assert demo2d.parse_toggle_script(spec) == \
        j_demo2d.parse_toggle_script(spec)
    rng = np.random.default_rng(81)
    d = rng.random((3, 8, 9)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(demo2d.density_to_rgb(d),
                                  j_demo2d.density_to_rgb(d))
    u = rng.standard_normal((1, 2, 1, 8, 9)).astype(np.float32)
    jst = j_demo2d.sphere_force_splat(
        JFluidState(u=jnp.asarray(u), p=None, flags=None), (3.5, 4.0),
        (0.3, -0.2), 2.5)
    tst = demo2d.sphere_force_splat(
        FluidState(u=tt(u), p=None, flags=None), (3.5, 4.0), (0.3, -0.2),
        2.5)
    assert_close(tst.u, jst.u, 0, 0, "splat")


def test_demo2d_run(tmp_path):
    args = SimpleNamespace(
        res=N, frames=6, save_every=2, dt=0.1, vorticity=0.0, max_iter=4,
        sim_method="jacobi", model="", splats=False, draw_velocity=False,
        out_dir=str(tmp_path), device="cpu",
        script="2:advection=maccormack;4:sim_method=convnet,plume=0")
    fps = demo2d.run(args)
    assert fps > 0
    pngs = sorted(p.name for p in tmp_path.iterdir())
    assert pngs == ["frame_00000.png", "frame_00002.png", "frame_00004.png"]
    assert _png_size((tmp_path / pngs[-1]).read_bytes()) == (N, N)
