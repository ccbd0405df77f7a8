"""Interactive realtime 2-D demo, web edition, on the card.

Port of fluidnet_tpu.cli.serve: the reference's LuaGL demo
(torch/fluid_net_2d_demo.lua, keys :203-287, mouse :556-594) as a
zero-dependency HTTP server. The simulation steps continuously on its own
thread; a browser page polls PNG frames, sends mouse drags as force splats
and key presses as runtime toggles.

  python -m fluidnet_tpu_torch.cli.serve --model data/models_bundled/m2d
  # then open http://127.0.0.1:8642/   (--device cpu runs on the CPU)

Endpoints:
  GET  /            the viewer page (canvas + key/mouse handlers)
  GET  /frame.png   latest density frame (polled ~20 Hz by the page)
  GET  /stats       JSON {frame, fps, sim_method, plume, ...}
  POST /splat?x=&y=&fx=&fy=   mouse-drag force splat (normalized coords)
  POST /toggle?k=&v=          runtime toggle (sim_method, advection, dt,
                              plume, buoyancy, gravity, vorticity, max_iter)

The sim thread owns every CUDA tensor: handlers only enqueue interactions,
which it applies between steps. A toggle replaces the mconf; each step
calls sim.simulate.simulate with the current one (nothing is compiled).
"""

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from fluidnet_tpu_torch.cli.demo2d import (TOGGLE_ALIASES, initial_state,
                                           load_model, plume_bcs, png_bytes,
                                           sphere_force_splat, state_rgb)
from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import resolve_device
from fluidnet_tpu_torch.models.fluidnet import random_model
from fluidnet_tpu_torch.ops.advect import METHODS
from fluidnet_tpu_torch.sim.simulate import FlagConsts, simulate

# Toggleable mconf fields (canonical names). Anything else is rejected at
# the HTTP layer with a 400: a bad key or value must never reach the sim
# thread.
_TOGGLE_FIELDS = frozenset((
    "plume", "sim_method", "advection_method", "dt", "max_iter",
    "maccormack_strength", "buoyancy_scale", "gravity_scale",
    "vorticity_confinement_amp", "polish_iters"))
# The values of the string fields. (The JAX server accepts any string
# here, and a bad one stops its sim thread at the next step.)
_STRING_FIELDS = {"sim_method": ("convnet", "jacobi", "pcg"),
                  "advection_method": METHODS}


def validate_toggle(k: str, v: str) -> None:
    """Raises ValueError unless (k, v) is a toggle _apply can execute."""
    k = TOGGLE_ALIASES.get(k, k)
    if k not in _TOGGLE_FIELDS:
        raise ValueError(f"unknown toggle key {k!r}")
    if k in _STRING_FIELDS:
        if v not in _STRING_FIELDS[k]:
            raise ValueError(f"bad {k} {v!r}: one of {_STRING_FIELDS[k]}")
        return
    if k == "plume":
        return
    if v in ("cycle", "half", "double"):
        return
    float(v)  # numeric field: must parse (raises ValueError otherwise)


PAGE = """<!doctype html>
<html><head><title>fluidnet_tpu_torch live demo</title><style>
 body { background:#111; color:#ddd; font:14px monospace; margin:1em; }
 #view { image-rendering:pixelated; width:640px; height:640px;
         border:1px solid #444; cursor:crosshair; }
 #bar { margin:.5em 0; }
 kbd { background:#333; padding:1px 5px; border-radius:3px; }
</style></head><body>
<h3>fluidnet_tpu_torch &mdash; interactive 2-D plume</h3>
<div id="bar">loading&hellip;</div>
<img id="view" src="/frame.png">
<p>drag: force splat &nbsp; <kbd>c</kbd> convnet <kbd>j</kbd> jacobi
 <kbd>g</kbd> pcg &nbsp; <kbd>p</kbd> plume on/off &nbsp;
 <kbd>b</kbd> buoyancy <kbd>v</kbd> vorticity (cycle) &nbsp;
 <kbd>[</kbd>/<kbd>]</kbd> dt &divide;/&times;2</p>
<script>
const img = document.getElementById('view'), bar = document.getElementById('bar');
let t = 0;
setInterval(() => { img.src = '/frame.png?t=' + (t++); }, 50);
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  bar.textContent = `frame ${s.frame}  ${s.fps.toFixed(1)} fps  ` +
    `solver=${s.sim_method}  plume=${s.plume}  buoyancy=${s.buoyancy}  ` +
    `vorticity=${s.vorticity}  dt=${s.dt}`;
}, 500);
let drag = null;
img.onmousedown = e => { drag = [e.offsetX, e.offsetY]; };
window.onmouseup = () => { drag = null; };
img.onmousemove = e => {
  if (!drag) return;
  const r = img.getBoundingClientRect();
  const x = e.offsetX / r.width, y = e.offsetY / r.height;
  const fx = (e.offsetX - drag[0]) / r.width, fy = (e.offsetY - drag[1]) / r.height;
  drag = [e.offsetX, e.offsetY];
  if (fx || fy) fetch(`/splat?x=${x}&y=${y}&fx=${fx}&fy=${fy}`, {method:'POST'});
};
const KEYS = {c:['sim_method','convnet'], j:['sim_method','jacobi'],
              g:['sim_method','pcg'], p:['plume','toggle'],
              b:['buoyancy','cycle'], v:['vorticity','cycle'],
              '[':['dt','half'], ']':['dt','double']};
window.onkeydown = e => {
  const kv = KEYS[e.key];
  if (kv) fetch(`/toggle?k=${kv[0]}&v=${kv[1]}`, {method:'POST'});
};
</script></body></html>"""


class DemoSim:
    """Owns the simulation state and steps it (advance(), or loop() on its
    own thread). HTTP handlers enqueue interactions and read the latest
    encoded frame under a lock. Without `model`, the ConvNet is a random
    init drawn from a torch.Generator seeded 0."""

    def __init__(self, res=128, model="", sim_method="convnet", dt=0.1,
                 max_iter=34, target_fps=30.0, device=None):
        self.res = res
        self.device = resolve_device(device)
        self.target_dt = 1.0 / target_fps
        if model:
            mconf, self.model = load_model(model, self.device)
        else:
            mconf = ModelConfig(is_3d=False)
            self.model = random_model(mconf, 0, self.device)
        self.mconf = mconf.replace(
            sim_method=sim_method, dt=dt, buoyancy_scale=1.0,
            vorticity_confinement_amp=0.0, advection_method="maccormackOurs",
            max_iter=max_iter)
        self.state = initial_state(res, self.device)
        self.consts = FlagConsts()     # the flags never change
        self.plume = True
        self.bcs = plume_bcs(self.state)
        self.lock = threading.Lock()
        self.queue = []                # pending (kind, payload) interactions
        self.frame_png = png_bytes(state_rgb(self.state), 3)
        self.frame_i = 0
        self.fps = 0.0
        self.running = True
        self._t_prev = time.perf_counter()

    # -- handler side ------------------------------------------------------
    def enqueue(self, kind, payload):
        with self.lock:
            self.queue.append((kind, payload))

    def stats(self):
        m = self.mconf
        return {"frame": self.frame_i, "fps": round(self.fps, 2),
                "sim_method": m.sim_method, "plume": self.plume,
                "buoyancy": m.buoyancy_scale,
                "vorticity": m.vorticity_confinement_amp,
                "dt": m.dt, "res": self.res}

    # -- sim side ----------------------------------------------------------
    def _apply(self, kind, p):
        if kind == "splat":
            # Normalized page coords -> grid (page y is down, grid y up).
            cy = (1.0 - p["y"]) * (self.res - 1)
            cx = p["x"] * (self.res - 1)
            f = (-p["fy"] * self.res, p["fx"] * self.res)
            self.state = sphere_force_splat(
                self.state, (cy, cx), f, radius=self.res / 10)
            return
        k, v = TOGGLE_ALIASES.get(p["k"], p["k"]), p["v"]
        if k == "plume":
            self.plume = (not self.plume) if v == "toggle" else \
                v in ("1", "on", "true")
            self.bcs = plume_bcs(self.state) if self.plume else None
            return
        m = self.mconf
        if v == "cycle":                       # 0 -> 1 -> 2 -> 4 -> 0 ...
            cur = getattr(m, k)
            v = 0.0 if cur >= 4 else (1.0 if cur == 0 else cur * 2)
        elif v == "half":
            v = getattr(m, k) / 2
        elif v == "double":
            v = getattr(m, k) * 2
        elif isinstance(getattr(m, k), (int, float)):
            v = type(getattr(m, k))(float(v))
        self.mconf = m.replace(**{k: v})

    def advance(self):
        """Applies the pending interactions, runs one step and publishes
        its frame."""
        with self.lock:
            pending, self.queue = self.queue, []
        for kind, payload in pending:
            # Defense in depth behind validate_toggle: the sim thread
            # must survive any bad interaction (log and keep running).
            try:
                self._apply(kind, payload)
            except Exception as e:
                print(f"serve: ignoring bad {kind} {payload}: {e}",
                      file=sys.stderr)
        m = self.mconf
        self.state = simulate(
            self.state, m, self.model if m.sim_method == "convnet" else None,
            self.bcs, dt=m.dt, buoyancy_scale=m.buoyancy_scale,
            vorticity_amp=m.vorticity_confinement_amp, consts=self.consts)
        png = png_bytes(state_rgb(self.state), 3)
        now = time.perf_counter()
        with self.lock:
            self.frame_png = png
            self.frame_i += 1
            self.fps = 0.9 * self.fps + 0.1 / max(now - self._t_prev, 1e-6)
        self._t_prev = now
        return now

    def loop(self):
        deadline = time.perf_counter()
        while self.running:
            now = self.advance()
            # Deadline throttle (per-frame sleep arithmetic would alternate
            # 0 / 2x when the step is faster than the target).
            deadline = max(deadline + self.target_dt, now - self.target_dt)
            if deadline > now:
                time.sleep(deadline - now)


def make_handler(sim: DemoSim):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/":
                self._send(200, "text/html", PAGE.encode())
            elif path == "/frame.png":
                with sim.lock:
                    png = sim.frame_png
                self._send(200, "image/png", png)
            elif path == "/stats":
                self._send(200, "application/json",
                           json.dumps(sim.stats()).encode())
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                if u.path == "/splat":
                    sim.enqueue("splat", {k: float(q[k])
                                          for k in ("x", "y", "fx", "fy")})
                elif u.path == "/toggle":
                    validate_toggle(q["k"], q["v"])
                    sim.enqueue("toggle", {"k": q["k"], "v": q["v"]})
                else:
                    return self._send(404, "text/plain", b"not found")
            except (KeyError, ValueError) as e:
                return self._send(400, "text/plain", str(e).encode())
            self._send(200, "application/json", b"{}")

        def log_message(self, *a):   # quiet
            pass

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--max_iter", type=int, default=34)
    ap.add_argument("--target_fps", type=float, default=30.0)
    ap.add_argument("--sim_method", default="convnet",
                    choices=["convnet", "jacobi", "pcg"])
    ap.add_argument("--model", default="",
                    help="trained 2-D checkpoint dir (else random init)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    sim = DemoSim(res=args.res, model=args.model,
                  sim_method=args.sim_method, dt=args.dt,
                  max_iter=args.max_iter, target_fps=args.target_fps,
                  device=args.device)
    thread = threading.Thread(target=sim.loop, daemon=True)
    thread.start()
    srv = ThreadingHTTPServer((args.host, args.port), make_handler(sim))
    print(f"serving on http://{args.host}:{srv.server_address[1]}/ "
          f"({args.res}^2, {sim.mconf.sim_method}, {sim.device})", flush=True)
    try:
        srv.serve_forever()
    finally:
        sim.running = False
        thread.join()
        srv.server_close()


if __name__ == "__main__":
    main()
