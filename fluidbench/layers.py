"""The program's layer spans in a --trace 1 run, reduced to what the
per-layer metrics *_host_ms, *_device_ms and *_idle_ms read.

The port marks its layers with spans (fluidnet_tpu_torch/utils/
profiler.py: `span`, recorded only inside `recording()`): a rollout step
is sim.step around sim.advect, sim.forces and sim.project; a train step
is train.step around train.loss, train.backward and train.update. Once
the driver's stretch is done (its unprofiled and profiled passes as they
were), the same work runs again:

- pass A, unprofiled: each layer's host self time on the host clock,
  from the recorded spans of the main thread (a span's duration minus
  what the layer spans nested in it cover); the same work runs once
  before it with the recorder off, which times what the recorder costs;
- pass B, under tracing.profile, where each span is also a user
  annotation of the trace: each kernel, copy and fill is put down to the
  innermost layer span open on the main thread when it was launched (the
  CUDA runtime or driver call with its correlation id, on whatever
  thread: the backward launches from the autograd engine's), and each
  idle gap (tracing.reduce's) to the innermost layer span open on the
  main thread at its middle; what falls outside every layer span goes to
  "(no program span)".

A rollout's layers are sim.step's own time and its three children; a
train step's train.step's own time and its three children. The rollout
driver's compared frames (kept, seen, the picker's state) are left as
the stretch left them, so the checks read the frames they read before.

run.drive hands a reader the stretch alone, so `of` finds the driver on
the call stack: the local of a caller's frame that has `stretch` and a
`cell` of the stretch's kind (run.drive's `run`). With no such driver,
or a program without the recorder, every metric here reads None.
"""

import bisect
import collections
import contextlib
import sys
import threading
import time

from fluidbench import tracing
from fluidbench.kernels import convolutions, k1, k2

NONE = "(no program span)"
# A kind's layer spans, the step's own span first.
LAYERS = {"rollout": ("sim.step", "sim.advect", "sim.forces", "sim.project"),
          "train": ("train.step", "train.loss", "train.backward",
                    "train.update")}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# Device time of a layer holds at least that of the kernels it launches
# (name-based groups, fluidbench/kernels/): printed as a check.
LOWER = {"rollout": (("sim.advect", "K1", k1.matches),
                     ("sim.forces", "K2", k2.matches),
                     ("sim.project", "convs", convolutions.matches))}


def read(s, what, name):
    """s.layers[what][name] (ms a step), None where the stretch is of
    another kind or has no layers."""
    if name not in LAYERS.get(s.kind, ()):
        return None
    got = of(s)
    return None if got is None else got[what][name]


def of(s):
    """The stretch's layers, measured at the first call: {"host_ms",
    "device_ms", "idle_ms": {span: ms a step}}, or None."""
    if not hasattr(s, "layers"):
        s.layers = _measure(s, _driver(s, sys._getframe(1)))
    return s.layers


def _driver(s, frame):
    while frame is not None:
        for v in frame.f_locals.values():
            cell = getattr(v, "cell", None)
            if callable(getattr(v, "stretch", None)) and \
                    getattr(cell, "mix", {}).get("kind") == s.kind:
                return v
        frame = frame.f_back
    return None


@contextlib.contextmanager
def _compared_frames_kept(run):
    if not hasattr(run, "kept"):
        yield
        return
    kept, seen, pick = list(run.kept), run.seen, run.pick.getstate()
    try:
        yield
    finally:
        run.kept, run.seen = kept, seen
        run.pick.setstate(pick)


def _work(run, s):
    """The stretch's work: its frames, or its train steps at their
    horizons."""
    if s.kind == "rollout":
        return lambda: [run.frame() for _ in range(s.frames)]
    return lambda: [run.step(n) for n in s.horizons]


def _measure(s, run):
    try:
        from fluidnet_tpu_torch.utils.profiler import recording
    except ImportError:
        return None
    if run is None or s.kind not in LAYERS:
        return None
    names = LAYERS[s.kind]
    work = _work(run, s)
    with _compared_frames_kept(run):
        wall_off = _timed(work, run)
        with recording() as spans:
            wall_a = _timed(work, run)
        with recording():
            events = tracing.profile(work)
    host = host_self_s(spans, names, threading.get_native_id())
    dev = reduce(events, names)
    per = 1e3 / s.steps
    out = {"host_ms": {n: host[n] * per for n in names},
           "device_ms": {n: dev["device_s"][n] * per for n in names},
           "idle_ms": {n: dev["idle_s"][n] * per for n in names}}
    _report(s, names, out, dev, per, (wall_off, wall_a))
    return out


def _timed(work, run):
    """The host-clock seconds of the work, up to its device's end."""
    t0 = time.perf_counter()
    work()
    run._sync()
    return time.perf_counter() - t0


def _fmt(d, keys):
    return ", ".join(f"{k} {d[k]:.4f}" for k in keys)


def _report(s, names, out, dev, per, walls):
    """The stderr lines of the layers: host, device and idle ms a step by
    span, coverage, the idle split's sum, the lower bounds and the cost
    of the passes (pass A's wall against the same work's with the
    recorder off, just before it, and the stretch's plain pass's)."""
    keys = names + (NONE,)
    idle = {k: dev["idle_s"][k] * per for k in keys}
    device = {k: dev["device_s"][k] * per for k in keys}
    total_idle = (dev["window_s"] - dev["busy_s"]) * per
    cover = 100.0 * dev["kernel_in_s"] / dev["kernel_s"] \
        if dev["kernel_s"] > 0 else float("nan")
    lines = [
        f"layers host ms a step (pass A): {_fmt(out['host_ms'], names)}",
        f"layers device ms a step (pass B): {_fmt(device, keys)}; kernel "
        f"time launched inside {names[0]} {cover:.3f}%",
        f"layers idle ms a step by span (pass B): {_fmt(idle, keys)}; sum "
        f"{sum(idle.values()):.6f} against pass B's idle "
        f"{total_idle:.6f}",
        f"layers cost: pass A {walls[1]:.4f} s against {walls[0]:.4f} s "
        f"with the recorder off just before it and the plain pass's "
        f"{s.plain_wall_s:.4f} s; pass B's traced window "
        f"{dev['window_s']:.4f} s against the profiled pass's "
        f"{s.window_s:.4f} s"]
    bounds = []
    for name, group, match in LOWER.get(s.kind, ()):
        k = sum(d for n, d, _ in dev["kernels"] if match(n)) * per
        inside = sum(d for n, d, at in dev["kernels"]
                     if match(n) and at == name) * per
        ok = device[name] >= k * (1 - 1e-9)     # sums in another order
        bounds.append(f"{name} {device[name]:.6f} >= {group} {k:.6f} "
                      f"{'holds' if ok else 'FAILS'} ({group} launched "
                      f"inside {name} {inside:.6f})")
    if bounds:
        lines.append("layers lower bounds (pass B): " + "; ".join(bounds))
    for line in lines:
        print(line, file=sys.stderr, flush=True)


def host_self_s(records, names, tid):
    """{span name: seconds} of the spans named in `names` on thread
    `tid`, each its duration minus what the named spans nearest below it
    cover (spans of other names are passed through to their parents)."""
    by_id = {r.id: r for r in records}
    out = collections.Counter()
    for r in records:
        if r.name not in names or r.tid != tid or r.end_ns is None:
            continue
        d = (r.end_ns - r.start_ns) * 1e-9
        out[r.name] += d
        up = by_id.get(r.parent)
        while up is not None and up.name not in names:
            up = by_id.get(up.parent)
        if up is not None:
            out[up.name] -= d
    return out


def _innermost(spans, starts, t):
    """The name of the innermost span of `spans` (one thread's, nested
    or disjoint, sorted by start and then outer first) open at t."""
    i = bisect.bisect_right(starts, t)
    while i > 0:
        i -= 1
        if spans[i][1] >= t:
            return spans[i][2]
    return NONE


def reduce(events, names):
    """Pass B's trace by layer span: {"device_s": {span: s} of the device
    activities inside tracing.SPAN by their launch, "idle_s": {span: s}
    of tracing.reduce's idle gaps by their middle, "kernels": [(name, s,
    span)], "kernel_s", "kernel_in_s" (kernel time launched inside a
    layer span), "busy_s", "window_s"}. Spans are the user annotations
    named in `names` on the thread that opened tracing.SPAN."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    top = [e for e in xs if e.get("name") == tracing.SPAN and
           e.get("cat") in tracing.HOST_CATS]
    if not top:
        raise RuntimeError(f"the trace holds no span {tracing.SPAN}")
    lo = float(top[0]["ts"])
    hi = lo + float(top[0]["dur"])
    main = top[0].get("tid")
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in xs
                    if e.get("cat") == "user_annotation" and
                    e.get("tid") == main and e.get("name") in names),
                   key=lambda x: (x[0], -x[1]))
    starts = [x[0] for x in spans]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in xs
              if e.get("cat") in LAUNCH_CATS and
              "correlation" in e.get("args", {})}
    device, idle = collections.Counter(), collections.Counter()
    kernels, intervals = [], []
    kernel_s = kernel_in_s = 0.0
    for e in xs:
        if e.get("cat") not in tracing.DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d < lo or s > hi:
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        layer = NONE if t is None else _innermost(spans, starts, t)
        device[layer] += d * 1e-6
        intervals.append((max(s, lo), min(s + d, hi)))
        if e["cat"] == "kernel":
            kernels.append((e["name"], d * 1e-6, layer))
            kernel_s += d * 1e-6
            kernel_in_s += d * 1e-6 if layer != NONE else 0.0
    merged = tracing._merge(intervals)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            idle[_innermost(spans, starts, (a + b) / 2)] += (b - a) * 1e-6
    return {"device_s": device, "idle_s": idle, "kernels": kernels,
            "kernel_s": kernel_s, "kernel_in_s": kernel_in_s,
            "busy_s": sum(b - a for a, b in merged) * 1e-6,
            "window_s": (hi - lo) * 1e-6}
