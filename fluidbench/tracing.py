"""The traced stretch of a --trace 1 run, reduced to what the per-layer
metrics read.

A stretch is a fixed amount of the window's own work run twice in a row:
first without the profiler, timed by the host clock and by the
process's CPU clock (time.process_time), then under torch.profiler (CPU
and CUDA activity), inside a span "fluidbench.stretch" that ends after a
device synchronize. The trace is exported to a temporary file under
TMPDIR, read back and deleted. From it: every device activity (kernels,
copies, fills) inside the span; the union of their intervals, which is
the device's busy time; the idle gaps between them, each labelled by the
innermost host span (a torch operator, a CUDA runtime call or one of the
benchmark's own spans) open at its middle, "(Python, no operator)" where
none is.
"""

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LABEL_CATS = HOST_CATS + ("cuda_runtime", "cuda_driver")
SPAN = "fluidbench.stretch"
NAME_CHARS = 120          # a kernel's name as the breakdown gives it


class Stretch:
    """What the per-layer metrics read (metrics/<name>.py's read(s)).

    kind: the mix's kind ("rollout" or "train"); steps and frames: the
    work of one stretch; horizons: the horizon of each train step;
    cells: the cells of one step's batch; batch; config (the
    configuration's file as a dict); peaks (peaks.json); slab_cells: the
    inflow slab's cells; plain_wall_s and host_cpu_s: the unprofiled
    stretch's host-clock and process CPU seconds; window_s: the
    traced stretch's host-clock seconds; kernels: [(name, seconds)] of
    the device kernels; copies: [(name, seconds)] of the device's copies
    and fills; busy_s: the union of the device's intervals."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def kernel_s(self, match):
        return sum(d for n, d in self.kernels if match(n))

    def kernel_count(self):
        return len(self.kernels)


def profile(fn):
    """Runs fn() under torch.profiler in the span SPAN, ending with a
    device synchronize; returns the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        with record_function(SPAN):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="fluidbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return events


def _merge(intervals):
    """The union of [start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events):
    """(kernels [(name, s)], copies [(name, s)], busy_s, window_s,
    gaps {host span: s}) of the events inside the span SPAN (times in
    the trace are microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("name") == SPAN and
             e.get("cat") in HOST_CATS]
    if not spans:
        raise RuntimeError(f"the trace holds no span {SPAN}")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    kernels, copies, intervals = [], [], []
    for e in xs:
        cat = e.get("cat")
        if cat not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d < lo or s > hi:
            continue
        (kernels if cat == "kernel" else copies).append(
            (e["name"], d * 1e-6))
        intervals.append((max(s, lo), min(s + d, hi)))
    merged = _merge(intervals)
    busy = sum(e - s for s, e in merged)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs
                  if e.get("cat") in LABEL_CATS and e.get("name") != SPAN)
    starts = [h[0] for h in host]
    gaps = collections.Counter()
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        gaps[_label(host, starts, (a + b) / 2)] += (b - a) * 1e-6
    return kernels, copies, busy * 1e-6, (hi - lo) * 1e-6, gaps


def _label(host, starts, t, look_back=4000):
    """The name of the innermost (shortest) host span open at time t."""
    i = bisect.bisect_right(starts, t)
    best = None
    for s, e, name in host[max(0, i - look_back):i]:
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "(Python, no operator)"


def breakdown(kernels, gaps, top=10):
    """The trace's breakdown: the device operations that took most time
    (summed by name) and the idle time by what the host was doing."""
    ops = collections.Counter()
    for name, d in kernels:
        ops[name[:NAME_CHARS]] += d
    return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
