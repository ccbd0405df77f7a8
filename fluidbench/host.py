"""The host side of a run: what the run does to keep its own process
steady, and the clocks that show when the host was not.

contain() is called once set-up is done, before the window: torch's
intra-op pool drops to one thread (the loop's few host tensors need no
more, and idle pool threads spin on the cores the main thread needs),
the main thread is pinned to one fixed core (the last one the process
may use; threads made before, such as the CUDA driver's, keep every
core), and the garbage that set-up left is collected and set-up's
objects are frozen out of later collections.

Clocks read, around the window: the host clock, the main thread's CPU
clock, the process's CPU clock, the machine's steal time (/proc/stat,
the time the hypervisor gave this machine's cores to others), and the
main thread's involuntary context switches; and, before and after the
window, the host clock's time for a fixed loop of Python on the pinned
core (probe_ms, the best of a few), which reads how fast the host's core
ran. A window whose main thread was switched out, that saw steal, or
whose probe read slow, ran on a host that was taken from it or slowed.
"""

import gc
import os
import time


def contain():
    """Pins the main thread; returns the core."""
    import torch
    torch.set_num_threads(1)
    core = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core})
    gc.collect()
    gc.freeze()
    return core


def _steal_s():
    """The machine's steal time so far, in seconds (0 where /proc/stat
    gives none)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def _switches():
    """The calling thread's involuntary context switches so far."""
    try:
        with open("/proc/thread-self/status") as f:
            for line in f:
                if line.startswith("nonvoluntary_ctxt_switches"):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return 0


def probe_ms(reps=5, n=100_000):
    """The best of `reps` host-clock timings of a fixed loop, in ms."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        acc = 0
        for i in range(n):
            acc += i * i
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def clocks():
    """The clocks at the window's start, and the probe before it."""
    return {"probe_ms_before": probe_ms(), **_clocks()}


def _clocks():
    return {"wall_s": time.perf_counter(), "main_cpu_s": time.thread_time(),
            "process_cpu_s": time.process_time(), "steal_s": _steal_s(),
            "switches": _switches()}


def since(start):
    """What the clocks read since `start` (clocks()), with the share of
    the host clock in which the main thread ran."""
    end = _clocks()
    out = {k: end[k] - start[k] for k in end}
    out["main_share"] = out["main_cpu_s"] / out["wall_s"]
    out["probe_ms_before"] = start["probe_ms_before"]
    out["probe_ms_after"] = probe_ms()
    return out
