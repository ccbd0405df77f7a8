"""Timing utilities: startup FPROP profiling and trace capture.

Port of fluidnet_tpu.utils.profiler, the reference's profiling hooks
(SURVEY.md §5.1):
  - the conf.profile startup FPROP timing (fluid_net_train.lua:144-189),
  - wall-clock bracketing with a device fence (tfluids.profilePressure,
    simulate.lua:254-318): torch.cuda.synchronize when the tensors lie on
    the card (PyTorch returns before the card finishes),
  - torch.profiler trace capture for deep dives.
"""

import contextlib
import os
import time

import torch


def _sync(tensors):
    """Waits for the card when any tensor of `tensors` (a tensor or a
    nest of tuples, lists and dicts) lies on it."""
    if isinstance(tensors, torch.Tensor):
        if tensors.is_cuda:
            torch.cuda.synchronize(tensors.device)
    elif isinstance(tensors, dict):
        for t in tensors.values():
            _sync(t)
    elif isinstance(tensors, (tuple, list)):
        for t in tensors:
            _sync(t)


class Timer:
    """Accumulating wall-clock timer with device synchronization."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self, sync_on=None):
        t0 = time.perf_counter()
        yield
        _sync(sync_on)
        self.total += time.perf_counter() - t0
        self.count += 1

    @property
    def mean(self):
        return self.total / max(self.count, 1)


def profile_fprop(fn, args, min_seconds=2.0, warmup=2):
    """Times fn(*args): a first call and `warmup` more, then calls for at
    least min_seconds, the last fenced by the device. Returns seconds/call (the
    reference profiles 10 s at startup and stores mconf.fpropTime,
    fluid_net_train.lua:144-189)."""
    for _ in range(1 + warmup):
        out = fn(*args)
    _sync(out)
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < min_seconds:
        out = fn(*args)
        n += 1
    _sync(out)
    return (time.perf_counter() - t0) / max(n, 1)


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler trace of the block (the CPU, and the card when there
    is one), written to `log_dir`/trace.json (chrome://tracing,
    Perfetto). Yields the profiler, whose key_averages() sum the time by
    kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
