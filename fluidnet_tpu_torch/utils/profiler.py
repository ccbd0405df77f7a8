"""Timing utilities: startup FPROP profiling and the span recorder.

Port of fluidnet_tpu.utils.profiler, the reference's profiling hooks
(SURVEY.md §5.1):
  - the conf.profile startup FPROP timing (fluid_net_train.lua:144-189),
    with a device fence (tfluids.profilePressure, simulate.lua:254-318):
    torch.cuda.synchronize when the tensors lie on the card (PyTorch
    returns before the card finishes),
  - named spans around the layers of a step (`span`), recorded only
    inside `recording()`.

The recorder is off unless a caller turns it on: `span(name)` then
returns one shared null context after two module-level checks, records
nothing and calls no torch function, so the program's hot loops carry
their spans at no measurable cost. Inside `with recording() as spans:`
each span appends a `Span` to `spans` (name, id, parent id on its own
thread, native thread id, start and end from time.perf_counter_ns) and,
while a torch profiler is running, also enters
torch.profiler.record_function(name), so the span lands in the trace as
a user annotation on the clock of the device activity. Spans launch
nothing on the device and hold no tensor: autograd, the recompute of
torch.utils.checkpoint and CUDA graph capture see no difference.

While sim/chain.py captures a rollout step as a chain of CUDA graphs
(`cutting(fn)`), each span entered or left on the capturing thread calls
fn(name, entering) instead, and the chain cuts its capture there. How a
rollout's steps ran is counted process-wide in `rollout_steps`, the
model's forwards by the trunk's path in `trunk_forwards`, and the bytes
a rank's exchanges of z-planes send in `exchange_bytes`.
"""

import collections
import contextlib
import itertools
import threading
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


# The list that recording() fills, None while the recorder is off. One
# recorder a process: the spans sit in library code that takes no
# handle, and the off path must cost two global reads.
_records = None
_OFF = contextlib.nullcontext()
_ids = itertools.count()
_open = threading.local()


class Span:
    """One recorded span: `parent` is the id of the span open around it
    on the same thread (None at the top), `tid` the native thread id,
    `start_ns` and `end_ns` time.perf_counter_ns (end None while open)."""

    __slots__ = ("name", "id", "parent", "tid", "start_ns", "end_ns",
                 "_annotation")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        mine = _open.__dict__
        if "stack" not in mine:
            # The native id once a thread: it is a system call, several
            # microseconds on some hosts.
            mine["stack"], mine["tid"] = [], threading.get_native_id()
        stack = mine["stack"]
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.tid = mine["tid"]
        self.end_ns = None
        self._annotation = None
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        stack.append(self)
        _records.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _open.stack.pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        return False


def span(name):
    """A context manager around one layer of the program named `name`
    (the names the benchmark reads: sim.step, sim.advect, sim.forces,
    sim.project, train.step, train.loss, train.backward, train.update;
    inside a banked trunk's forward on the stage path model.bank0,
    model.bank1, ... around each bank's stage between the split and the
    join, and model.join around the join; parallel.exchange around an
    exchange of z-planes between the ranks of a sharded grid)."""
    if _cut is not None and _cut[0] == threading.get_ident():
        return _Cut(name)
    if _records is None:
        return _OFF
    return Span(name)


# Steps of sim/simulate.rollout by how they ran: "replayed" from a chain
# of CUDA graphs, "eager" op by op; "chains" counts the chains captured.
# Totals of the process, never reset by the program.
rollout_steps = collections.Counter()

# Forwards of the model's trunk by path (models/fluidnet.FluidNet.trunk):
# "fast" the fast trunk, "stages" the stage path with one bank, "banked"
# the stage path with banks. A step replayed from a chain counts the
# forwards its capture ran (sim/chain.py). Never reset by the program.
trunk_forwards = collections.Counter()

# Bytes this process sent to other ranks in exchanges of z-planes
# (parallel/halo.py), under "sent". Never reset by the program.
exchange_bytes = collections.Counter()

# (the capturing thread's id, its callback) while a chain is captured.
_cut = None


class _Cut:
    """A span while a chain is captured: its entry and exit call the
    callback of `cutting` (not on the way out of an exception)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _cut[1](self.name, True)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            _cut[1](self.name, False)
        return False


@contextlib.contextmanager
def cutting(fn):
    """For the block, each span entered or left on this thread calls
    fn(name, True) on entry and fn(name, False) on exit, and records
    nothing."""
    global _cut
    outer, _cut = _cut, (threading.get_ident(), fn)
    try:
        yield
    finally:
        _cut = outer


@contextlib.contextmanager
def recording():
    """Turns the recorder on for the block; yields the list of `Span`s,
    in the order they were entered, from every thread."""
    global _records
    outer, _records = _records, []
    try:
        yield _records
    finally:
        _records = outer
