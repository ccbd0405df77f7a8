"""One rollout step captured as a chain of CUDA graphs, and its replay.

sim/simulate.rollout replays its steps from a `Chain` where the step makes
no host read and records no autograd (simulate.graph_eligible). The
capture runs the step once on the chain's input buffers, on a side
stream, and cuts it into segments wherever a layer span
(utils/profiler.span) opens or closes: sim.advect, sim.forces,
sim.project and sim.step's own pieces between them each become graphs of
their own, captured in order from one memory pool, and a last segment,
after sim.step, copies the step's result back into the input buffers. A
segment that captured nothing is not replayed (but kept: the pool lives
while a graph captured into it does). Each segment reads the tensors the
segments before it left, which stay allocated in the pool.

A replay walks the same spans and replays each segment inside the span
the eager step opens there, so the span recorder and the profiler put
its device time on the same layers as an eager step's: n steps are n
replays of the chain, the host only launching graphs. The launch counter
(ops/cuda/_build.launches) counts a replay as the eager step it replays:
what the capture counted is taken back, and added again at each replay;
so does the count of the model's forwards (utils/profiler.trunk_forwards).

The graphs read everything by address: the input buffers, the flags, the
boundary masks, the free space kept in simulate.FlagConsts and the
model's parameters, so an in-place update of the weights shows in the
next replay. Values go in and out through `load` and `result`; what
`result` returns never aliases the chain's memory.
"""

import collections
import contextlib
import warnings

import torch

from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.ops.cuda import _build
from fluidnet_tpu_torch.utils import profiler

_EMPTY = "CUDA Graph is empty"    # torch's warning at an empty capture


class Chain:
    """The step `step` (FluidState -> FluidState) captured on buffers
    shaped as `state`'s fields; `key` is what it was captured for and
    `holds` what its graphs read by address besides (kept alive here)."""

    def __init__(self, key, state, step, holds):
        self.key, self.holds = key, holds
        self.flags = state.flags
        self.fields = [f for f in ("u", "p", "density")
                       if getattr(state, f) is not None]
        self.bufs = {f: torch.empty_like(getattr(state, f))
                     for f in self.fields}
        self.graphs = []    # all captured: the pool lives while one does
        self.program, self.launches = self._capture(step)

    def _capture(self, step):
        """(the program: the graphs that captured work and (span name,
        entering) marks, in order; the K1-K7 launches of one step)."""
        dev = self.flags.device
        pool = torch.cuda.graph_pool_handle()
        counted = collections.Counter(_build.launches)
        forwards = collections.Counter(profiler.trunk_forwards)
        program = []

        def begin():
            self.graphs.append(torch.cuda.CUDAGraph())
            self.graphs[-1].capture_begin(pool=pool)

        def end():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                self.graphs[-1].capture_end()
            empty = False
            for w in caught:
                if _EMPTY in str(w.message):
                    empty = True
                else:
                    warnings.warn_explicit(w.message, w.category,
                                           w.filename, w.lineno)
            if not empty:
                program.append(self.graphs[-1])

        def cut(name, entering):
            end()
            program.append((name, entering))
            begin()

        torch.cuda.synchronize(dev)
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            begin()
            try:
                with profiler.cutting(cut):
                    out = step(FluidState(flags=self.flags, **self.bufs))
                for f in self.fields:
                    self.bufs[f].copy_(getattr(out, f))
            except BaseException:
                # End the stream's capture; the step's own error is the
                # one to see.
                with contextlib.suppress(Exception):
                    self.graphs[-1].capture_end()
                raise
            end()
        launches = _build.launches - counted
        _build.launches.clear()
        _build.launches.update(counted)
        self.forwards = profiler.trunk_forwards - forwards
        profiler.trunk_forwards.clear()
        profiler.trunk_forwards.update(forwards)
        return program, launches

    def load(self, state):
        """Copies the state's fields into the input buffers."""
        for f in self.fields:
            self.bufs[f].copy_(getattr(state, f))

    def replay(self):
        """One step: the segments in order, each inside its spans."""
        opened = []
        for item in self.program:
            if isinstance(item, torch.cuda.CUDAGraph):
                item.replay()
            elif item[1]:
                opened.append(profiler.span(item[0]))
                opened[-1].__enter__()
            else:
                opened.pop().__exit__(None, None, None)
        _build.launches.update(self.launches)
        profiler.trunk_forwards.update(self.forwards)

    def result(self, state):
        """`state` with the buffers' fields, copied out."""
        return state.replace(**{f: self.bufs[f].clone()
                                for f in self.fields})
