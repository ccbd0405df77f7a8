"""The rollout driver ("kind": "rollout"): cli/sim3d.run's loop on the
port.

Set-up builds the configuration's projection (projections/<name>.py:
the port's FluidNet with the checkpoint's weights or the seed's, under
sim3d's scene knobs over the configuration's mconf), the mix's scene and
its inflow (scenes/<name>.py), and the flags' constants (FlagConsts,
kept across frames as sim3d keeps them), then runs the warm-up frames. A
frame is `steps_per_frame` steps of sim.simulate.rollout and the copy of
its density to host memory, as sim3d writes a .vbox frame; the window
runs frames back to back, one client in a closed loop. Frames are
compared with the reference once the window has closed: the first one
(from the scene as the benchmark made it), and `compared_frames` - 1
frames of the window (or the traced stretch) drawn from the seed by
reservoir sampling, each from the program's own state at its start,
which the run keeps.
"""

import random
import sys
import time

import numpy as np
import torch

from fluidnet_tpu_torch.core.config import from_dict
from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.sim.simulate import Boundaries, FlagConsts, rollout

from fluidbench import checks, spec, tracing
from fluidbench.reference import step as ref_step


class Frame:
    """One frame as the window produced it: the state it started from,
    the state it ended at, the density copied to host memory."""

    def __init__(self, start, end, host, index):
        self.start, self.end, self.host = start, end, host
        self.index = index


class Driver:
    """A rollout cell's run on `device` (the chip; the CPU in tests)."""

    def __init__(self, cell, seed, device):
        config, mix = cell.config, cell.mix
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.mconf_dict = {**config["mconf"], **mix["knobs"]}
        self.mconf = from_dict(self.mconf_dict)
        self.proj = spec.projection(config)
        self.weights = self.proj.weights(config, seed, self.dev,
                                         training=False)
        self.model = self.proj.program(self.mconf, self.weights, self.dev)
        self.scene = spec.scene(mix).make(mix, seed, self.dev)
        sc = self.scene
        self.state = FluidState(u=sc["u"].clone(), p=sc["p"].clone(),
                                flags=sc["flags"].clone(),
                                density=sc["density"].clone())
        (ub, ui), (db, di) = sc["bcs"]["u"], sc["bcs"]["density"]
        self.bcs = Boundaries(u_bc=ub.clone(), u_bc_inv_mask=ui.clone(),
                              density_bc=db.clone(),
                              density_bc_inv_mask=di.clone())
        self.consts = FlagConsts()
        self.k = mix["steps_per_frame"]
        self.keep = mix["compared_frames"] - 1
        self.pick = random.Random(seed)
        self.seen = 0
        self.first = None
        self.kept = []

    def step_frame(self, state):
        """The timed path: one frame's steps."""
        return rollout(state, self.mconf, self.k, self.model, self.bcs,
                       consts=self.consts)

    def frame(self):
        """One frame, its density in host memory; returns its seconds."""
        t0 = time.perf_counter()
        end = self.step_frame(self.state)
        host = end.density.cpu().numpy()
        dt = time.perf_counter() - t0
        item = Frame(self.state, end, host, self.seen)
        if self.first is None:
            item.start = FluidState(u=self.scene["u"], p=self.scene["p"],
                                    flags=self.scene["flags"],
                                    density=self.scene["density"])
            self.first = item
        else:
            self.seen += 1
            if len(self.kept) < self.keep:
                self.kept.append(item)
            else:
                j = self.pick.randrange(self.seen)
                if j < self.keep:
                    self.kept[j] = item
        self.state = end
        return dt

    def setup(self):
        for _ in range(self.cell.mix["warmup_steps"] // self.k):
            self.frame()
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds):
        """Frames until `seconds` have passed: (end-to-end metrics,
        attempted)."""
        self.kept, self.seen = [], 0
        times = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            times.append(self.frame())
        elapsed = time.perf_counter() - t0
        ms = np.asarray(times) * 1e3
        slow = np.flatnonzero(ms > 1.5 * np.median(ms))
        print(f"frames {len(ms)}: ms p50 {np.percentile(ms, 50):.3f} p90 "
              f"{np.percentile(ms, 90):.3f} p95 {np.percentile(ms, 95):.3f} "
              f"p99 {np.percentile(ms, 99):.3f} max {ms.max():.3f}; "
              f"{len(slow)} over 1.5x the median, at {slow[:40].tolist()}",
              file=sys.stderr, flush=True)
        return {"steps_per_s": self.k * len(times) / elapsed,
                "frame_ms_p95": float(np.percentile(ms, 95))}, len(times)

    def stretch(self):
        """The traced run's stretch: plain_repeats x trace_frames frames
        unprofiled (the host's clocks), then trace_frames frames under the
        profiler. Returns (tracing.Stretch, idle gaps, attempted)."""
        n, rep = self.cell.mix["trace_frames"], self.cell.mix["plain_repeats"]
        self.kept, self.seen = [], 0
        c0, t0 = time.process_time(), time.perf_counter()
        for _ in range(rep * n):
            self.frame()
        self._sync()
        plain = (time.perf_counter() - t0) / rep
        cpu = (time.process_time() - c0) / rep

        def run():
            for _ in range(n):
                self.frame()
        events = tracing.profile(run)
        kernels, copies, busy, window_s, gaps = tracing.reduce(events)
        u = self.scene["u"]
        b = u.shape[0]
        cells = u[0, 0].numel()
        stretch = tracing.Stretch(
            kind="rollout", steps=n * self.k, frames=n, horizons=[],
            cells=b * cells, cells_per_sample=cells, batch=b,
            config=self.cell.config, peaks=None, plain_wall_s=plain,
            host_cpu_s=cpu, window_s=window_s, kernels=kernels,
            copies=copies, busy_s=busy,
            slab_cells=self.scene["bcs"]["u"][0][:, 0].numel())
        return stretch, gaps, (rep + 1) * n

    def readings(self, control=False, detail=None):
        """The worst gaps over the compared frames; with `control` the
        reference at the lower precision stands in the program's place.
        `detail`, a list, gets each frame's index, largest |u| and gaps."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ns = ref_step.namespace(self.mconf_dict)
        layers = self.cell.config.get("layers")
        bcs = self.scene["bcs"]
        flags = self.scene["flags"]
        precision, lower = self.proj.precisions(self.cell.config)
        out = []
        for fr in [self.first] + self.kept:
            s = fr.start
            ref = ref_step.frame(self.weights, ns, layers, s.u, s.p,
                                 s.density, flags, bcs, self.k, precision,
                                 self.proj.reference)
            if control:
                prog = ref_step.frame(self.weights, ns, layers, s.u, s.p,
                                      s.density, flags, bcs, self.k, lower,
                                      self.proj.reference)
            else:
                prog = (fr.end.u, fr.end.p, fr.end.density)
            r = checks.frame_gaps(prog, ref)
            dev_density = prog[2].cpu().numpy()
            host = fr.host if not control else dev_density
            r["copy"] = float(np.max(np.abs(host - dev_density))) \
                if np.isfinite(host).all() else float("nan")
            out.append(r)
            if detail is not None:
                detail.append(dict(r, frame=fr.index,
                                   u_max=float(ref[0].abs().max())))
        return checks.worst(out)

    def free(self):
        """Drops the program's model and state (the compared frames
        stay)."""
        self.model = self.state = self.consts = None
