"""The training driver ("kind": "train"): train.train_step back to back,
as cli/train.py's epoch loop calls it, on the device cache's route.

Set-up draws the configuration's weights from the seed, builds its
projection (projections/<name>.py: the port's FluidNet) and the train
state (init_train_state), makes the mix's pool of samples
(scenes/<name>.py) and hands it to data.dataset.DeviceDataset (every
sample on the device, a batch an index_select, shuffled epochs). Each
step takes the next batch, its horizon and the draws of dt and the
forces, made as cli/train.py makes them and passed to train_step, so
the reference gets the same, and ends with the host reading the step's
loss terms. An epoch's horizons are cli/train.py's: round(p_short * m)
short ones and the rest long, in an order shuffled by the seed.

Set-up drives the state through the first `reference_steps` steps
(distinct batches of the first epoch), and on, up to
`reference_steps_max`, until one update was accepted (the recipe's
guard drops an update whose loss reaches loss_reject_threshold), keeping
what the reference is compared with; then one step at each horizon; and
hands the same state to the window.
"""

import random
import time

import numpy as np
import torch

from fluidnet_tpu_torch.core.config import from_dict
from fluidnet_tpu_torch.data.dataset import DeviceDataset
from fluidnet_tpu_torch.train.train import Draws, init_train_state, train_step

from fluidbench import checks, spec, tracing
from fluidbench.reference import step as ref_step


def horizon_list(rng, horizons, p_short, m):
    """The horizons of m steps: round(p_short * m) short, the rest long,
    shuffled by `rng` (cli/train.py's _horizon_list)."""
    lo, hi = horizons
    n_lo = int(round(p_short * m))
    out = [lo] * n_lo + [hi] * (m - n_lo)
    rng.shuffle(out)
    return out


def draws(mconf, seed, step):
    """The draws of training step `step`: (dt, gravity (3,), b_scale,
    g_scale, v_amp), CPU float32 (run_epoch.lua:133-158, 243-249), from
    the step's own CPU generator (cli/train.py's _generator)."""
    gen = torch.Generator().manual_seed((seed * 1000003 + step) % 2 ** 63)
    if mconf["time_scale_sigma"] > 0:
        scale = 0.2028 + torch.abs(torch.randn((), generator=gen) *
                                   mconf["time_scale_sigma"])
        dt = mconf["dt"] * scale
    else:
        dt = torch.tensor(mconf["dt"], dtype=torch.float32)
    axis = int(torch.randint(0, 3, (), generator=gen))
    sign = float(torch.randint(0, 2, (), generator=gen)) * 2 - 1
    gravity = torch.zeros(3)
    gravity[axis] = sign
    on = torch.rand(3, generator=gen)
    b_scale = torch.tensor(mconf["train_buoyancy_scale"]
                           if on[0] < mconf["train_buoyancy_prob"] else 0.0)
    g_scale = torch.tensor(mconf["train_gravity_scale"]
                           if on[1] < mconf["train_gravity_prob"] else 0.0)
    v_amp = torch.tensor(mconf["train_vorticity_confinement_amp"]
                         if on[2] < mconf["train_vorticity_confinement_prob"]
                         else 0.0)
    return dt, gravity, b_scale, g_scale, v_amp


class Step:
    """What one train step took and gave."""

    def __init__(self, idx, n, draws, loss, rejected):
        self.idx, self.n, self.draws = idx, n, draws
        self.loss, self.rejected = loss, rejected


class Driver:
    """A training cell's run on `device` (the chip; the CPU in tests)."""

    def __init__(self, cell, seed, device):
        config, mix = cell.config, cell.mix
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.mconf_dict = {**config["mconf"],
                           "long_term_div_num_steps": list(mix["horizons"]),
                           "long_term_div_probability": mix["p_short"]}
        self.mconf = from_dict(self.mconf_dict)
        self.proj = spec.projection(config)
        self.weights = self.proj.weights(config, seed, self.dev,
                                         training=True)
        self.model = self.proj.program(self.mconf, self.weights, self.dev)
        self.state = init_train_state(0, self.mconf, self.dev,
                                      model=self.model)
        scene = spec.scene(mix)
        self.pool = scene.make(mix, seed, self.dev)
        self.loader = DeviceDataset(scene.Pool(self.pool), mix["batch"],
                                    self.dev, keys=tuple(self.pool),
                                    shuffle=True, seed=seed)
        self.horizon_rng = random.Random(seed)
        self.batches = self._batches()
        self.n_steps = 0
        self.first = []
        self.grad1 = None

    def _batches(self):
        mix = self.cell.mix
        while True:
            idxs = list(self.loader.epoch_indices(drop_last=True))
            ns = horizon_list(self.horizon_rng, mix["horizons"],
                              mix["p_short"], len(idxs))
            for idx, n in zip(idxs, ns):
                yield idx, self.loader.batch(idx), n

    def train_step(self, batch, n, draws):
        """The timed path: one optimizer step."""
        return train_step(self.state, batch, None, self.mconf, n,
                          draws=draws)

    def step(self, n=None):
        """The next step of the epoch, at its own horizon unless `n`."""
        idx, batch, n_epoch = next(self.batches)
        n = n_epoch if n is None else n
        d = Draws(*draws(self.mconf_dict, self.seed, self.n_steps))
        self.state, terms = self.train_step(batch, n, d)
        vals = torch.stack([terms["total"], terms["rejected"]]).cpu()
        self.n_steps += 1
        return Step(idx, n, d, float(vals[0]), bool(vals[1] > 0))

    def _params(self):
        return {k: p.detach().clone()
                for k, p in self.state.model.jax_named_parameters()}

    def setup(self):
        mix = self.cell.mix
        b1 = self.mconf.optim.beta1
        names = [k for k, _ in self.state.model.jax_named_parameters()]
        while len(self.first) < mix["reference_steps"] or (
                self.grad1 is None and
                len(self.first) < mix["reference_steps_max"]):
            s = self.step()
            self.first.append(s)
            if self.grad1 is None and not s.rejected:
                # Adam's first moment after its first accepted update is
                # (1 - beta1) times that update's clipped gradient.
                self.grad1 = {k: m.detach().clone() / (1 - b1) for k, m in
                              zip(names, self.state.opt_state["mu"])}
        self.p_end = self._params()
        for n in sorted(set(mix["horizons"])):
            self.step(n)
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds):
        steps, failed = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            s = self.step()
            steps += 1
            failed += not np.isfinite(s.loss)
        elapsed = time.perf_counter() - t0
        self.failed = failed
        return {"train_samples_per_s":
                self.cell.mix["batch"] * steps / elapsed}, steps

    def stretch(self):
        """The traced run's stretch: trace_steps steps at the horizons of
        horizon_list (the same share of each for every seed), run
        plain_repeats times unprofiled (the host's clocks), then once
        under the profiler."""
        mix = self.cell.mix
        ns = horizon_list(random.Random(self.seed), mix["horizons"],
                          mix["p_short"], mix["trace_steps"])
        rep = mix["plain_repeats"]
        c0, t0 = time.process_time(), time.perf_counter()
        for n in ns * rep:
            self.step(n)
        self._sync()
        plain = (time.perf_counter() - t0) / rep
        cpu = (time.process_time() - c0) / rep

        def run():
            for n in ns:
                self.step(n)
        events = tracing.profile(run)
        kernels, copies, busy, window_s, gaps = tracing.reduce(events)
        b, res = mix["batch"], mix["res"]
        stretch = tracing.Stretch(
            kind="train", steps=len(ns), frames=0, horizons=ns,
            cells=b * res ** 3, cells_per_sample=res ** 3, batch=b,
            config=self.cell.config, peaks=None, plain_wall_s=plain,
            host_cpu_s=cpu, window_s=window_s, kernels=kernels,
            copies=copies, busy_s=busy, slab_cells=0)
        self.failed = 0
        return stretch, gaps, (rep + 1) * len(ns)

    def free(self):
        self.state = self.model = self.loader = self.batches = None

    def reference(self, precision, batch_share=1.0):
        """The reference through the first steps: {"losses", "grad1",
        "p0", "p_end", "rejected", "grad_norms"}, grad1 from its first
        accepted update (None if it accepted none); batch_share < 1 keeps
        that share of each batch (a planted fault)."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ns = ref_step.namespace(self.mconf_dict)
        layers = self.cell.config.get("layers")
        b1 = ns.optim["beta1"]
        params = dict(self.weights)
        opt = ref_step.adam_init(params)
        losses, grad1, rejected, norms = [], None, [], []
        for s in self.first:
            idx = s.idx[:max(1, int(len(s.idx) * batch_share))]
            batch = {k: torch.from_numpy(v[idx]).to(self.dev)
                     for k, v in self.pool.items()}
            count = opt["count"]
            params, opt, loss, clipped = ref_step.train_step(
                params, opt, ns, layers, batch, tuple(s.draws), s.n,
                precision, self.proj.reference)
            losses.append(loss)
            rejected.append(opt["count"] == count)
            norms.append(float(ref_step.global_norm(list(clipped.values()))))
            if grad1 is None and not rejected[-1]:
                grad1 = {k: m / (1 - b1) for k, m in opt["mu"].items()}
        return {"losses": losses, "grad1": grad1, "p0": self.weights,
                "p_end": params, "rejected": rejected, "grad_norms": norms}

    def program(self):
        return {"losses": [s.loss for s in self.first], "grad1": self.grad1,
                "p0": self.weights, "p_end": self.p_end,
                "rejected": [s.rejected for s in self.first]}

    def readings(self, control=False):
        """The program's gaps from the reference; with `control` the
        reference at the lower precision stands in the program's
        place."""
        precision, lower = self.proj.precisions(self.cell.config)
        ref = self.reference(precision)
        prog = self.reference(lower) if control else self.program()
        return checks.train_readings(prog, ref)
