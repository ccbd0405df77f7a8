"""Training step: divergence loss + unrolled long-term divergence loss.

Port of fluidnet_tpu.train.train (the feval closure of torch.runEpoch,
torch/lib/run_epoch.lua:191-320):

  1. model forward on the divergent input; FluidCriterion loss.
  2. long-term loss: run `simulate` forward n steps with a random per-batch
     dt scale and randomized forces, the model on the final divergent
     state, divergence loss only (no manta ground truth for future frames,
     run_epoch.lua:273-277).
  3. global-norm gradient clip to mconf.grad_norm_threshold, the optimizer,
     the reject guard.

Two gradient modes (mconf.long_term_grad_mode):
  'last': gradients flow through the final projection only, exactly the
          reference (its state copies break the graph, simulate.lua:267-272).
  'full': the whole unroll is differentiated, each step but the last under
          torch.utils.checkpoint (non-reentrant), as JAX's jax.checkpoint.
Every kernel on the way carries the gradient rule of its JAX custom VJP:
K1's fused sweeps replay the unfused ones (K1 unfused), whose adjoint is
K6; K2 replays forces_block_xla / prologue_xla, K4
vorticity_confinement_xla.

The random draws (dt, gravity direction, force switches) come from an
explicit CPU torch.Generator, outside the checkpointed steps, and stay on
the host: the kernels take them as launch arguments. `loss_fn` and
`train_step` also take the draws themselves (`draws`), so a test can feed
the ones JAX made.

The optimizers follow optax's formulas, not torch.optim's: the clip scales
by max_norm / norm only when norm >= max_norm (no 1e-6 added), Adagrad's
accumulator starts at 0.1, RMSprop takes eps inside the square root. The
JAX package's fused and scanned epoch steps (train_step_fused,
train_epoch_scan, the eval scans) were TPU dispatch workarounds; the port
runs one train_step per batch (cli/train.py) with the same metric sums
(`add_metrics`) and EMA (`ema_update`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState, get_dx
from fluidnet_tpu_torch.models.fluidnet import FluidNet, random_model
from fluidnet_tpu_torch.ops.boundary import set_wall_bcs
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.forces import (add_buoyancy, add_gravity,
                                           vorticity_confinement,
                                           vorticity_confinement_xla)
from fluidnet_tpu_torch.ops.velocity_update import velocity_update
from fluidnet_tpu_torch.sim.simulate import FlagConsts, simulate
from fluidnet_tpu_torch.solvers.cg import solve_pcg
from fluidnet_tpu_torch.solvers.components import normalize_pressure_mean
from fluidnet_tpu_torch.solvers.cuda_jacobi import jacobi_plain
from fluidnet_tpu_torch.solvers.jacobi import solve_jacobi
from fluidnet_tpu_torch.train.loss import border_loss_weights, fluid_loss

F32 = torch.float32
METRIC_KEYS = ("total", "p", "u", "div", "long_term_div", "grad_norm",
               "rejected")


class Draws(NamedTuple):
    """One batch's random draws (run_epoch.lua:133-158, 243-249): dt and
    the force overrides, CPU float32 tensors."""
    dt: torch.Tensor
    gravity: torch.Tensor
    b_scale: torch.Tensor
    g_scale: torch.Tensor
    v_amp: torch.Tensor


@dataclasses.dataclass
class TrainState:
    """The model (whose parameters are the params), the optimizer state,
    and the step count (which advances on rejected updates too)."""
    model: FluidNet
    opt_state: dict
    step: int = 0

    @property
    def params(self):
        return [t for _, t in self.model.jax_named_parameters()]


def global_norm(tensors):
    """optax.global_norm: sqrt of the sum of every leaf's sum of squares."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_norm_threshold),
    inject_hyperparams(<method>)(...)) of make_optimizer (train.py:57-86),
    on lists of tensors, with optax's formulas. The state is a dict of
    tensors: the injected learning rate, and per method adam {count, mu,
    nu}, sgd {trace} (momentum), adagrad {sum_of_squares} (from 0.1, eps
    1e-7), rmsprop {nu} (decay 0.9, eps in the square root)."""

    METHODS = ("adam", "sgd", "adagrad", "rmsprop")

    def __init__(self, mconf: ModelConfig):
        self.method = mconf.optimization_method
        if self.method not in self.METHODS:
            raise ValueError(f"bad optimization_method {self.method}")
        self.o = mconf.optim
        if self.o.weight_decay:
            # The JAX chain adds add_decayed_weights after the optimizer,
            # whose update already holds -lr: a decay there adds +wd * p
            # with no learning rate, the wrong sign (ROADMAP fault F10).
            raise ValueError("optim.weight_decay != 0 is refused: the JAX "
                             "make_optimizer applies it with the wrong sign "
                             "and no learning rate (ROADMAP fault F10)")
        self.max_norm = mconf.grad_norm_threshold

    def init(self, params):
        dev = params[0].device
        st = {"learning_rate": torch.tensor(self.o.learning_rate, dtype=F32,
                                            device=dev)}
        zeros = [torch.zeros_like(p) for p in params]
        if self.method == "adam":
            st.update(count=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu=[torch.zeros_like(p) for p in params])
        elif self.method == "sgd":
            st["trace"] = zeros
        elif self.method == "adagrad":
            st["sum_of_squares"] = [torch.full_like(p, 0.1) for p in params]
        else:
            st["nu"] = zeros
        return st

    def update(self, grads, state):
        """(updates, new state) for the gradients `grads`."""
        gn = global_norm(grads)
        # clip_by_global_norm: unchanged below max_norm, else t / gn * max.
        trigger = gn < self.max_norm
        g = [torch.where(trigger, t, (t / gn) * self.max_norm)
             for t in grads]
        st = dict(state)
        o = self.o
        if self.method == "adam":
            b1, b2 = o.beta1, o.beta2
            st["mu"] = [(1 - b1) * t + b1 * m for t, m in zip(g, state["mu"])]
            st["nu"] = [(1 - b2) * (t ** 2) + b2 * v
                        for t, v in zip(g, state["nu"])]
            count = state["count"]
            st["count"] = torch.where(
                count < torch.iinfo(torch.int32).max, count + 1, count)
            c = st["count"].to(F32)
            bc1 = 1 - torch.tensor(b1, dtype=F32, device=c.device) ** c
            bc2 = 1 - torch.tensor(b2, dtype=F32, device=c.device) ** c
            upd = [(m / bc1) / (torch.sqrt(v / bc2) + o.epsilon)
                   for m, v in zip(st["mu"], st["nu"])]
        elif self.method == "sgd":
            st["trace"] = [t + o.momentum * tr
                           for t, tr in zip(g, state["trace"])]
            upd = st["trace"]
        elif self.method == "adagrad":
            st["sum_of_squares"] = [t * t + s for t, s in
                                    zip(g, state["sum_of_squares"])]
            upd = [torch.where(s > 0, torch.rsqrt(s + 1e-7), 0.0) * t
                   for s, t in zip(st["sum_of_squares"], g)]
        else:
            st["nu"] = [(1 - 0.9) * (t ** 2) + 0.9 * v
                        for t, v in zip(g, state["nu"])]
            upd = [torch.rsqrt(v + o.epsilon) * t
                   for v, t in zip(st["nu"], g)]
        neg_lr = -state["learning_rate"]
        return [u * neg_lr for u in upd], st


def make_optimizer(mconf: ModelConfig) -> Optimizer:
    return Optimizer(mconf)


def init_train_state(seed: int, mconf: ModelConfig, device=None,
                     model: Optional[FluidNet] = None) -> TrainState:
    """A fresh model (random_model, seeded) or `model`, and the
    optimizer's initial state."""
    if model is None:
        model = random_model(mconf, seed, device)
    params = [t for _, t in model.jax_named_parameters()]
    return TrainState(model=model,
                      opt_state=make_optimizer(mconf).init(params), step=0)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Epoch-boundary LR multiplier application (run_epoch.lua:40-48): the
    injected learning rate."""
    old = state.opt_state["learning_rate"]
    state.opt_state["learning_rate"] = torch.tensor(lr, dtype=F32,
                                                    device=old.device)
    return state


def _random_forces(gen, mconf: ModelConfig):
    """Per-batch force randomization (run_epoch.lua:133-158): a random
    cardinal gravity direction; buoyancy, gravity and vorticity switched
    on with their train probabilities. Returns (gravity (3,), b_scale,
    g_scale, v_amp), CPU float32."""
    axis = int(torch.randint(0, 3, (), generator=gen))
    sign = float(torch.randint(0, 2, (), generator=gen)) * 2 - 1
    gravity = torch.zeros(3)
    gravity[axis] = sign
    on = torch.rand(3, generator=gen)
    b_scale = torch.tensor(mconf.train_buoyancy_scale
                           if on[0] < mconf.train_buoyancy_prob else 0.0)
    g_scale = torch.tensor(mconf.train_gravity_scale
                           if on[1] < mconf.train_gravity_prob else 0.0)
    v_amp = torch.tensor(mconf.train_vorticity_confinement_amp
                         if on[2] < mconf.train_vorticity_confinement_prob
                         else 0.0)
    return gravity, b_scale, g_scale, v_amp


def _random_dt(gen, mconf: ModelConfig):
    """Random time-scale perturbation (run_epoch.lua:243-249): scale =
    0.2028 + |N(0,1) * timeScaleSigma| (the constant makes E[scale] ~= 1).
    A CPU float32 0-d tensor."""
    if mconf.time_scale_sigma <= 0:
        return torch.tensor(mconf.dt, dtype=F32)
    scale = 0.2028 + torch.abs(torch.randn((), generator=gen) *
                               mconf.time_scale_sigma)
    return mconf.dt * scale


def draw(gen, mconf: ModelConfig) -> Draws:
    """The draws of one batch from the CPU torch.Generator `gen`."""
    return Draws(_random_dt(gen, mconf), *_random_forces(gen, mconf))


def _data_augmentation(u_div, flags, density, mconf: ModelConfig, draws,
                       use_kernels=True):
    """tfluids.dataAugmentation (simulate.lua:374-414): extra buoyancy,
    gravity and vorticity-confinement divergence on UDiv. As the JAX port
    (train.py:128-143), it keeps the reference's quirks: addBuoyancy gets
    the RAW cardinal gravity vector, addGravity the dx-scaled one. The 3-D
    confinement is K4."""
    dx = get_dx(flags)
    if density is not None:
        g_buoy = draws.gravity * torch.where(draws.b_scale > 0, 1.0, 0.0)
        u_div = add_buoyancy(u_div, flags, density[:, 0:1], g_buoy,
                             mconf.dt)
    u_div = add_gravity(u_div, flags,
                        draws.gravity * (-(dx / 4.0) * draws.g_scale),
                        mconf.dt)
    vc = vorticity_confinement if use_kernels else vorticity_confinement_xla
    return vc(u_div, flags, dx * draws.v_amp)


def _calc_pu_targets(u_div, flags, mconf: ModelConfig, use_kernels=True):
    """tfluids.calcPUTargets (simulate.lua:332-372): solver-sourced ground
    truth. Returns (u_div', p_target, u_target); u_div' is the wall-bc'd
    input the reference leaves in the batch (:344). Callers run it without
    gradients (the reference computes targets outside the autograd
    closure, run_epoch.lua:160-170)."""
    u_div = set_wall_bcs(u_div, flags)
    div = velocity_divergence(u_div, flags)
    if mconf.train_target_source == "pcg":
        p_t, _ = solve_pcg(flags, div, tol=1e-4,
                           max_iter=mconf.max_iter or 100)
    elif mconf.train_target_source == "jacobi":
        n = mconf.max_iter or 50
        p_t = solve_jacobi(flags, div, p_tol=0.0, max_iter=n)[0] \
            if use_kernels else jacobi_plain(flags, div, n)
    else:
        raise ValueError(
            f"bad train_target_source {mconf.train_target_source}")
    u_t = set_wall_bcs(velocity_update(u_div, flags, p_t), flags)
    return u_div, p_t, u_t


def sample_future_steps(py_rng, mconf: ModelConfig) -> int:
    """Host-side horizon sampling (run_epoch.lua:254-257)."""
    if py_rng.random() <= mconf.long_term_div_probability:
        return mconf.long_term_div_num_steps[0]
    return mconf.long_term_div_num_steps[1]


def loss_fn(model, batch, gen, mconf: ModelConfig, n_future: int,
            loss_weights=None, draws: Optional[Draws] = None,
            use_kernels: bool = True):
    """Total loss for one batch (train.py:179-276): returns (total,
    terms), 0-d tensors. batch: p_div, u_div, flags, optional density,
    p_target, u_target. The draws come from the CPU torch.Generator `gen`
    unless given in `draws`. The unroll records gradients when autograd
    is on (train_step), and runs without them otherwise (eval_step).

    With train_target_source 'jacobi' / 'pcg' and a p/u loss active, the
    manta targets are replaced in-graph: dataAugmentation on UDiv, then
    solver ground truth (the reference gates this on the misspelled
    `trainTrainSource`, always nil there; the intended gate is
    implemented). With loss_p_lambda > 0 the target pressure's
    per-component mean is removed before the loss (run_epoch.lua:
    172-179)."""
    flags = batch["flags"]
    if draws is None:
        draws = draw(gen, mconf)
    grad = torch.is_grad_enabled()

    u_div = batch["u_div"]
    p_target = batch.get("p_target")
    u_target = batch.get("u_target")
    if p_target is None or u_target is None:
        if mconf.loss_p_lambda != 0 or mconf.loss_u_lambda != 0:
            raise ValueError("p/u losses need target fields in the batch")
        p_target = torch.zeros_like(batch["p_div"])
        u_target = torch.zeros_like(u_div)
    use_solver_gt = (mconf.train_target_source != "manta" and
                     (mconf.loss_p_lambda > 0 or mconf.loss_u_lambda > 0))
    with torch.no_grad():
        if use_solver_gt:
            u_aug = _data_augmentation(u_div, flags, batch.get("density"),
                                       mconf, draws, use_kernels)
            u_div, p_target, u_target = _calc_pu_targets(u_aug, flags,
                                                         mconf, use_kernels)
        elif mconf.augment_without_targets:
            if mconf.loss_p_lambda != 0 or mconf.loss_u_lambda != 0:
                raise ValueError("augment_without_targets requires the p/u "
                                 "losses off")
            u_div = _data_augmentation(u_div, flags, batch.get("density"),
                                       mconf, draws, use_kernels)
        if mconf.loss_p_lambda > 0:
            p_target = normalize_pressure_mean(p_target, flags)
        if loss_weights is None and mconf.loss_func_border_weight != 1.0:
            # The flags do not change within the batch: one weight field
            # serves both loss terms.
            loss_weights = border_loss_weights(
                flags, mconf.loss_func_border_weight,
                mconf.loss_func_border_width)

    p_pred, u_pred = model(batch["p_div"], u_div, flags)
    total, terms = fluid_loss(mconf, p_pred, u_pred, p_target, u_target,
                              flags, weights=loss_weights)

    if n_future > 0 and mconf.long_term_div_lambda > 0:
        consts = FlagConsts()

        def step(u, p, density, output_div):
            s = simulate(FluidState(u=u, p=p, flags=flags, density=density),
                         mconf, model, None, use_kernels, dt=draws.dt,
                         buoyancy_scale=draws.b_scale,
                         gravity_scale=draws.g_scale,
                         vorticity_amp=draws.v_amp, consts=consts,
                         output_div=output_div, gravity=draws.gravity,
                         grad=grad)
            return s.u, s.p, s.density

        fields = (u_div, batch["p_div"], batch.get("density"))
        if mconf.long_term_grad_mode == "full":
            for _ in range(n_future - 1):
                fields = checkpoint(step, *fields, False,
                                    use_reentrant=False,
                                    preserve_rng_state=False) if grad \
                    else step(*fields, False)
            fields = step(*fields, True)
        elif mconf.long_term_grad_mode == "last":
            # Reference semantics: an inference-mode unroll, gradients
            # only through the final projection (run_epoch.lua:262-269).
            with torch.no_grad():
                for i in range(n_future):
                    fields = step(*fields, i == n_future - 1)
        else:
            raise ValueError(f"bad long_term_grad_mode "
                             f"{mconf.long_term_grad_mode}")
        u_lt, p_lt = fields[0], fields[1]
        p_pred_lt, u_pred_lt = model(p_lt, u_lt, flags)
        if mconf.train_target_source == "manta":
            # No manta ground truth for future frames: the pressure and
            # velocity lambdas are zeroed (run_epoch.lua:273-277).
            lt_total, lt_terms = fluid_loss(
                mconf, p_pred_lt, u_pred_lt, p_lt, u_lt, flags,
                p_lambda=0.0, u_lambda=0.0,
                div_lambda=mconf.long_term_div_lambda, weights=loss_weights)
        else:
            # Solver ground truth exists for the future frame too
            # (run_epoch.lua:278-283).
            with torch.no_grad():
                _, p_lt_t, u_lt_t = _calc_pu_targets(u_lt, flags, mconf,
                                                     use_kernels)
                p_lt_t = normalize_pressure_mean(p_lt_t, flags)
            lt_total, lt_terms = fluid_loss(
                mconf, p_pred_lt, u_pred_lt, p_lt_t, u_lt_t, flags,
                div_lambda=mconf.long_term_div_lambda, weights=loss_weights)
        total = total + lt_total
        terms["long_term_div"] = lt_terms["div"]
    else:
        terms["long_term_div"] = torch.zeros((), device=total.device)
    terms["total"] = total
    return total, terms


def _reject_ok(terms, grad_norm, mconf: ModelConfig):
    """Accept mask of the reject-bad-update guard (a device bool): loss and
    grad norm finite and the loss below loss_reject_threshold; a threshold
    of 0 disables the guard."""
    if mconf.loss_reject_threshold <= 0:
        return torch.ones((), dtype=torch.bool, device=grad_norm.device)
    return (torch.isfinite(terms["total"]) & torch.isfinite(grad_norm) &
            (terms["total"] < mconf.loss_reject_threshold))


def train_step(state: TrainState, batch, gen, mconf: ModelConfig,
               n_future: int, draws: Optional[Draws] = None,
               use_kernels: bool = True):
    """One optimization step (train.py:297-311); returns (state, terms),
    terms detached with grad_norm and rejected added. A rejected update
    keeps the params and the optimizer state (selected on the device, no
    host read); the step count still advances."""
    params = state.params
    with torch.enable_grad():
        total, terms = loss_fn(state.model, batch, gen, mconf, n_future,
                               draws=draws, use_kernels=use_kernels)
        grads = torch.autograd.grad(total, params)
    opt = make_optimizer(mconf)
    with torch.no_grad():
        updates, new_opt = opt.update(grads, state.opt_state)
        gn = global_norm(grads)
        terms = {k: v.detach() for k, v in terms.items()}
        ok = _reject_ok(terms, gn, mconf)
        for p, u in zip(params, updates):
            p.copy_(torch.where(ok, p + u, p))
        state.opt_state = {
            k: ([torch.where(ok, n, o) for n, o in zip(v, state.opt_state[k])]
                if isinstance(v, list) else torch.where(ok, v,
                                                        state.opt_state[k]))
            for k, v in new_opt.items()}
    terms["grad_norm"] = gn
    terms["rejected"] = 1.0 - ok.to(F32)
    state.step += 1
    return state, terms


def eval_step(batch, model, gen, mconf: ModelConfig, n_future: int,
              draws: Optional[Draws] = None, use_kernels: bool = True):
    """The loss terms of one batch, without gradients."""
    with torch.no_grad():
        _, terms = loss_fn(model, batch, gen, mconf, n_future, draws=draws,
                           use_kernels=use_kernels)
    terms["grad_norm"] = torch.zeros_like(terms["total"])
    terms["rejected"] = torch.zeros_like(terms["total"])
    return terms


def metric_sums_init(device):
    return {k: torch.zeros((), device=device) for k in METRIC_KEYS}


def add_metrics(sums, terms, mconf: ModelConfig):
    """The metric sums of _train_core (train.py:362-373), on the device:
    with the reject guard on, a non-finite term adds 0 (the 'rejected'
    counter discloses the dropped update); with it off the raw terms flow
    through so a NaN loss trips the epoch's fail-fast check."""
    for k in sums:
        t = terms[k]
        if mconf.loss_reject_threshold > 0:
            t = torch.where(torch.isfinite(t), t, 0.0)
        sums[k] = sums[k] + t
    return sums


def ema_update(ema_model, model, decay: float):
    """ema = ema * decay + params * (1 - decay) (train.py:359-361), in
    place on the parameters of `ema_model`."""
    with torch.no_grad():
        d = torch.tensor(decay, dtype=F32)
        for (_, e), (_, p) in zip(ema_model.jax_named_parameters(),
                                  model.jax_named_parameters()):
            e.copy_(e * d.to(e.device) + p * (1.0 - d).to(p.device))
