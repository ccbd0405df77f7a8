"""Training entry point.

Port of fluidnet_tpu.cli.train (`qlua fluid_net_train.lua`):

  python -m fluidnet_tpu_torch.cli.train -dataset my_ds \\
      -model_filename m1 -max_epochs 10 -profile false [-device cpu]

- loads (or self-generates, with the PCG solver) the dataset and puts it on
  the device (DeviceDataset);
- builds or resumes the model (`-load_model true -resume_training true`
  continue from '<model>_lastEpoch', the EMA from '<model>_ema');
- runs train and test epochs with the unrolled long-term divergence loss,
  the horizon curriculum (`-horizon_schedule`), the LR multipliers
  (`-lr_epoch_mults`), the EMA (`-ema_decay`) and rollout selection
  (`-rollout_select_steps`: '<model>_bestRollout');
- checkpoints '<model>_lastEpoch' every epoch and '<model>' on the best test
  loss (fluid_net_train.lua:229-239), and logs one TSV row per epoch.

Training runs on the CUDA device unless `-device cpu` is given. Each epoch
is a per-batch loop of train.train_step: the JAX package's fused and
scanned epoch steps were TPU dispatch workarounds (ROADMAP). The horizons
of an epoch's batches follow the JAX scan path's deterministic counts
(`_horizon_list`), each batch's draws a generator seeded by the step.
Not ported (they raise, naming the ROADMAP item): the startup profile
(`-profile true`: utils/flops, utils/profiler) and the threaded host loader
for datasets past the device cache (`-device_data_cache false`).
"""

import copy
import gc
import os
import random
import sys
import time

import numpy as np
import torch

from fluidnet_tpu_torch.core.config import (default_conf, parse_args,
                                            save_parameters)
from fluidnet_tpu_torch.core.grids import FluidState, resolve_device
from fluidnet_tpu_torch.data.dataset import DeviceDataset, FluidDataset
from fluidnet_tpu_torch.data.generate import generate_dataset
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.sim.simulate import rollout
from fluidnet_tpu_torch.train.train import (TrainState, add_metrics,
                                            ema_update, eval_step,
                                            init_train_state,
                                            metric_sums_init,
                                            set_learning_rate, train_step)
from fluidnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
from fluidnet_tpu_torch.utils.logger import Logger
from fluidnet_tpu_torch.utils.pbar import progress

LOG_COLUMNS = ["epoch", "tr_loss", "tr_p", "tr_u", "tr_div", "tr_lt_div",
               "te_loss", "te_p", "te_u", "te_div", "te_lt_div"]
CHECK_EVERY = 16


def _horizon_list(py_rng, mconf, horizon, m):
    """Horizons for m batches with deterministic per-horizon counts
    (round(p*m) short, the rest long) in a shuffled order, as the JAX scan
    path draws them (cli/train.py:66-90). `horizon`: the curriculum's
    (lo, hi), else mconf.long_term_div_num_steps."""
    if mconf.long_term_div_lambda <= 0:
        return [0] * m
    lo, hi = horizon or mconf.long_term_div_num_steps
    n_lo = int(round(mconf.long_term_div_probability * m))
    out = [lo] * n_lo + [hi] * (m - n_lo)
    py_rng.shuffle(out)
    return out


def _horizon_for(conf, mconf, epoch):
    """The curriculum's (lo, hi) at `epoch` (conf.horizon_schedule), None
    without a schedule."""
    if not conf.horizon_schedule:
        return None
    lo, hi = mconf.long_term_div_num_steps
    for ep_at, lo_, hi_ in conf.horizon_schedule:
        if epoch >= ep_at:
            lo, hi = int(lo_), int(hi_)
    return lo, hi


def _generator(seed, i):
    """The draws' generator of step (or eval batch) i: JAX folds i into the
    epoch key, here it seeds a CPU generator."""
    return torch.Generator().manual_seed(seed * 1000003 + int(i))


def _epoch(loader, state, mconf, conf, py_rng, training, max_batches=0,
           horizon=None, ema=None):
    """One pass over the loader, one step per batch, the metric sums kept on
    the device and read every CHECK_EVERY batches (NaN / blow-up and the
    reject guard's abort, cli/train.py:160-171). Returns (state, means)."""
    dev = state.params[0].device
    sums = metric_sums_init(dev)
    idx = list(loader.epoch_indices(max_batches=max_batches))
    nfs = _horizon_list(py_rng, mconf, horizon if training else None,
                        len(idx))
    n = 0
    for i, (c, nf) in enumerate(zip(idx, nfs)):
        batch = loader.batch(c)
        if training:
            state, terms = train_step(state, batch,
                                      _generator(conf.seed, state.step),
                                      mconf, nf)
            if ema is not None:
                ema_update(ema["model"], state.model, ema["decay"])
        else:
            terms = eval_step(batch, state.model,
                              _generator(conf.seed, i), mconf, nf)
        sums = add_metrics(sums, terms, mconf)
        n += 1
        if n % CHECK_EVERY == 0 or n == len(idx):
            t = float(sums["total"])
            if not np.isfinite(t) or t > 1e9 * n:
                raise RuntimeError(f"criterion error is NaN or > 1e9 (sum "
                                   f"{t} at {n})")
            rej = float(sums["rejected"])
            if training and n >= 8 and rej / n > 0.5:
                raise RuntimeError(
                    f"update-reject guard dropped {rej:.0f}/{n} batches "
                    f"(>50%): the run has diverged past the "
                    f"loss_reject_threshold")
            progress(n, len(idx), f"err={t / n:.4e}")
    return state, {k: float(v) / max(n, 1) for k, v in sums.items()}


def _rollout_metric(te_loader, model, mconf, n_steps):
    """Mean final-step ||div||_2 of an n-step free rollout from the first
    test batch's projected state (the divergent one when the cache holds
    no targets): the per-epoch model selection of cli/train.py:262-280."""
    batch = te_loader.batch(next(te_loader.epoch_indices(max_batches=1)))
    s = FluidState(u=batch.get("u_target", batch["u_div"]),
                   p=batch.get("p_target", batch["p_div"]),
                   flags=batch["flags"], density=batch.get("density"))
    s = rollout(s, mconf, n_steps, model)
    div = velocity_divergence(s.u, s.flags)
    return float(torch.sqrt((div.reshape(div.shape[0], -1) ** 2)
                            .sum(dim=1)).mean())


def _rss_gb():
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS"):
                    return int(ln.split()[1]) / 1e6
    except OSError:
        pass
    return float("nan")


def run_training(conf):
    if conf.profile:
        raise NotImplementedError("the startup profile (-profile true) is "
                                  "not ported yet (ROADMAP queue 1, item 2: "
                                  "utils/flops, utils/profiler); pass "
                                  "-profile false")
    dev = resolve_device(conf.device)
    mconf = conf.new_model
    np.random.seed(conf.seed)
    py_rng = random.Random(conf.seed)

    ds_root = os.path.join(conf.data_dir, conf.dataset)
    if not os.path.isdir(ds_root):
        print(f"==> Dataset {ds_root} not found; self-generating with the "
              "PCG solver...")
        generate_dataset(ds_root, n_tr=8, n_te=2, seed=conf.seed,
                         size_xyz=(64, 64, 1), is_3d=False, n_frames=32,
                         device=dev)
    tr = FluidDataset(conf.data_dir, conf.dataset, "tr",
                      ignore_frames=conf.ignore_frames)
    te = FluidDataset(conf.data_dir, conf.dataset, "te",
                      ignore_frames=conf.ignore_frames)
    mconf = mconf.replace(is_3d=tr.is_3d)
    print(f"==> Dataset: {len(tr)} train / {len(te)} test samples "
          f"({'3-D' if tr.is_3d else '2-D'}) on {dev}")

    os.makedirs(conf.model_dir, exist_ok=True)
    model_path = os.path.join(conf.model_dir, conf.model_filename)
    state = init_train_state(conf.seed, mconf, dev)
    start_epoch, best_loss, best_rollout = 0, float("inf"), float("inf")
    if conf.load_model and os.path.isdir(model_path + "_lastEpoch"):
        state, mconf_loaded, extra = load_checkpoint(
            model_path + "_lastEpoch", state)
        if conf.resume_training:
            # Keep the training-only params of the fresh conf
            # (torch.copyTrainingMconfParams, model.lua:499-523).
            mconf = mconf_loaded.replace(**{k: getattr(mconf, k) for k in (
                "grad_norm_threshold", "loss_reject_threshold",
                "loss_p_lambda", "loss_u_lambda", "loss_div_lambda",
                "long_term_div_lambda", "long_term_div_probability",
                "long_term_div_num_steps", "long_term_grad_mode", "optim",
                "dt", "train_target_source")})
        else:
            mconf = mconf_loaded
        start_epoch = int(extra.get("epoch", 0))
        best_loss = float(extra.get("best_loss", float("inf")))
        best_rollout = float(extra.get("best_rollout", float("inf")))
        print(f"==> Resumed from epoch {start_epoch}")
    save_parameters(conf, model_path + "_conf.json")

    logger = Logger(model_path + "_log.tsv", LOG_COLUMNS)
    need_targets = mconf.loss_p_lambda > 0 or mconf.loss_u_lambda > 0
    cache_keys = ("p_div", "u_div", "flags", "density") + \
        (("p_target", "u_target") if need_targets else ())
    per_sample = sum(tr.get_batch([0])[k].nbytes for k in cache_keys) / 1e9
    if not conf.device_data_cache or \
            per_sample * (len(tr) + len(te)) > conf.device_data_cache_max_gb:
        raise NotImplementedError("datasets past the device cache need the "
                                  "threaded host loader, not ported yet "
                                  "(ROADMAP queue 1, item 4: "
                                  "PrefetchLoader)")
    tr_loader = DeviceDataset(tr, conf.batch_size, dev, keys=cache_keys,
                              shuffle=True, seed=conf.seed)
    te_loader = DeviceDataset(te, conf.batch_size, dev, keys=cache_keys,
                              shuffle=False)
    tr.release_cache()
    te.release_cache()
    max_batches = (conf.max_samples_per_epoch // conf.batch_size
                   if conf.max_samples_per_epoch else 0)

    # EMA of the params for rollout selection, persisted to <model>_ema.
    ema = None
    if conf.ema_decay > 0:
        ema = {"model": copy.deepcopy(state.model),
               "decay": float(conf.ema_decay)}
        if conf.load_model and os.path.isdir(model_path + "_ema"):
            load_checkpoint(model_path + "_ema",
                            init_train_state(conf.seed, mconf, dev,
                                             model=ema["model"]))

    base_lr = mconf.optim.learning_rate
    prev_lr = None
    t_start = time.time()
    for epoch in range(start_epoch, conf.max_epochs):
        if conf.max_wall_s and epoch > start_epoch and \
                time.time() - t_start > conf.max_wall_s:
            print(f"==> wall clock {time.time() - t_start:.0f}s > "
                  f"max_wall_s {conf.max_wall_s:.0f}; exiting cleanly at "
                  f"epoch {epoch}")
            return state, mconf
        gc.collect()
        rss = _rss_gb()
        print(f"    [host RSS {rss:.1f} GB]")
        if conf.max_host_rss_gb and epoch > start_epoch and \
                rss > conf.max_host_rss_gb:
            print(f"==> host RSS {rss:.1f} GB > max_host_rss_gb "
                  f"{conf.max_host_rss_gb}; exiting for a chunk restart at "
                  f"epoch {epoch}")
            return state, mconf
        # lrEpochMults (run_epoch.lua:40-48), from scratch each epoch so a
        # resume replays every past multiplier.
        lr = base_lr
        for ep_at, mult in conf.lr_epoch_mults:
            if epoch >= ep_at:
                lr *= mult
        if lr != prev_lr:
            state = set_learning_rate(state, lr)
            if prev_lr is not None:
                print(f"==> LR -> {lr}")
            prev_lr = lr
        t0 = time.time()
        if conf.train:
            state, tr_m = _epoch(tr_loader, state, mconf, conf, py_rng, True,
                                 max_batches, _horizon_for(conf, mconf,
                                                           epoch), ema)
        else:
            tr_m = {k: 0.0 for k in ("total", "p", "u", "div",
                                     "long_term_div", "rejected")}
        te_m = tr_m
        if conf.eval_during_training:
            _, te_m = _epoch(te_loader, state, mconf, conf, py_rng, False,
                             max_batches)
        rollout_div = float("nan")
        if conf.rollout_select_steps and conf.eval_during_training and \
                mconf.sim_method == "convnet":
            sel = state if ema is None else TrainState(
                ema["model"], state.opt_state, state.step)
            rollout_div = _rollout_metric(te_loader, sel.model, mconf,
                                          conf.rollout_select_steps)
            if rollout_div < best_rollout:
                best_rollout = rollout_div
                save_checkpoint(model_path + "_bestRollout", sel, mconf,
                                {"epoch": epoch + 1,
                                 "rollout_div": rollout_div,
                                 "ema": ema is not None})
            if ema is not None:
                save_checkpoint(model_path + "_ema", sel, mconf,
                                {"epoch": epoch + 1})
        rej = tr_m.get("rejected", 0.0)
        print(f"epoch {epoch}: train {tr_m['total']:.4e} (div "
              f"{tr_m['div']:.4e}, lt {tr_m['long_term_div']:.4e}) | test "
              f"{te_m['total']:.4e} | rollout||div|| {rollout_div:.3e} | "
              f"{time.time() - t0:.1f}s"
              + (f" | REJECTED {rej:.1%} of updates" if rej > 0 else ""))
        logger.add([epoch, tr_m["total"], tr_m["p"], tr_m["u"], tr_m["div"],
                    tr_m["long_term_div"], te_m["total"], te_m["p"],
                    te_m["u"], te_m["div"], te_m["long_term_div"]])
        extra = {"epoch": epoch + 1, "best_loss": best_loss,
                 "best_rollout": best_rollout}
        save_checkpoint(model_path + "_lastEpoch", state, mconf, extra)
        if te_m["total"] < best_loss:
            best_loss = te_m["total"]
            extra["best_loss"] = best_loss
            save_checkpoint(model_path, state, mconf, extra)
            print(f"    - new best test loss {best_loss:.4e}; saved "
                  f"{model_path}")
    return state, mconf


def main(argv=None):
    conf = parse_args(default_conf(), argv if argv is not None
                      else sys.argv[1:])
    return run_training(conf)


if __name__ == "__main__":
    main()
