#!/usr/bin/env python3
"""The host route's copy of a batch to the GPU, two ways, timed in turns
in one process: a ring of pinned host buffers, and the plain copy.

    python3 scripts/torch_feed_ab.py [--rounds 3] [--repeat 5]
        [--threads 8] [--batch 6] [--res 64] [--n_future 4]

- ring: each batch is staged (one host memcpy a field) into one of a ring
  of 4 pinned buffers a field, then copied with copy_(non_blocking=True)
  on the current stream; a CUDA event recorded after a slot's copies is
  waited on before the slot is filled again.
- plain: `torch.from_numpy(a).to(dev)` on each field of the pageable
  numpy batch.

The data: 12 samples of m3d_v5's recipe at `--res`^3 with the six fields
the host route moves (random obstacles, divergence-free noise, random
density; numpy, seed 29), repeated `--repeat` times, so an epoch of batch
6 is 10 batches, more than twice the loader's queue of 4.
`PrefetchLoader` (`--threads` workers) assembles the batches. Each epoch
runs train_step at horizon `--n_future` on every batch, the m3d_v5 recipe
from a fresh random model (seed 17). Rounds run ring, plain, plain, ring.
Per epoch: ms per step (host clock, the epoch over its batches), the main
thread's ms a batch in the copy's call, the copies' device ms (CUDA
events) and the loader's wait a batch.

Then the ring's reuse under load: a ~0.2 s sleep kernel is queued, an
epoch's batches fed with no train step and no host sync, and every slot
wait that finds its copy still in flight counted; every batch must equal
the dataset's `get_batch(idx)` to the bit (both feeds are checked so).

Prints the card's name and power limit, one line per epoch, then one JSON
object. Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_profile_step import TRAIN_RECIPE  # noqa: E402

from fluidnet_tpu_torch.core import config as cfg  # noqa: E402
from fluidnet_tpu_torch.data import generate as gen  # noqa: E402
from fluidnet_tpu_torch.data.dataset import (HOST_KEYS,  # noqa: E402
                                             PrefetchLoader)
from fluidnet_tpu_torch.train import train  # noqa: E402

DEPTH = 4
SLEEP_CYCLES = 400_000_000      # ~0.2 s at the H100's 1.98 GHz


class Repeated:
    """`samples` (dicts of (1, C, Z, Y, X) numpy arrays) repeated `times`
    over, with FluidDataset's get_batch on cached samples."""

    def __init__(self, samples, times):
        self.samples, self.times = samples, times

    def __len__(self):
        return len(self.samples) * self.times

    def get_batch(self, idx):
        n = len(self.samples)
        return {k: np.concatenate([self.samples[int(i) % n][k]
                                   for i in idx]) for k in HOST_KEYS}


def make_samples(n, res, seed=29):
    rng = np.random.default_rng(seed)
    zyx = (res,) * 3
    out = []
    for _ in range(n):
        amp = float(rng.random() * 4 + 1)
        out.append({
            "flags": gen.random_obstacle_flags(rng, zyx, True),
            "u_div": gen.divergence_free_noise(rng, zyx, True,
                                               amplitude=amp)
            .astype(np.float32),
            "u_target": gen.divergence_free_noise(rng, zyx, True,
                                                  amplitude=amp)
            .astype(np.float32),
            "p_div": np.zeros((1, 1) + zyx, np.float32),
            "p_target": (0.01 * rng.standard_normal((1, 1) + zyx))
            .astype(np.float32),
            "density": rng.random((1, 1) + zyx).astype(np.float32)})
    return out


class RingFeed:
    """A ring of DEPTH pinned buffers a field, an event a slot."""

    def __init__(self, dev, shapes):
        self.dev = dev
        self.slots = [{k: torch.empty(s, dtype=d, pin_memory=True)
                       for k, (s, d) in shapes.items()}
                      for _ in range(DEPTH)]
        self.events = [None] * DEPTH
        self.next = 0
        self.live = 0

    def __call__(self, batch):
        s, self.next = self.next, (self.next + 1) % DEPTH
        ev = self.events[s]
        if ev is not None:
            if not ev.query():
                self.live += 1
            ev.synchronize()
        out = {}
        for k, a in batch.items():
            slot = self.slots[s][k][:a.shape[0]]
            slot.copy_(torch.from_numpy(a))
            out[k] = torch.empty(slot.shape, dtype=slot.dtype,
                                 device=self.dev).copy_(slot,
                                                        non_blocking=True)
        self.events[s] = torch.cuda.Event()
        self.events[s].record()
        return out


class PlainFeed:
    def __init__(self, dev, shapes):
        self.dev = dev

    def __call__(self, batch):
        return {k: torch.from_numpy(a).to(self.dev) for k, a in batch.items()}


FEEDS = {"ring": RingFeed, "plain": PlainFeed}


def run_epoch(feed, loader, mconf, n_future, dev, seed):
    """Returns (ms per step, the main thread's ms a batch in the feed, the
    copies' device ms a batch, the loader's wait ms a batch)."""
    state = train.init_train_state(17, mconf, dev)
    feed_s, events = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nb = 0
    for batch, _ in loader.epoch():
        start, done = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        t1 = time.perf_counter()
        start.record()
        db = feed(batch)
        done.record()
        feed_s.append(time.perf_counter() - t1)
        events.append((start, done))
        g = torch.Generator().manual_seed(seed * 1000 + nb)
        state, _ = train.train_step(state, db, g, mconf, n_future)
        nb += 1
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / nb
    copy = [a.elapsed_time(b) for a, b in events]
    return (ms, 1e3 * statistics.mean(feed_s), statistics.mean(copy),
            1e3 * statistics.mean(loader.waits))


def reuse_check(name, feed, loader, ds):
    """Feeds one epoch behind a queued 0.2 s sleep kernel, no host sync
    between batches; every batch must equal get_batch(idx)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    got = [(feed(batch), idx) for batch, idx in loader.epoch()]
    torch.cuda.synchronize()
    for db, idx in got:
        host = ds.get_batch(idx)
        for k, v in db.items():
            if not np.array_equal(v.cpu().numpy(), host[k]):
                raise AssertionError(f"{name}: a batch's {k} differs from "
                                     f"get_batch({list(idx)})")
    return len(got)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--n_future", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_feed_ab.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    mconf = cfg.parse_args(cfg.default_conf(), TRAIN_RECIPE).new_model
    ds = Repeated(make_samples(12, args.res), args.repeat)
    first = ds.get_batch(range(args.batch))
    shapes = {k: (v.shape, torch.from_numpy(v).dtype)
              for k, v in first.items()}
    mib = sum(v.nbytes for v in first.values()) / 2**20
    feeds = {k: f(dev, shapes) for k, f in FEEDS.items()}

    def loader(seed):
        return PrefetchLoader(ds, args.batch, args.threads, shuffle=True,
                              seed=seed)

    run_epoch(feeds["plain"], loader(0), mconf, args.n_future, dev, 0)
    res = {k: [] for k in FEEDS}
    for r in range(args.rounds):
        for name in ("ring", "plain", "plain", "ring"):
            out = run_epoch(feeds[name], loader(r + 1), mconf,
                            args.n_future, dev, r + 1)
            res[name].append(out)
            print(f"round {r} {name}: {out[0]:.3f} ms a step, feed "
                  f"{out[1]:.3f} ms a batch on the main thread, copies "
                  f"{out[2]:.3f} device ms, loader wait {out[3]:.3f} ms",
                  flush=True)
    summary = {}
    for name, rows in res.items():
        step, feed, copy, wait = zip(*rows)
        summary[name] = {
            "step_ms": list(step), "median_step_ms": statistics.median(step),
            "feed_ms": list(feed), "median_feed_ms": statistics.median(feed),
            "copy_ms": list(copy), "median_copy_ms": statistics.median(copy),
            "copy_mb_s": mib * 2**20 / 1e3 / statistics.median(copy),
            "wait_ms": list(wait)}
    reuse = {}
    for name in FEEDS:
        live0 = getattr(feeds[name], "live", 0)
        n = reuse_check(name, feeds[name], loader(99), ds)
        reuse[name] = {"batches": n,
                       "waits_in_flight": getattr(feeds[name], "live", 0)
                       - live0}
    print(f"reuse under a queued sleep: {reuse}; every batch equal to "
          "get_batch", flush=True)
    print(json.dumps({"mib_per_batch": mib, "batches_per_epoch":
                      -(-len(ds) // args.batch), "threads": args.threads,
                      "n_future": args.n_future, "feeds": summary,
                      "reuse": reuse}))


if __name__ == "__main__":
    main()
