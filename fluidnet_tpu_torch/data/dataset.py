"""Dataset: paired divergent/corrected frames, and the two routes that
feed them to training.

Port of fluidnet_tpu.data.dataset (torch.DataBinary and torch.DataParallel,
torch/lib/data_binary.lua, data_parallel.lua):

  - FluidDataset scans <data_dir>/<dataset>/{tr,te}/<run>/NNNNNN.bin
    (+ _divergent.bin), drops runs whose target divergence exceeds 1e-2
    (data_binary.lua:29, 126-134); a sample is a (run, frame) pair, a batch
    {p_div, u_div, density, flags, p_target, u_target, density_target} of
    numpy arrays, read in NumPy and cached in RAM.
  - DeviceDataset uploads every sample to the device once; a batch is an
    index_select per field (the JAX package's on-device gathers).
  - PrefetchLoader, for datasets past the device cache: worker threads
    assemble numpy batches ahead of the training loop, and DeviceFeed copies
    each to the device.
"""

import os
import queue
import threading
import time

import numpy as np
import torch

from fluidnet_tpu_torch.data.manta_io import load_manta_file
from fluidnet_tpu_torch.ops.divergence import velocity_divergence

DIV_SCREEN_THRESHOLD = 1e-2  # data_binary.lua:29
FIELDS = ("p_div", "u_div", "density", "flags", "p_target", "u_target",
          "density_target")
# The fields the host route moves to the device (the JAX package's host
# route passes these six).
HOST_KEYS = ("p_div", "u_div", "flags", "p_target", "u_target", "density")


def epoch_chunks(order, batch_size, drop_last=False, max_batches=0):
    """An epoch's batches of sample indices: `order` cut into pieces of
    batch_size, the short last one dropped with drop_last, the first
    max_batches kept (every one when 0)."""
    chunks = [order[i:i + batch_size]
              for i in range(0, len(order), batch_size)]
    if drop_last:
        chunks = [c for c in chunks if len(c) == batch_size]
    return chunks[:max_batches] if max_batches else chunks


class FluidDataset:
    def __init__(self, data_dir, dataset, split="tr", ignore_frames=0,
                 screen_divergent_runs=True, cache=True):
        self.root = os.path.join(data_dir, dataset, split)
        if not os.path.isdir(self.root):
            raise FileNotFoundError(self.root)
        self.cache = {} if cache else None
        self.samples = []  # (run_dir, frame file name)
        runs = sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))
        for run in runs:
            rd = os.path.join(self.root, run)
            frames = sorted(f for f in os.listdir(rd)
                            if f.endswith(".bin") and
                            not f.endswith("_divergent.bin"))
            frames = frames[ignore_frames:]
            if not frames:
                continue
            if screen_divergent_runs and self._run_diverged(rd, frames):
                continue
            for f in frames:
                if os.path.exists(os.path.join(rd, f[:-4] +
                                               "_divergent.bin")):
                    self.samples.append((rd, f))
        if not self.samples:
            raise RuntimeError(f"no samples found under {self.root}")
        first = self._load(*self.samples[0])
        self.is_3d = first["is_3d"]
        self.shape_zyx = first["p_div"].shape[2:]

    def _run_diverged(self, run_dir, frames):
        """Screens runs whose TARGET field still has a large divergence
        (data_binary.lua:126-134); only the last frame is checked."""
        d = load_manta_file(os.path.join(run_dir, frames[-1]))
        div = velocity_divergence(torch.from_numpy(d["U"]),
                                  torch.from_numpy(d["flags"]))
        return float(div.abs().max()) > DIV_SCREEN_THRESHOLD

    def _load(self, run_dir, fname):
        key = (run_dir, fname)
        if self.cache is not None and key in self.cache:
            return self.cache[key]
        tgt = load_manta_file(os.path.join(run_dir, fname))
        div = load_manta_file(os.path.join(run_dir,
                                           fname[:-4] + "_divergent.bin"))
        sample = {"p_div": div["p"], "u_div": div["U"],
                  "density": div["density"], "flags": tgt["flags"],
                  "p_target": tgt["p"], "u_target": tgt["U"],
                  "density_target": tgt["density"], "is_3d": tgt["is_3d"]}
        if self.cache is not None:
            self.cache[key] = sample
        return sample

    def __len__(self):
        return len(self.samples)

    def _strided(self, max_samples):
        """Every step-th sample, step = len // min(len, max_samples)."""
        step = max(1, len(self) // min(len(self), max_samples))
        return [self._load(*self.samples[i])
                for i in range(0, len(self), step)]

    def field_stats(self, fields=("p_div", "u_div", "density"),
                    max_samples=64):
        """Per-field mean/std/min/max over (up to about) max_samples
        samples, the reference's dataset statistics pass
        (data_binary.lua:265-354). Returns {field: {mean, std, min, max}}."""
        items = self._strided(max_samples)
        out = {}
        for f in fields:
            a = np.stack([np.asarray(it[f], np.float64) for it in items])
            out[f] = {"mean": float(a.mean()), "std": float(a.std()),
                      "min": float(a.min()), "max": float(a.max())}
        return out

    def histogram(self, field="u_div", bins=64, value_range=None,
                  max_samples=64):
        """Histogram of a field's values over the dataset
        (data_binary.lua:467-556's gnuplot histograms). Returns (counts,
        bin_edges); utils.plots.plot_histogram draws it."""
        vals = [np.asarray(it[field]).ravel()
                for it in self._strided(max_samples)]
        return np.histogram(np.concatenate(vals), bins=bins,
                            range=value_range)

    def release_cache(self):
        """Frees the host frame cache and stops caching (after a
        DeviceDataset upload, batches are device gathers)."""
        self.cache = None

    def get_batch(self, indices):
        """A batch dict of stacked numpy arrays
        (AllocateBatchMemory/CreateBatch, data_binary.lua:356-453)."""
        items = [self._load(*self.samples[i]) for i in indices]
        return {k: np.concatenate([it[k] for it in items], axis=0)
                for k in FIELDS}


class DeviceDataset:
    """Every sample of `dataset` on `device` (the fields in `keys`), and
    batches assembled there with index_select. Epochs are sequences of
    index arrays (shuffled with a numpy generator seeded `seed`)."""

    def __init__(self, dataset, batch_size, device,
                 keys=("p_div", "u_div", "flags", "p_target", "u_target",
                       "density"), shuffle=True, seed=0, upload_chunk=32):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        n = len(dataset)
        first = dataset.get_batch([0])
        keys = [k for k in keys if k in first]
        self.dev = {k: torch.empty((n,) + first[k].shape[1:],
                                   dtype=torch.from_numpy(first[k]).dtype,
                                   device=device) for k in keys}
        for lo in range(0, n, upload_chunk):
            host = dataset.get_batch(range(lo, min(lo + upload_chunk, n)))
            for k in keys:
                self.dev[k][lo:lo + host[k].shape[0]].copy_(
                    torch.from_numpy(host[k]))

    def __len__(self):
        return len(self.dataset)

    def num_batches(self, drop_last=False, max_batches=0):
        return len(epoch_chunks(range(len(self)), self.batch_size,
                                drop_last, max_batches))

    def epoch_indices(self, drop_last=False, max_batches=0):
        """Yields each batch's sample indices (numpy int arrays)."""
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        yield from epoch_chunks(order, self.batch_size, drop_last,
                                max_batches)

    def batch(self, idx):
        """The batch of the sample indices `idx`, gathered on the device."""
        i = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                            device=next(iter(self.dev.values())).device)
        return {k: v.index_select(0, i) for k, v in self.dev.items()}

    def epoch(self, drop_last=False, max_batches=0):
        for c in self.epoch_indices(drop_last, max_batches):
            yield self.batch(c), c


class PrefetchLoader:
    """Threaded batch prefetcher over a dataset with get_batch(indices),
    the equivalent of torch.DataParallel (data_parallel.lua:49-194):
    `num_threads` workers take batches' indices from a queue and put the
    assembled numpy batches into a queue of `depth`; batches complete out
    of order, and every sample is delivered once per epoch. The epoch
    order is np.random.default_rng(seed).permutation, the JAX package's.

    `waits` holds the seconds the consumer waited on the queue for each
    batch of the last epoch."""

    def __init__(self, dataset, batch_size, num_threads=8, shuffle=True,
                 seed=0, depth=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_threads = max(1, num_threads)
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.depth = depth
        self.waits = []

    def num_batches(self, drop_last=False, max_batches=0):
        return len(epoch_chunks(range(len(self.dataset)), self.batch_size,
                                drop_last, max_batches))

    def epoch(self, drop_last=False, max_batches=0):
        """Yields (batch, indices) for one pass over the dataset.

        max_batches truncates the epoch (conf.maxSamplesPerEpoch,
        default_conf.lua:41) before the workers start, so no worker blocks
        on a batch that is never taken. A worker's exception is raised
        here, in the consumer."""
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        chunks = epoch_chunks(order, self.batch_size, drop_last, max_batches)

        out_q = queue.Queue(maxsize=self.depth)
        in_q = queue.Queue()
        for c in chunks:
            in_q.put(c)

        def worker():
            while True:
                try:
                    idx = in_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    out_q.put((self.dataset.get_batch(idx), idx))
                except Exception as e:  # handed to the consumer
                    out_q.put((e, idx))
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        self.waits = []
        seen = set()
        for _ in range(len(chunks)):
            t0 = time.perf_counter()
            batch, idx = out_q.get()
            self.waits.append(time.perf_counter() - t0)
            if isinstance(batch, Exception):
                raise RuntimeError(f"PrefetchLoader: get_batch({list(idx)})"
                                   f" failed") from batch
            for i in idx:
                # Double-count guard (run_epoch.lua:124-127).
                assert int(i) not in seen, "double-counted sample!"
                seen.add(int(i))
            yield batch, idx
        for t in threads:
            t.join()


class DeviceFeed:
    """The host route's copies to the device: each (batch, indices) of a
    PrefetchLoader's epoch, with the fields in HOST_KEYS, as tensors on
    `device`, each field copied with torch.from_numpy(a).to(device). (A
    ring of pinned buffers with non-blocking copies took as long a train
    step on the H100: scripts/torch_feed_ab.py.)

    `stats`: batches, bytes moved, and the seconds the main thread spent
    in the copies (on a CUDA device, until each copy had finished)."""

    def __init__(self, loader, device):
        self.loader = loader
        self.device = torch.device(device)
        self.stats = {"batches": 0, "bytes": 0, "copy_s": 0.0}

    def num_batches(self, drop_last=False, max_batches=0):
        return self.loader.num_batches(drop_last, max_batches)

    def epoch(self, drop_last=False, max_batches=0):
        for batch, idx in self.loader.epoch(drop_last, max_batches):
            t0 = time.perf_counter()
            out = {k: torch.from_numpy(batch[k]).to(self.device)
                   for k in HOST_KEYS}
            self.stats["copy_s"] += time.perf_counter() - t0
            self.stats["batches"] += 1
            self.stats["bytes"] += sum(batch[k].nbytes for k in out)
            yield out, idx

    def report(self):
        """One line: the wait on the loader a batch in its last epoch, and
        the copies' ms a batch and rate since the feed was made."""
        w, st = self.loader.waits, self.stats
        n = max(st["batches"], 1)
        line = (f"host route: loader wait {1e3 * sum(w) / max(len(w), 1):.3f}"
                f" ms a batch over {len(w)}, copies "
                f"{1e3 * st['copy_s'] / n:.3f} ms a batch")
        if st["copy_s"] > 0:
            line += (f" ({st['bytes'] / 1e6 / st['copy_s']:.1f} MB/s, "
                     f"{st['bytes'] / 2**20 / n:.1f} MiB a batch)")
        return line
