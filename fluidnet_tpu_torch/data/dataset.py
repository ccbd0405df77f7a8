"""Dataset: paired divergent/corrected frames, and a device-resident copy.

Port of fluidnet_tpu.data.dataset (torch.DataBinary,
torch/lib/data_binary.lua):

  - FluidDataset scans <data_dir>/<dataset>/{tr,te}/<run>/NNNNNN.bin
    (+ _divergent.bin), drops runs whose target divergence exceeds 1e-2
    (data_binary.lua:29, 126-134); a sample is a (run, frame) pair, a batch
    {p_div, u_div, density, flags, p_target, u_target, density_target} of
    numpy arrays. Frames parse in NumPy (the JAX package's native threaded
    reader is not ported) and are cached in RAM after the first read.
  - DeviceDataset uploads every sample to the device once; a batch is an
    index_select per field (the JAX package's on-device gathers).

The JAX package's threaded PrefetchLoader (for datasets larger than the
device cache) is not ported (ROADMAP queue 1, item 11).
"""

import os

import numpy as np
import torch

from fluidnet_tpu_torch.data.manta_io import load_manta_file
from fluidnet_tpu_torch.ops.divergence import velocity_divergence

DIV_SCREEN_THRESHOLD = 1e-2  # data_binary.lua:29
FIELDS = ("p_div", "u_div", "density", "flags", "p_target", "u_target",
          "density_target")


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

    def epoch_indices(self, drop_last=False, max_batches=0):
        """Yields each batch's sample indices (numpy int arrays)."""
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        chunks = [order[i:i + self.batch_size]
                  for i in range(0, n, self.batch_size)]
        if drop_last:
            chunks = [c for c in chunks if len(c) == self.batch_size]
        if max_batches:
            chunks = chunks[:max_batches]
        yield from chunks

    def batch(self, idx):
        """The batch of the sample indices `idx`, gathered on the device."""
        i = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                            device=next(iter(self.dev.values())).device)
        return {k: v.index_select(0, i) for k, v in self.dev.items()}

    def epoch(self, drop_last=False, max_batches=0):
        for c in self.epoch_indices(drop_last, max_batches):
            yield self.batch(c), c
