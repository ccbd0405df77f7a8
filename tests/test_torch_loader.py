"""The host data path of the PyTorch port against the JAX package:
PrefetchLoader (every sample once an epoch, JAX's order and batches with
one thread), each loader's batch count, DeviceFeed on the CPU, and
cli/train.main on both routes (the host route and the device cache give
equal batches and params, to the bit).

The frames are written with save_manta_file from seeded numpy arrays at
8^3: small random target velocities (they pass the divergence screen) in
an obstacle border.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from fluidnet_tpu.data.dataset import FluidDataset as JFluidDataset
from fluidnet_tpu.data.dataset import PrefetchLoader as JPrefetchLoader

from fluidnet_tpu_torch.cli import train as train_cli
from fluidnet_tpu_torch.data.dataset import (FIELDS, HOST_KEYS,
                                             DeviceDataset, DeviceFeed,
                                             FluidDataset, PrefetchLoader)
from fluidnet_tpu_torch.data.manta_io import frame_name, save_manta_file

from tests.torch_port_util import DEV

RES = 8
N_FRAMES = 4


def write_dataset(root, name, runs=(("tr", 3), ("te", 1)), shape=(RES,) * 3,
                  seed=21):
    """<root>/<name>/<split>/<run>/ of N_FRAMES target and divergent frames
    each."""
    rng = np.random.default_rng(seed)
    flags = np.full((1, 1) + shape, 1, np.int32)
    flags[..., 0, :, :] = flags[..., -1, :, :] = 2
    flags[..., :, 0, :] = flags[..., :, -1, :] = 2
    flags[..., :, :, 0] = flags[..., :, :, -1] = 2

    def field(c, scale=1.0):
        return (scale * rng.standard_normal((1, c) + shape)).astype(
            np.float32)
    for split, n_runs in runs:
        for r in range(n_runs):
            d = os.path.join(root, name, split, f"{r:03d}")
            os.makedirs(d)
            for f in range(N_FRAMES):
                save_manta_file(os.path.join(d, frame_name(f, False)),
                                field(1), field(3, 1e-4), flags,
                                rng.random((1, 1) + shape, np.float32))
                save_manta_file(os.path.join(d, frame_name(f, True)),
                                field(1), field(3), flags,
                                rng.random((1, 1) + shape, np.float32))
    return str(root)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("loader"), "ds")


def assert_batches_equal(a, b, keys=FIELDS):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_prefetch_delivers_every_sample_once(root, threads):
    ds = FluidDataset(root, "ds", "tr")
    loader = PrefetchLoader(ds, 5, num_threads=threads, seed=3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for kw, want in (({}, 12), ({"max_batches": 2}, 10),
                         ({"drop_last": True}, 10)):
            got = []
            for batch, idx in loader.epoch(**kw):
                assert_batches_equal(batch, ds.get_batch(idx))
                got += [int(i) for i in idx]
            assert len(got) == len(set(got)) == want
            assert len(loader.waits) == -(-want // 5)
    finally:
        sys.setswitchinterval(old)


def test_prefetch_one_thread_matches_jax(root):
    ours = PrefetchLoader(FluidDataset(root, "ds", "tr"), 5, num_threads=1,
                          seed=0)
    ref = JPrefetchLoader(JFluidDataset(root, "ds", "tr"), 5, num_threads=1,
                          seed=0)
    for _ in range(2):
        a, b = list(ours.epoch()), list(ref.epoch())
        assert [list(i) for _, i in a] == [list(i) for _, i in b]
        for (ba, _), (bb, _) in zip(a, b):
            assert_batches_equal(ba, bb)


@pytest.mark.parametrize("kind", ["device_dataset", "prefetch", "feed"])
def test_num_batches_counts_the_epoch(root, kind):
    ds = FluidDataset(root, "ds", "tr")
    loader = {"device_dataset": lambda: DeviceDataset(ds, 5, DEV),
              "prefetch": lambda: PrefetchLoader(ds, 5, num_threads=2),
              "feed": lambda: DeviceFeed(PrefetchLoader(ds, 5, num_threads=2),
                                         DEV)}[kind]()
    for kw in ({}, {"max_batches": 2}, {"max_batches": 9},
               {"drop_last": True}, {"drop_last": True, "max_batches": 1}):
        assert loader.num_batches(**kw) == len(list(loader.epoch(**kw))), kw


class _Failing:
    def __len__(self):
        return 6

    def get_batch(self, idx):
        if 4 in idx:
            raise ValueError("bad frame")
        return {"p_div": np.zeros((len(idx), 1))}


def test_worker_error_is_raised_in_consumer():
    loader = PrefetchLoader(_Failing(), 2, num_threads=2, shuffle=False)
    with pytest.raises(RuntimeError, match="get_batch") as e:
        list(loader.epoch())
    assert isinstance(e.value.__cause__, ValueError)


def test_device_feed_on_cpu(root):
    ds = FluidDataset(root, "ds", "tr")
    feed = DeviceFeed(PrefetchLoader(ds, 5, num_threads=2, shuffle=False),
                      DEV)
    n = 0
    for batch, idx in feed.epoch():
        assert sorted(batch) == sorted(HOST_KEYS)
        host = ds.get_batch(idx)
        for k, v in batch.items():
            assert v.device == DEV and torch.equal(v,
                                                   torch.from_numpy(host[k]))
        n += len(idx)
    assert n == 12 and feed.stats["batches"] == 3
    per_sample = sum(host[k].nbytes for k in HOST_KEYS) // len(idx)
    assert feed.stats["bytes"] == per_sample * 12
    assert "loader wait" in feed.report()


def _cli_flags(root, name, *extra):
    return ["-data_dir", root, "-dataset", "ds", "-model_dir",
            os.path.join(root, "models"), "-model_filename", name,
            "-batch_size", "4", "-max_epochs", "1", "-seed", "17",
            "-profile", "false", "-rollout_select_steps", "2",
            "-ema_decay", "0.999", "-horizon_schedule", "[[0,1,2]]",
            "-num_data_threads", "1", "-load_model", "false",
            "-new_model.advection_method", "maccormackOurs",
            "-new_model.adaptive_window", "false",
            "-new_model.advection_window", "1",
            "-new_model.train_buoyancy_prob", "0.5",
            "-new_model.train_vorticity_confinement_prob", "0.3",
            "-new_model.long_term_grad_mode", "full",
            "-new_model.loss_reject_threshold", "100.0",
            "--device", "cpu", *extra]


def test_cli_host_route_matches_device_cache(root, monkeypatch):
    """One epoch on each route from the same seed, one loader thread: the
    batches handed to train_step (on the device cache's keys) and the
    params after the epoch are equal to the bit."""
    step = train_cli.train_step
    seen = {}

    def recording(route):
        def train_step(state, batch, *a, **k):
            seen[route].append({k_: v.clone() for k_, v in batch.items()})
            return step(state, batch, *a, **k)
        return train_step

    out = {}
    for route, extra in (("host", ("-device_data_cache_max_gb", "1e-6")),
                         ("cache", ())):
        seen[route] = []
        monkeypatch.setattr(train_cli, "train_step", recording(route))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out[route] = train_cli.main(_cli_flags(root, route, *extra))[0]
        assert ("==> Host route" in buf.getvalue()) == (route == "host")
    host, cache = seen["host"], seen["cache"]
    assert len(host) == len(cache) == 3
    for a, b in zip(host, cache):
        assert sorted(a) == sorted(HOST_KEYS)
        for k, v in b.items():
            assert torch.equal(a[k], v), k
    assert out["host"].step == out["cache"].step == 3
    for a, b in zip(out["host"].params, out["cache"].params):
        assert torch.equal(a, b)
