"""The data path of the PyTorch port against the JAX package: manta frame
files, self-generated runs, FluidDataset batches and the device cache.

One tiny 3-D dataset is generated by each package with the same seed and
settings (8^3, one train and one test run of 3 frames, PCG max_iter 300):
the numpy draws are the same, so the port's frames must match JAX's, to a
tolerance for what the PCG projections (XLA's and PyTorch's sums) and the
advection produce: rtol 1e-3, atol 1e-4. The JAX side runs as its suite
does (interpret-mode Pallas).
"""

import os

import numpy as np
import pytest
import torch

from fluidnet_tpu.data import manta_io as j_io
from fluidnet_tpu.data.dataset import FluidDataset as JFluidDataset
from fluidnet_tpu.data.generate import generate_dataset as j_generate

from fluidnet_tpu_torch.data import manta_io
from fluidnet_tpu_torch.data.dataset import DeviceDataset, FluidDataset
from fluidnet_tpu_torch.data.generate import generate_dataset

from tests.torch_port_util import DEV

GEN = dict(n_tr=1, n_te=1, seed=4, size_xyz=(8, 8, 8), is_3d=True,
           n_frames=3, max_iter=300)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    j_generate(str(root / "jax"), **GEN)
    res = []
    generate_dataset(str(root / "port"), residuals=res, device=DEV, **GEN)
    return root, res


def _frames(root, name):
    out = []
    for split in ("tr", "te"):
        d = os.path.join(root, name, split, "000")
        out += [os.path.join(split, "000", f) for f in sorted(os.listdir(d))]
    return out


def test_generated_frames_match_jax(datasets):
    root, res = datasets
    names = _frames(root, "jax")
    assert names == _frames(root, "port") and len(names) == 12
    assert max(res) < 1e-4
    for f in names:
        a = manta_io.load_manta_file(os.path.join(root, "port", f))
        b = j_io.load_manta_file(os.path.join(root, "jax", f))
        assert a["is_3d"] and b["is_3d"]
        np.testing.assert_array_equal(a["flags"], b["flags"])
        for k in ("U", "p", "density"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-4,
                                       err_msg=f"{f}: {k}")


def test_manta_files_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    for c in (2, 3):
        shape = (1, 1, 1 if c == 2 else 5, 6, 7)
        p = rng.standard_normal(shape).astype(np.float32)
        u = rng.standard_normal((1, c) + shape[2:]).astype(np.float32)
        flags = rng.integers(1, 3, shape).astype(np.int32)
        rho = rng.random(shape).astype(np.float32)
        a, b = tmp_path / f"port{c}.bin", tmp_path / f"jax{c}.bin"
        manta_io.save_manta_file(str(a), p, u, flags, rho)
        j_io.save_manta_file(str(b), p, u, flags, rho)
        assert a.read_bytes() == b.read_bytes()
        back = manta_io.load_manta_file(str(a))
        np.testing.assert_array_equal(back["U"], u)
        np.testing.assert_array_equal(back["flags"], flags)
    assert manta_io.frame_name(7, True) == j_io.frame_name(7, True)


def test_dataset_batches_match_jax(datasets):
    """FluidDataset on the JAX-written dataset (the divergent-run screen
    included), then the device cache's gathers."""
    root, _ = datasets
    for split in ("tr", "te"):
        ours = FluidDataset(str(root), "jax", split)
        ref = JFluidDataset(str(root), "jax", split)
        assert len(ours) == len(ref) == 3 and ours.is_3d
        idx = [2, 0]
        a, b = ours.get_batch(idx), ref.get_batch(idx)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    dev = DeviceDataset(ours, 2, DEV, shuffle=False)
    batches = list(dev.epoch())
    assert [list(i) for _, i in batches] == [[0, 1], [2]]
    for batch, i in batches:
        host = ours.get_batch(i)
        for k, v in batch.items():
            assert torch.equal(v, torch.from_numpy(host[k]))
