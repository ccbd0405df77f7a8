"""K7's plain version (fluidnet_tpu_torch.ops.cuda.dyngather) against the
probe's own Pallas kernels (scripts/test_dyngather.py::k_lane, ::k_sublane)
run in interpret mode with the script's BlockSpecs, and against
np.take_along_axis. A gather moves values without arithmetic: the
tolerance is exact equality.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fluidnet_tpu_torch.ops.cuda import _build
from fluidnet_tpu_torch.ops.cuda.dyngather import (take_along_axis,
                                                   take_along_axis_plain)

from tests.torch_port_util import tt

_PROBE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "test_dyngather.py")


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("dyngather_probe", _PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(0, n, shape).astype(np.int32)
    return src, idx


@pytest.mark.parametrize("axis", [1, 0])
def test_plain_matches_probe_kernel(probe, axis):
    """The probe's (128, 128) case: its kernel in interpret mode, its
    BlockSpecs, inputs from numpy seeds 0 and 1."""
    src, _ = _inputs((128, 128), 128, 0)
    _, idx = _inputs((128, 128), 128, 1)
    kern = probe.k_lane if axis == 1 else probe.k_sublane
    out = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(src), jnp.asarray(idx))
    got = take_along_axis_plain(tt(src), tt(idx), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(src, idx, axis=axis))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("axis", [1, 0])
def test_non_square_and_wrapper(axis, dtype):
    """37x61 (a swapped stride cannot pass), int32 and int64 indices; the
    wrapper takes the plain version for CPU tensors and counts no
    launch."""
    src, _ = _inputs((37, 61), 1, 2)
    _, idx = _inputs((37, 61), 61 if axis == 1 else 37, 3)
    idx = idx.astype(dtype)
    before = _build.launches["dyngather"]
    got = take_along_axis(tt(src), tt(idx), axis)
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(src, idx, axis=axis))
    assert _build.launches["dyngather"] == before


def test_rejects_bad_arguments():
    src, idx = _inputs((8, 9), 8, 4)
    with pytest.raises(ValueError):
        take_along_axis(tt(src).double(), tt(idx), 1)
    with pytest.raises(ValueError):
        take_along_axis(tt(src), tt(idx).float(), 1)
    with pytest.raises(ValueError):
        take_along_axis(tt(src), tt(idx)[:4], 1)
    with pytest.raises(ValueError):
        take_along_axis(tt(src), tt(idx), 2)
    bad = idx.copy()
    bad[0, 0] = -1     # row 0, index -1: no wrap to the last element
    with pytest.raises(IndexError):
        take_along_axis(tt(src), tt(bad), 1)
    bad[0, 0] = 9
    bad[-1, -1] = 9    # past the last element
    with pytest.raises(IndexError):
        take_along_axis(tt(src), tt(bad), 1)
    assert torch.equal(take_along_axis(tt(src), tt(idx), 0),
                       take_along_axis_plain(tt(src), tt(idx), 0))
