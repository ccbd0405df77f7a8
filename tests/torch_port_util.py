"""Shared helpers of the parity tests of the PyTorch port
(tests/test_torch_*.py): the same numpy inputs, made from a seed, go
through a JAX function and its fluidnet_tpu_torch counterpart, and the
outputs are compared at a stated tolerance."""

import json
import os
import shutil
import time

import numpy as np
import torch

from fluidnet_tpu.core.celltype import CellType

from tests import reference_impl as ref

# The suite runs 6 xdist workers on the CPU: keep torch from
# oversubscribing the cores.
torch.set_num_threads(2)

# The port's constructors build on the CUDA device unless told otherwise;
# the parity tests run on the CPU and say so.
DEV = torch.device("cpu")


def np_(x):
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tt(x):
    """torch (CPU) tensor holding a copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(x))


def assert_close(actual, desired, rtol, atol, what=""):
    np.testing.assert_allclose(np_(actual), np_(desired), rtol=rtol,
                               atol=atol, err_msg=what)


def random_flags(rng, shape, p_obstacle=0.15, stick_empty=False):
    """Obstacle-bordered random flags; with `stick_empty`, a few fluid
    cells become TypeStick and TypeEmpty (as tests/test_prologue.py)."""
    flags = ref.random_flags(rng, shape, p_obstacle=p_obstacle)
    if stick_empty:
        stick = rng.random(flags.shape) < 0.08
        flags = np.where(stick & (flags == CellType.TypeFluid),
                         CellType.TypeStick, flags)
        empty = rng.random(flags.shape) < 0.05
        flags = np.where(empty & (flags == CellType.TypeFluid),
                         CellType.TypeEmpty, flags)
    return flags.astype(np.int32)


BUNDLED_3D = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "models_bundled",
    "m3d_v5_bestRollout")


def float32_copy(src, dst):
    """A copy of checkpoint directory `src` at `dst` whose mconf runs the
    convolutions in float32 (same weights). The JAX 3-D bf16 trunk sums its
    three kz partial convolutions in bf16, two roundings the port's trunk
    does not make (tests/test_torch_model.py), so parity tests that step a
    bundled bf16 model hold a float32 copy to a float32 tolerance."""
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "mconf.json")) as f:
        meta = json.load(f)
    meta["mconf"]["conv_compute_dtype"] = "float32"
    with open(os.path.join(dst, "mconf.json"), "w") as f:
        json.dump(meta, f)
    return dst


def jax_native():
    """fluidnet_tpu.native with its library loaded. The JAX package compiles
    the library in place at first use, so a test worker that loads it while
    another worker compiles it can find a half-written file: retry."""
    import fluidnet_tpu.native as j_native
    for _ in range(10):
        if j_native.get_lib() is not None:
            return j_native
        j_native._tried = False
        time.sleep(1)
    raise AssertionError("the JAX package's native library does not load")
