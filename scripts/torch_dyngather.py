#!/usr/bin/env python3
"""The dyngather probe on the GPU: kernel K7 of the PyTorch port.

The counterpart of scripts/test_dyngather.py, which asks whether Mosaic
lowers a lane-dim and a sublane-dim `take_along_axis` on a (128, 128)
float32 block: this builds the port's CUDA kernel
(fluidnet_tpu_torch/csrc/dyngather.cu), runs both forms on the card and
checks each against np.take_along_axis on the same inputs (src from numpy
seed 0, indices in [0, 128) from seed 1). Prints one line per form and
exits 1 if either is wrong or there is no CUDA device.

    python3 scripts/torch_dyngather.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fluidnet_tpu_torch.ops.cuda.dyngather import take_along_axis  # noqa


def run(axis, name, dev):
    src = np.random.default_rng(0).standard_normal((128, 128)).astype(
        np.float32)
    idx = np.random.default_rng(1).integers(0, 128, (128, 128)).astype(
        np.int32)
    out = take_along_axis(torch.from_numpy(src).to(dev),
                          torch.from_numpy(idx).to(dev), axis)
    ok = np.array_equal(out.cpu().numpy(),
                        np.take_along_axis(src, idx, axis=axis))
    print(f"{name}: COMPILES, correct={ok}")
    return ok


def main(dev=None):
    """Both forms on `dev` (the CUDA device by default); 0 if both are
    right, else 1."""
    if dev is None:
        if not torch.cuda.is_available():
            print("torch_dyngather: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda", 0)
    oks = [run(1, "lane gather (axis=1)", dev),
           run(0, "sublane gather (axis=0)", dev)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main())
