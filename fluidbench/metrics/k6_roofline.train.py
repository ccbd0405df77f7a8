"""k6_roofline.train (%): the transposed warp's least time on the chip
(its bytes at the HBM rate, 20 B a cell a field group, the train steps'
groups by their horizons; kernels/k6.py) over K6's device time. Layer:
the autograd (ops/cuda/warp_transpose, K6). Moves
train_samples_per_s."""

from fluidbench.kernels import k6
from fluidbench.metrics._common import least_s, roofline


def read(s):
    if s.kind != "train":
        return None
    nbytes = sum(k6.train_step_bytes(n, s.cells) for n in s.horizons)
    return roofline(s, least_s(s, nbytes, 0), k6)
