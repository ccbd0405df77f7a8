"""k1_roofline.rollout (%): the advection's least time on the chip (its
bytes at the HBM rate or its float32 operations at the peak, the larger;
kernels/k1.py) over K1's device time, in the rollout's steps. Layer: the
advection (ops/advect_fast, K1 csrc/mac_sweep.cu). Moves steps_per_s."""

from fluidbench.kernels import k1
from fluidbench.metrics._common import least_s, roofline


def read(s):
    if s.kind != "rollout":
        return None
    nbytes, flops = k1.step_cost(s.cells)
    return roofline(s, least_s(s, nbytes * s.steps, flops * s.steps), k1)
