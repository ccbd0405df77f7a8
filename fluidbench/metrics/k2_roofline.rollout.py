"""k2_roofline.rollout (%): the projection prologue's least time on the
chip (kernels/k2.py) over K2's device time, in the rollout's steps.
Layer: the forces (ops/prologue, K2 csrc/prologue.cu). Moves
steps_per_s."""

from fluidbench.kernels import k2
from fluidbench.metrics._common import least_s, roofline


def read(s):
    if s.kind != "rollout":
        return None
    nbytes, flops = k2.step_cost(s.cells, s.slab_cells)
    return roofline(s, least_s(s, nbytes * s.steps, flops * s.steps), k2)
