"""mfu_banks.rollout (%): the banked trunk's operations a step
(fluidbench/flops_banks.py, every bank at its own size) times the steps,
over the unprofiled stretch's host-clock seconds, as a share of the
chip's bf16 peak (the trunk's precision; peaks.json). The whole step: a
kernel taken off the path leaves this standing. Layer: the device. Moves
steps_per_s."""

from fluidbench import flops_banks
from fluidbench.weights import in_channels


def read(s):
    if s.kind != "rollout" or not s.kernels:
        return None
    m = s.config["mconf"]
    res = round(s.cells_per_sample ** (1 / 3))
    ops = flops_banks.model_flops(s.config["layers"], m, in_channels(m),
                                  (res, res, res)) * s.batch * s.steps
    return 100.0 * ops / s.plain_wall_s / s.peaks["bf16_flop_s"]
