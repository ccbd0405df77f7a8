"""mfu.rollout (%): the trunk's operations a step (flops.model_flops, a
frozen copy of utils/flops.py) times the steps, over the unprofiled
stretch's host-clock seconds, as a share of the chip's bf16 peak (the
trunk's precision; peaks.json). The whole step: a kernel taken off the
path leaves this standing. Layer: the device. Moves steps_per_s."""

from fluidbench.metrics._common import trunk_flops


def read(s):
    if s.kind != "rollout" or not s.kernels:
        return None
    ops = trunk_flops(s) * s.batch * s.steps
    return 100.0 * ops / s.plain_wall_s / s.peaks["bf16_flop_s"]
