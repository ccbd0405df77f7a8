"""mfu.train (%): the trunk's forward operations a sample times 3 (the
forward and the backward's two products) times the model calls of each
step (n + 1 at horizon n: the first projection, the n - 1 unroll
projections, the long-term one) times the batch, summed over the
stretch's steps, over the unprofiled stretch's host-clock seconds, as a
share of the chip's bf16 peak. Layer: the device. Moves
train_samples_per_s."""

from fluidbench.metrics._common import trunk_flops


def read(s):
    if s.kind != "train" or not s.kernels:
        return None
    ops = 3 * trunk_flops(s) * s.batch * sum(n + 1 for n in s.horizons)
    return 100.0 * ops / s.plain_wall_s / s.peaks["bf16_flop_s"]
