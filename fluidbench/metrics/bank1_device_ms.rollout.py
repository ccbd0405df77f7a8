"""bank1_device_ms.rollout (ms): device time a rollout step of the
kernels, copies and fills launched while model.bank1 (bank 1's
stages between the split and the join of a banked ConvNet) was the
innermost model span open on the main thread (fluidbench/inner_spans.py,
traced). Layer: the banks. Moves steps_per_s."""

from fluidbench import inner_spans


def read(s):
    return inner_spans.read(s, "model.bank1")
