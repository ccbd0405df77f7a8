"""join_device_ms.rollout (ms): device time a rollout step of the work
launched while model.join (the banks' join: the concat, and for mres the
nearest upsampling before it) was the innermost model span open on the
main thread (fluidbench/inner_spans.py, traced). Layer: the banks. Moves
steps_per_s."""

from fluidbench import inner_spans


def read(s):
    return inner_spans.read(s, "model.join")
