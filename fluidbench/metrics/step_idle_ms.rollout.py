"""step_idle_ms.rollout (ms): idle device time a rollout step in gaps whose
middle falls while sim.step was the innermost layer span open on the
main thread, over pass B of fluidbench/layers.py (traced); sim.step
covers its own time: the step's apply_boundaries calls, the final clamp
and the Python between its children (sim/simulate._step). Layer: the
step loop. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "idle_ms", "sim.step")
