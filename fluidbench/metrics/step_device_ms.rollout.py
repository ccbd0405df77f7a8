"""step_device_ms.rollout (ms): device time a rollout step of the kernels,
copies and fills launched while sim.step was the innermost layer span
open on the main thread, over pass B of fluidbench/layers.py (traced);
sim.step covers its own time: the step's apply_boundaries calls, the
final clamp and the Python between its children (sim/simulate._step).
Layer: the step loop. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "device_ms", "sim.step")
