"""step_host_ms.rollout (ms): the host-clock self time a rollout step of
the span sim.step on the main thread (its duration minus the layer spans
nested in it), over pass A of fluidbench/layers.py (unprofiled, the
recorder on); sim.step covers its own time: the step's apply_boundaries
calls, the final clamp and the Python between its children
(sim/simulate._step). Layer: the step loop. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "host_ms", "sim.step")
