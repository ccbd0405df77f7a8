"""advect_host_ms.rollout (ms): the host-clock self time a rollout step of
the span sim.advect on the main thread (its duration minus the layer
spans nested in it), over pass A of fluidbench/layers.py (unprofiled,
the recorder on); sim.advect covers sim/simulate._advect (K1 and the
clamp). Layer: the advection. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "host_ms", "sim.advect")
