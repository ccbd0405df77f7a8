"""forces_host_ms.rollout (ms): the host-clock self time a rollout step of
the span sim.forces on the main thread (its duration minus the layer
spans nested in it), over pass A of fluidbench/layers.py (unprofiled,
the recorder on); sim.forces covers K2's prologue in
sim/simulate._convnet_projection. Layer: the forces. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "host_ms", "sim.forces")
