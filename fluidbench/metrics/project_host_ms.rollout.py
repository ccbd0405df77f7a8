"""project_host_ms.rollout (ms): the host-clock self time a rollout step of
the span sim.project on the main thread (its duration minus the layer
spans nested in it), over pass A of fluidbench/layers.py (unprofiled,
the recorder on); sim.project covers the model and the polish. Layer:
the projection. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "host_ms", "sim.project")
