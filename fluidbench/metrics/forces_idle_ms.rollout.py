"""forces_idle_ms.rollout (ms): idle device time a rollout step in gaps
whose middle falls while sim.forces was the innermost layer span open on
the main thread, over pass B of fluidbench/layers.py (traced);
sim.forces covers K2's prologue in sim/simulate._convnet_projection.
Layer: the forces. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "idle_ms", "sim.forces")
