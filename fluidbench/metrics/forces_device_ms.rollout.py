"""forces_device_ms.rollout (ms): device time a rollout step of the
kernels, copies and fills launched while sim.forces was the innermost
layer span open on the main thread, over pass B of fluidbench/layers.py
(traced); sim.forces covers K2's prologue in
sim/simulate._convnet_projection. Layer: the forces. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "device_ms", "sim.forces")
