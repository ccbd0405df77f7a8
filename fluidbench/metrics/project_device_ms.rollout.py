"""project_device_ms.rollout (ms): device time a rollout step of the
kernels, copies and fills launched while sim.project was the innermost
layer span open on the main thread, over pass B of fluidbench/layers.py
(traced); sim.project covers the model and the polish. Layer: the
projection. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "device_ms", "sim.project")
