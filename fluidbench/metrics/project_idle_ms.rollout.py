"""project_idle_ms.rollout (ms): idle device time a rollout step in gaps
whose middle falls while sim.project was the innermost layer span open
on the main thread, over pass B of fluidbench/layers.py (traced);
sim.project covers the model and the polish. Layer: the projection.
Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "idle_ms", "sim.project")
