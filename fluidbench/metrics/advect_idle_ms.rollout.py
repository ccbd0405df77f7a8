"""advect_idle_ms.rollout (ms): idle device time a rollout step in gaps
whose middle falls while sim.advect was the innermost layer span open on
the main thread, over pass B of fluidbench/layers.py (traced);
sim.advect covers sim/simulate._advect (K1 and the clamp). Layer: the
advection. Moves steps_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "idle_ms", "sim.advect")
