"""conv_ms_per_step.rollout (ms): device time of the convolutions a
rollout step. Layer: the projection (models/fluidnet: cuDNN conv3d).
Moves steps_per_s."""

from fluidbench.kernels import convolutions


def read(s):
    if s.kind != "rollout" or not s.kernels:
        return None
    return 1e3 * s.kernel_s(convolutions.matches) / s.steps
