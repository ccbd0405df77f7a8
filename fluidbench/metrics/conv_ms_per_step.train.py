"""conv_ms_per_step.train (ms): device time of the convolutions (forward
and backward) a train step. Layer: the projection (models/fluidnet:
cuDNN conv3d). Moves train_samples_per_s."""

from fluidbench.kernels import convolutions


def read(s):
    if s.kind != "train" or not s.kernels:
        return None
    return 1e3 * s.kernel_s(convolutions.matches) / s.steps
