"""glue_ms_per_step.train (ms): device time a train step of every kernel
that is none of the port's (K1-K7) and no convolution: PyTorch's
elementwise, reduction and copy kernels of the autograd's plain
compositions (ops/replay.py, torch.utils.checkpoint's recompute) and of
the step around them. Layer: the autograd. Moves train_samples_per_s."""

from fluidbench.metrics._common import is_glue


def read(s):
    if s.kind != "train" or not s.kernels:
        return None
    return 1e3 * s.kernel_s(is_glue) / s.steps
