"""kernels_per_step.train (kernels): device kernels in the trace a train
step. Layer: the trainer. Moves train_samples_per_s."""


def read(s):
    if s.kind != "train" or not s.kernels:
        return None
    return s.kernel_count() / s.steps
