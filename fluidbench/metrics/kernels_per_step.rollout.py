"""kernels_per_step.rollout (kernels): device kernels in the trace a
rollout step. Layer: the step loop. Moves steps_per_s."""


def read(s):
    if s.kind != "rollout" or not s.kernels:
        return None
    return s.kernel_count() / s.steps
