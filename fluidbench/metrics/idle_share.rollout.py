"""idle_share.rollout (%): the share of the traced stretch in which no
kernel, copy or fill ran on the device (1 - the union of their
intervals over the stretch). Layer: the device. Moves steps_per_s."""


def read(s):
    if s.kind != "rollout" or not s.kernels:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
