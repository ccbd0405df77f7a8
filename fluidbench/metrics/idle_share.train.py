"""idle_share.train (%): the share of the traced stretch of train steps
in which no kernel, copy or fill ran on the device. Layer: the device.
Moves train_samples_per_s."""


def read(s):
    if s.kind != "train" or not s.kernels:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
