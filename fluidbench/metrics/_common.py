"""What several readers share: the peak table, the least time of a
kernel group's work, the trunk's operations a step."""

from fluidbench.flops import model_flops
from fluidbench.kernels import (convolutions, k1, k2, k3, k4, k5, k6, k7)
from fluidbench.weights import in_channels

PORT_KERNELS = (k1, k2, k3, k4, k5, k6, k7)


def least_s(s, nbytes, flops):
    """The least time of work of `nbytes` bytes and `flops` float32
    operations on the chip: the larger of the two over their peaks."""
    return max(nbytes / s.peaks["hbm_byte_s"], flops / s.peaks["f32_flop_s"])


def roofline(s, least, group):
    """The share in % of the group's device time that its least time
    takes, or None where the group ran no kernel."""
    t = s.kernel_s(group.matches)
    return None if t <= 0 else 100.0 * least / t


def trunk_flops(s):
    """Operations of one forward pass of the trunk on one sample."""
    res = round(s.cells_per_sample ** (1 / 3))
    return model_flops(s.config["layers"], in_channels(s.config["mconf"]),
                       (res, res, res))


def is_glue(name):
    return not convolutions.matches(name) and \
        not any(k.matches(name) for k in PORT_KERNELS)
