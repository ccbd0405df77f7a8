"""dilated_roofline.rollout (%): the dilated bank's convolution
operations a step (bank 1's, fluidbench/flops_banks.py, times the batch)
at the chip's bf16 peak (peaks.json), over the device time a step
launched inside model.bank1 (fluidbench/inner_spans.py, traced: its
convolutions, nonlinearity, pool and casts). The mechanism's share of its
roofline. None without banks of the dilate kind or without the span.
Layer: the banks. Moves steps_per_s."""

from fluidbench import flops_banks, inner_spans
from fluidbench.weights import in_channels


def read(s):
    m = s.config["mconf"]
    if s.kind != "rollout" or m.get("banks_num", 1) < 2 or \
            m.get("banks_type") != "dilate":
        return None
    t = inner_spans.read(s, "model.bank1")
    if not t:
        return None
    res = round(s.cells_per_sample ** (1 / 3))
    ops = flops_banks.bank_flops(s.config["layers"], m, in_channels(m),
                                 (res, res, res), 1) * s.batch
    return 100.0 * (ops / s.peaks["bf16_flop_s"]) / (t * 1e-3)
