"""Card-vs-CPU comparison of the exact advection's line traces.

`record_traces` runs a function and keeps the arguments of every
ops/line_trace.py::line_trace call that ops/advect.py made in it;
`branch_diff` runs those traces again on the CPU and on the card from the
same inputs and counts the rays whose decisions or results differ. Used by
chip_smoke.py's exact-route phase and tests/test_torch_cuda.py.
"""

import torch

from fluidnet_tpu_torch.ops import advect
from fluidnet_tpu_torch.ops.line_trace import line_trace

TRACE_KEYS = ("hit", "cell", "position", "out_of_domain", "border_hit",
              "blocked", "box_fail", "backoffs")
SQRT_KEYS = ("sqrt_cpu_vs_card", "sqrt_cpu_inexact", "sqrt_card_inexact")


def record_traces(fn):
    """(fn(), the arguments of every line_trace call the exact advection
    made in it)."""
    real, calls = advect.line_trace, []

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    advect.line_trace = record
    try:
        return fn(), calls
    finally:
        advect.line_trace = real


def branch_diff(cpu_calls, dev_calls, dev):
    """The line traces of one exact advection, recorded on the CPU and on
    the card, compared: 'inputs' counts the input values (positions,
    displacements) that differ between the two runs; the rest, each trace
    run again on both devices from the CPU run's inputs, counts the rays
    whose result differs (hit flag, final cell by truncation, final
    position's bits) and, summed over the 8 steps, whose decision differs
    (out of the domain, border hit, blocked, failed box test, number of
    back-offs). 'sqrt_*' count the rays whose length, torch.sqrt of the
    squared displacement, differs between the devices, and on each device
    from the correctly rounded square root (float64, then rounded)."""
    counts = dict.fromkeys(("inputs",) + TRACE_KEYS + SQRT_KEYS, 0)
    if len(cpu_calls) != len(dev_calls):
        raise AssertionError(f"{len(cpu_calls)} line traces on the CPU, "
                             f"{len(dev_calls)} on the card")
    for (args, kw), (dev_args, _) in zip(cpu_calls, dev_calls):
        counts["inputs"] += sum(
            int((a.to(b.device) != b).sum()) for a, b in zip(dev_args, args)
            if a.is_floating_point())
        runs = []
        for d in (torch.device("cpu"), dev):
            branches = []
            hit, *pos = line_trace(*(a.to(d) for a in args), **kw,
                                   branches=branches)
            runs.append(([t.cpu() for t in pos], hit.cpu(), [
                {k: v.cpu() for k, v in b.items()} for b in branches]))
        (c_pos, c_hit, c_br), (g_pos, g_hit, g_br) = runs
        counts["hit"] += int((c_hit != g_hit).sum())
        counts["cell"] += int(sum((torch.trunc(a) != torch.trunc(b))
                                  for a, b in zip(c_pos, g_pos)).bool()
                              .sum())
        counts["position"] += int(sum((a != b) for a, b in
                                      zip(c_pos, g_pos)).bool().sum())
        for cb, gb in zip(c_br, g_br):
            for k in TRACE_KEYS[3:]:
                counts[k] += int((cb[k] != gb[k]).sum())
        dx, dy, dz = args[3:6]
        sq = dx * dx + dy * dy + dz * dz
        exact = torch.sqrt(sq.double()).float()
        cpu_len, dev_len = torch.sqrt(sq), torch.sqrt(sq.to(dev)).cpu()
        counts["sqrt_cpu_vs_card"] += int((cpu_len != dev_len).sum())
        counts["sqrt_cpu_inexact"] += int((cpu_len != exact).sum())
        counts["sqrt_card_inexact"] += int((dev_len != exact).sum())
    return counts
