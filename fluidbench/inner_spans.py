"""The program's spans inside its layers in a --trace 1 run, reduced to
device ms a step: what bank0_device_ms.rollout, bank1_device_ms.rollout,
join_device_ms.rollout and dilated_roofline.rollout read in a rollout.

On the banked stage path the port marks each bank's stages between the
split and the join with model.bank<i> and the join with model.join
(fluidnet_tpu_torch/models/fluidnet.py, utils/profiler.span; replayed
from a CUDA graph chain, each segment inside its span). Once the driver's stretch is done, its frames run
once more under tracing.profile with the recorder on, and each kernel,
copy and fill goes to the innermost of the kind's spans open on the main
thread at its launch (layers.reduce, found by correlation id); the rest
goes to "(no program span)". The rollout driver's compared frames are
left as the stretch left them.

A program without these spans (one older than them, or a configuration
without banks) leaves no such annotation in the trace: every metric here
then reads None, as it does without the recorder or a driver on the call
stack (layers.of's search).
"""

import sys

from fluidbench import layers, tracing
from fluidbench.kernels import convolutions

# A stretch kind's spans.
NAMES = {"rollout": ("model.bank0", "model.bank1", "model.join")}


def read(s, name):
    """Device ms a step of the span `name`, or None."""
    got = of(s)
    return None if got is None else got["device_ms"].get(name)


def of(s):
    """{"device_ms": {span: ms a step}, "conv_ms": {span: ms a step of the
    convolutions launched inside it}}, measured at the first call, or
    None."""
    if not hasattr(s, "inner_spans"):
        s.inner_spans = _measure(s, layers._driver(s, sys._getframe(1)))
    return s.inner_spans


def _measure(s, run):
    if s.kind not in NAMES or run is None:
        return None
    try:
        from fluidnet_tpu_torch.utils.profiler import recording
    except ImportError:
        return None
    names = NAMES[s.kind]

    def work():
        for _ in range(s.frames):
            run.frame()
    with layers._compared_frames_kept(run):
        with recording():
            events = tracing.profile(work)
    seen = {e.get("name") for e in events
            if e.get("cat") == "user_annotation"}
    if not seen & set(names):
        print("inner spans: the trace holds none of " + ", ".join(names),
              file=sys.stderr, flush=True)
        return None
    dev = layers.reduce(events, names)
    per = 1e3 / s.steps
    keys = names + (layers.NONE,)
    device = {k: dev["device_s"][k] * per for k in keys}
    conv = {k: sum(d for n, d, at in dev["kernels"]
                   if at == k and convolutions.matches(n)) * per
            for k in keys}
    checks = "; ".join(
        f"{k} {device[k]:.6f} >= convs {conv[k]:.6f} "
        f"{'holds' if device[k] >= conv[k] * (1 - 1e-9) else 'FAILS'}"
        for k in names)
    print("inner spans device ms a step (traced): " +
          ", ".join(f"{k} {device[k]:.4f}" for k in keys) +
          "; convs launched inside: " +
          ", ".join(f"{k} {conv[k]:.4f}" for k in keys),
          file=sys.stderr, flush=True)
    print(f"inner spans lower bounds: {checks}", file=sys.stderr,
          flush=True)
    return {"device_ms": {k: device[k] for k in names},
            "conv_ms": {k: conv[k] for k in names}}
