"""Console progress bar (torch/lib/pbar.lua equivalent); a copy of
fluidnet_tpu.utils.pbar."""

import sys
import time

_state = {"t0": None}


def progress(i, n, msg: str = "", width: int = 40, out=sys.stdout):
    """torch.progress(i, n, str): draws/advances a console bar; call with
    i == n to finish the line."""
    if _state["t0"] is None or i == 0:
        _state["t0"] = time.time()
    frac = 0.0 if n == 0 else min(max(i / n, 0.0), 1.0)
    filled = int(frac * width)
    bar = "=" * filled + (">" if filled < width else "") + \
        "." * max(width - filled - 1, 0)
    elapsed = time.time() - _state["t0"]
    eta = elapsed / frac - elapsed if frac > 0 else 0.0
    out.write(f"\r[{bar}] {i}/{n} ETA {eta:5.0f}s {msg}")
    if i >= n:
        out.write("\n")
        _state["t0"] = None
    out.flush()
