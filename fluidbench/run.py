"""Runs one cell of the port's benchmark once and prints its result.

    python3 -m fluidbench.run --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for. The run loads the port, builds the cell's inputs from --seed,
warms up every shape the cell uses (set-up, timed from the start of this
process), then either measures for --seconds (--trace 0: the cell's
end-to-end metrics) or runs the traced stretch (--trace 1: the per-layer
metrics, with the device's busy time and the trace's breakdown), with
its main thread pinned to one core (host.py). Once
the window has closed it reads the peak memory, frees the program's
state and compares what the timed path produced with the plain
reference (checks.py). Its last lines on standard error are the numbers
compared, each beside its limit; the last line of standard output is one
JSON object: correct, attempted, failed, metrics, device [, breakdown],
host (the host's clocks over the window or stretch), checks.

It exits nonzero without printing a result when there is no CUDA card,
or fewer than the cell asks for, or when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The program's kernel caches, at fixed paths inside the checkout (the
# port builds its CUDA library into build/kernels by itself).
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")

FORBIDDEN = ("jax", "jaxlib", "flax", "fluidnet_tpu")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is JAX's, flax's or the
    JAX package's (compared whole: fluidnet_tpu_torch is not
    fluidnet_tpu)."""
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if m.split(".")[0] in FORBIDDEN})


def drive(cell, seed, seconds, trace, device):
    """One run of `cell`: (result without `checks`, readings, limits)."""
    import torch
    from fluidbench import checks, host, spec, tracing
    t0 = T0
    t_import = time.perf_counter()
    run = spec.driver(cell)(cell, seed, device)
    t_build = time.perf_counter()
    run.setup()
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s: imports and the device {t_import - t0:.3f}"
          f" s, model and inputs {t_build - t_import:.3f} s, warm-up "
          f"{t0 + setup_s - t_build:.3f} s", file=sys.stderr, flush=True)
    result = {}
    core = host.contain()
    start = host.clocks()
    if trace:
        stretch, gaps, attempted = run.stretch()
        stretch.peaks = spec.peaks()
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(stretch)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = tracing.breakdown(stretch.kernels, gaps)
        busy = {"busy_s": stretch.busy_s, "window_s": stretch.window_s}
    else:
        values, attempted = run.window(seconds)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        busy = {}
    clocks = dict(host.since(start), core=core)
    print("host: " + ", ".join(f"{k} {v:.6g}" for k, v in clocks.items()),
          file=sys.stderr, flush=True)
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    run.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = run.readings()
    limits = cell.limits()
    correct, _ = checks.judge(readings, limits)
    failed = getattr(run, "failed", 0)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak, **busy}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info, **result,
              "host": clocks}
    return result, readings, limits


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def die(msg, code=2):
    print(f"fluidbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        die("no CUDA device (torch.cuda.is_available() is False)")
    from fluidbench import checks, spec
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        die(f"{args.workload} needs {cell.chips} CUDA cards, the machine "
            f"has {torch.cuda.device_count()}")
    result, readings, limits = drive(cell, args.seed, args.seconds,
                                     args.trace, "cuda")
    bad = forbidden_modules()
    if bad:
        die(f"modules of JAX or the JAX package were loaded: {bad}", 3)
    limit_line = power_limit()
    result["device"]["power_limit"] = limit_line
    _, rows = checks.judge(readings, limits)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    print(f"card: {limit_line}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
