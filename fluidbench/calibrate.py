"""The readings that a cell's limits (limits/<cell>.json) are set from, at
the cell's own size, on the chip: for each seed, the program's numbers
against the reference after a short window at the cell's load; the
control's (the reference at the precision below the configuration's,
fp8 convolutions for bf16, in the program's place); and for training
cells the planted faults': half of each batch left out (the reference on
the first half of each batch), each step's reported loss altered by 1%,
and the state returned unchanged (it reads 1 by construction).

    python3 -m fluidbench.calibrate --workload <cell> --seeds 12 \\
        [--first 2147483711] [--seconds 2]

Prints one JSON line a seed. The benchmark's own runs never run this.
"""

import argparse
import json
import sys

import torch

from fluidbench import checks, spec

ALTERED = 0.01             # the loss a step reports, altered by 1%


def train_faults(run, ref):
    """The planted faults' readings against the reference `ref`."""
    half = run.reference(run.proj.precisions(run.cell.config)[0],
                         batch_share=0.5)
    altered = dict(ref, losses=[x * (1 + ALTERED) for x in ref["losses"]])
    unchanged = dict(run.program(), p_end=ref["p0"],
                     grad1={k: torch.zeros_like(v)
                            for k, v in ref["grad1"].items()})
    return {"half_batch": checks.train_readings(half, ref),
            "altered_loss": checks.train_readings(altered, ref),
            "unchanged": checks.train_readings(unchanged, ref)}


def calibrate(cell, seed, seconds, device="cuda"):
    run = spec.driver(cell)(cell, seed, device)
    run.setup()
    run.window(seconds)
    run.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed}
    if cell.mix["kind"] == "train":
        precision, lower = run.proj.precisions(cell.config)
        ref = run.reference(precision)
        leaves = {}
        out["program"] = checks.train_readings(run.program(), ref, leaves)
        out["leaves"] = leaves
        out["control"] = checks.train_readings(run.reference(lower), ref)
        out["steps"] = {"n": [s.n for s in run.first],
                        "loss": [s.loss for s in run.first],
                        "rejected": [s.rejected for s in run.first],
                        "ref_loss": ref["losses"],
                        "ref_rejected": ref["rejected"],
                        "ref_grad_norms": ref["grad_norms"]}
        out.update(train_faults(run, ref))
    else:
        frames = []
        out["program"] = run.readings(detail=frames)
        out["control"] = run.readings(control=True)
        out["frames"] = frames
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=2 ** 31 + 63)
    ap.add_argument("--step", type=int, default=7919)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("fluidbench.calibrate: no CUDA device")
    cell = spec.cell(args.workload)
    for i in range(args.seeds):
        seed = args.first + i * args.step
        print(json.dumps(calibrate(cell, seed, args.seconds)), flush=True)


if __name__ == "__main__":
    main()
