"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
same code paths, grids of 16^3 (tog's pools need a multiple of 4), a
training batch of 2 from a pool of 4 batches, horizons 2 and 3, and a noise
amplitude under which a seeded model's loss stays below the recipe's
reject threshold at this size.

The tog cells are kept as data (configs/tog.json, limits/tog.*.json)
without an entry in BENCHMARK.json (their runs on the card spread past
the bounds, PERF.md section 7); the tests run them all the same."""

import torch

from fluidbench import spec

SEED = 2 ** 31 + 11
TOG = {"name": "tog", "file": "fluidbench/configs/tog.json"}
TOG_CELLS = [{"name": f"tog.{mix}", "config": "tog", "traffic": mix,
              "chips": 1} for mix in ("plume128", "train64")]


def bench():
    """BENCHMARK.json with the tog cells' entries added."""
    b = spec.load()
    if all(c["name"] != "tog" for c in b["configs"]):
        b["configs"].append(TOG)
        b["workloads"] += TOG_CELLS
    return b


def cell(name):
    torch.set_num_threads(4)
    c = spec.cell(name, bench())
    if c.mix["kind"] == "rollout":
        c.mix.update(res=16, warmup_steps=6, compared_frames=3,
                     trace_frames=2, plain_repeats=1)
    else:
        from fluidbench.scenes import noise_pool
        c.mix.update(res=16, batch=2, trace_steps=2, plain_repeats=1,
                     horizons=[2, 3],
                     pool_gb=4 * 2 * noise_pool.sample_bytes(16) / 1e9)
        c.mix["noise"].update(amplitude_low=0.1, amplitude_high=0.5)
    return c


def run(name, seed=SEED, seconds=0.5):
    """A driver of the small cell after its set-up and a short window."""
    c = cell(name)
    r = spec.driver(c)(c, seed, "cpu")
    r.setup()
    r.window(seconds)
    r.free()
    return c, r
