"""A short run of each cell through the entry point, on the card (marked
`cuda`; it skips without one): the result's last line parses, the run is
correct, and it reports the cell's end-to-end metrics."""

import json
import os
import subprocess
import sys

import pytest

from fluidbench import spec

CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "fluidbench.run", "--workload", name,
         "--seed", str(2 ** 31 + 977), "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    want = {m["name"] for m in spec.cell(name).end_to_end}
    assert set(result["metrics"]) == want
    assert list(result)[-1] == "checks"
