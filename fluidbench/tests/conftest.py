"""pytest settings of the benchmark's own tests (run from the repo root:
python -m pytest fluidbench/tests -q). They run on the CPU at small
sizes; a test that needs a CUDA card is marked `cuda` and decides inside
itself whether there is one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
