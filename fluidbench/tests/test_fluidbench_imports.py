"""Nothing the benchmark runs loads JAX, flax or the JAX package (whose
name the port's begins with, so top-level names are compared whole); the
reference loads nothing of the port; the harness refuses to run without
a card."""

import ast
import os
import subprocess
import sys

from fluidbench import spec
from fluidbench.run import FORBIDDEN, forbidden_modules


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(spec.PKG, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    bad = [(p, m) for p in _sources() for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN + ("bench",)]
    assert not bad


def test_the_reference_imports_nothing_of_the_port():
    bad = [(p, m) for p in _sources("reference") for m in _imports(p)
           if m.split(".")[0] == "fluidnet_tpu_torch"]
    assert not bad


def test_forbidden_modules_compares_whole_names():
    mods = {"jax.numpy": 1, "fluidnet_tpu_torch.sim": 1, "flax": 1,
            "fluidnet_tpu.ops": 1, "jaxtyping": 1, "numpy": 1}
    assert forbidden_modules(mods) == ["flax", "fluidnet_tpu.ops",
                                       "jax.numpy"]


def _python(*args, **env):
    return subprocess.run([sys.executable, *args], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **env})


def test_the_harness_and_the_port_load_no_jax():
    out = _python("-c", "import fluidbench.run as r, fluidbench.calibrate; "
                  "from fluidbench import spec; "
                  "[spec.driver(spec.cell(w['name'])) for w in "
                  "spec.load()['workloads']]; "
                  "print(r.forbidden_modules())")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_exits_nonzero_without_a_card():
    out = _python("-m", "fluidbench.run", "--workload", "m3d_v5.plume128",
                  "--seed", "1", "--seconds", "1", "--trace", "0",
                  CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
