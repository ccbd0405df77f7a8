"""BENCHMARK.json against the benchmark's contract, and every cell
resolved by name to its configuration, traffic, limits, metric readers,
driver, scene generator and projection."""

import json
import os
import re

import pytest

from fluidbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fluidbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "fluidbench.run"]


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fluidbench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in BENCH["end_to_end"] +
                    BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_bounds_and_run_seconds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = spec.cell(name)
    for method in ("setup", "window", "stretch", "free", "readings"):
        assert callable(getattr(spec.driver(c), method))
    assert callable(spec.scene(c.mix).make)
    proj = spec.projection(c.config)
    for f in ("weights", "program", "precisions", "reference"):
        assert callable(getattr(proj, f))
    reported = [m["name"] for m in c.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(spec.reader(m["name"]))
    limits = c.limits()
    assert limits and all(v >= 0 for v in limits.values())


def test_every_metric_and_config_file_is_there():
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(spec.PKG, "metrics",
                                           m["name"] + ".py"))
    for c in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert {"mconf", "layers"} <= set(conf)


def test_configs_state_the_ports_layer_table():
    """The layer table the reference builds from is the one the port's
    FluidNet builds for the same mconf, in every configuration file."""
    from fluidnet_tpu_torch.core.config import from_dict
    from fluidnet_tpu_torch.models.fluidnet import layer_spec
    folder = os.path.join(spec.PKG, "configs")
    files = [f for f in os.listdir(folder) if f.endswith(".json")]
    assert {"m3d_v5.json", "tog.json"} <= set(files)
    for name in files:
        with open(os.path.join(folder, name)) as f:
            conf = json.load(f)
        want = layer_spec(from_dict(conf["mconf"]))
        got = tuple(tuple(conf["layers"][k])
                    for k in ("osize", "ksize", "psize", "usize"))
        assert got == want


def test_rollout_weights_are_the_bundled_checkpoints():
    with open(os.path.join(spec.PKG, "configs",
                           "m3d_v5.weights.msgpack"), "rb") as f:
        ours = f.read()
    with open(os.path.join(spec.ROOT, "data", "models_bundled",
                           "m3d_v5_bestRollout", "state.msgpack"),
              "rb") as f:
        assert ours == f.read()
