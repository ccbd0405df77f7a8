"""BENCHMARK.json and the files it names: a cell (a workload) resolves by
name to its configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), the limits of its comparison
(limits/<workload>.json), its end-to-end metrics and its per-layer
metrics, each of which has a reader metrics/<metric>.py. The code that
runs a cell is found by name as well: the mix's "kind" names its driver
(drivers/<kind>.py, the loop the window runs), its "scene" the generator
of its inputs (scenes/<scene>.py), and the configuration's "projection"
the pressure projection (projections/<projection>.py: the program's and
the reference's). Nothing here changes for a new cell, configuration,
mix, kind of run or metric: each is new files and a new entry."""

import importlib.util
import json
import os
import re
import sys

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


class Cell:
    """One workload of BENCHMARK.json with what it names."""

    def __init__(self, bench, name):
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entry
        self.chips = entry["chips"]
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        with open(os.path.join(ROOT, conf["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(PKG, "traffic",
                               entry["traffic"] + ".json")) as f:
            self.mix = json.load(f)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def limits(self):
        """{number: limit} of the comparison that decides `correct` ({}
        while the cell has no limits file: every number then fails)."""
        path = os.path.join(PKG, "limits", self.name + ".json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)["limits"]


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name, bench=None):
    return Cell(bench or load(), name)


def plugin(folder, name):
    """The module <folder>/<name>.py of the benchmark, loaded once by its
    path (a name may hold dots, as a metric's does)."""
    key = f"fluidbench.{folder}." + re.sub(r"\W", "_", name)
    if key not in sys.modules:
        path = os.path.join(PKG, folder, name + ".py")
        if not os.path.exists(path):
            raise KeyError(f"no {folder}/{name}.py in the benchmark")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def reader(metric):
    """metrics/<metric>.py's read function."""
    return plugin("metrics", metric).read


def driver(cell):
    """The cell's driver: drivers/<kind>.py's Driver, <kind> the mix's
    "kind"."""
    return plugin("drivers", cell.mix["kind"]).Driver


def scene(mix):
    """The mix's generator of inputs: scenes/<scene>.py."""
    return plugin("scenes", mix["scene"])


def projection(config):
    """The configuration's projection: projections/<projection>.py."""
    return plugin("projections", config["projection"])


def peaks():
    with open(os.path.join(PKG, "peaks.json")) as f:
        return json.load(f)
