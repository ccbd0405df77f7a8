"""The layer spans' reduction (layers.py) on a hand-made trace and on
hand-made spans, and the readers on the small cells' stretches on the
CPU: every new metric reads a number, and the rollout's compared frames
are those the stretch left."""

import re
import types

import pytest

from fluidbench import layers, spec, tracing
from fluidbench.tests import small

ROLLOUT = layers.LAYERS["rollout"]


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    ua = "user_annotation"
    return [
        _x(ua, tracing.SPAN, 0, 100),
        _x(ua, "sim.step", 5, 78),
        _x(ua, "sim.advect", 10, 20),
        _x(ua, "sim.project", 40, 30),
        _x(ua, "sim.advect", 44, 10, tid=2),     # another thread's span
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 29, 1, tid=2, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 1, tid=2, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 75, 1, corr=4),
        _x("cuda_driver", "cuLaunchKernel", 88, 1, corr=5),
        _x("kernel", "mac_sweep_kernel", 14, 10, tid=7, corr=1),
        _x("kernel", "other", 31, 3, tid=7, corr=2),
        _x("kernel", "conv", 50, 10, tid=7, corr=3),
        _x("gpu_memcpy", "Memcpy DtoH", 76, 4, tid=7, corr=4),
        _x("kernel", "late", 90, 5, tid=7, corr=5),
        _x("kernel", "unlaunched", 96, 1, tid=7, corr=99),
    ]


def test_device_time_goes_to_the_span_open_at_its_launch():
    r = layers.reduce(_trace(), ROLLOUT)
    d = r["device_s"]
    # By correlation id: the sweep launched at 12 in sim.advect, the copy
    # at 75 in sim.step's own time, the kernel launched at 88 and the one
    # with no launch outside every span.
    assert d["sim.step"] == pytest.approx(4e-6)
    assert d[layers.NONE] == pytest.approx(6e-6)
    # Launched from thread 2 at 29 and 45: the main thread's innermost
    # span then (sim.advect, open to 30; sim.project), whatever thread 2
    # had open.
    assert d["sim.advect"] == pytest.approx(13e-6)
    assert d["sim.project"] == pytest.approx(10e-6)
    assert r["kernel_s"] == pytest.approx(29e-6)
    assert r["kernel_in_s"] == pytest.approx(23e-6)
    assert [k[2] for k in r["kernels"]] == [
        "sim.advect", "sim.advect", "sim.project", layers.NONE, layers.NONE]


def test_idle_gaps_split_by_span_sum_to_the_idle_time():
    r = layers.reduce(_trace(), ROLLOUT)
    idle = r["idle_s"]
    # Busy [14, 24] [31, 34] [50, 60] [76, 80] [90, 95] [96, 97]; the
    # gaps by their middles: 7 sim.step's own, 27.5 sim.advect, 42 and 68
    # sim.project, 85 (sim.step ended at 83), 95.5 and 98.5 none.
    assert idle["sim.step"] == pytest.approx(14e-6)
    assert idle["sim.advect"] == pytest.approx(7e-6)
    assert idle["sim.project"] == pytest.approx((16 + 16) * 1e-6)
    assert idle[layers.NONE] == pytest.approx((10 + 1 + 3) * 1e-6)
    total = r["window_s"] - r["busy_s"]
    assert r["busy_s"] == pytest.approx(33e-6)
    assert sum(idle.values()) == pytest.approx(total, rel=1e-12)
    # The same gaps as tracing.reduce's.
    assert sum(tracing.reduce(_trace())[4].values()) == \
        pytest.approx(total, rel=1e-12)


def test_host_self_time_is_the_span_minus_its_layer_children():
    def rec(name, i, parent, a, b, tid=1):
        return types.SimpleNamespace(name=name, id=i, parent=parent,
                                     tid=tid, start_ns=a, end_ns=b)
    records = [rec("sim.step", 0, None, 0, 1000),
               rec("sim.advect", 1, 0, 100, 300),
               rec("helper", 2, 0, 400, 900),      # not a layer: passed
               rec("sim.project", 3, 2, 500, 700),
               rec("sim.step", 4, None, 2000, 2500),
               rec("sim.forces", 5, None, 50, 60, tid=2)]
    got = layers.host_self_s(records, ROLLOUT, tid=1)
    assert got["sim.step"] == pytest.approx((600 + 500) * 1e-9)
    assert got["sim.advect"] == pytest.approx(200e-9)
    assert got["sim.project"] == pytest.approx(200e-9)
    assert got["sim.forces"] == 0


def test_readers_without_a_driver_read_none():
    s = tracing.Stretch(kind="rollout", steps=1)
    assert spec.reader("advect_host_ms.rollout")(s) is None
    assert spec.reader("loss_host_ms.train")(s) is None


@pytest.mark.parametrize("name", ["m3d_v5.plume128", "m3d_v5.train64"])
def test_readers_on_a_small_cells_stretch(name):
    c = small.cell(name)
    run = spec.driver(c)(c, small.SEED, "cpu")
    run.setup()
    stretch, _, _ = run.stretch()
    before = (list(getattr(run, "kept", [])), getattr(run, "seen", None))
    ours = [m["name"] for m in c.per_layer
            if re.match(r"[a-z]+_(host|device|idle)_ms\.", m["name"])]
    assert len(ours) == (12 if c.mix["kind"] == "rollout" else 9)
    got = {m: spec.reader(m)(stretch) for m in ours}
    assert all(v is not None for v in got.values()), got
    assert all(v > 0 for m, v in got.items() if "_host_ms" in m), got
    assert (list(getattr(run, "kept", [])),
            getattr(run, "seen", None)) == before
    run.free()
