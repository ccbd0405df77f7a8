"""The span recorder (utils/profiler.py) and the spans the step and the
train step carry: off, a span is one shared null context that touches no
torch function; on, sim.step holds sim.advect, sim.forces and
sim.project, train.step holds train.loss, train.backward and
train.update; under torch.profiler the recorded spans and the trace's
user annotations agree. CPU, 8^3 grids."""

import json

import pytest
import torch

from fluidnet_tpu_torch.core.celltype import CellType
from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.models.fluidnet import random_model
from fluidnet_tpu_torch.sim.simulate import rollout
from fluidnet_tpu_torch.train.train import Draws, init_train_state, train_step
from fluidnet_tpu_torch.utils import profiler

from tests.torch_port_util import DEV

RES = 8
SIM = ("sim.advect", "sim.forces", "sim.project")
TRAIN = ("train.loss", "train.backward", "train.update")


def _mconf():
    return ModelConfig(is_3d=True, conv_compute_dtype="float32",
                       advection_method="maccormackOurs",
                       advection_window=1, adaptive_window=False,
                       buoyancy_scale=1.0, vorticity_confinement_amp=1.0,
                       long_term_grad_mode="full",
                       long_term_div_num_steps=(2, 2))


def _fields(batch=1, seed=0):
    gen = torch.Generator().manual_seed(seed)
    shape = (batch, 1, RES, RES, RES)
    flags = torch.full(shape, int(CellType.TypeObstacle), dtype=torch.int32)
    flags[:, :, 1:-1, 1:-1, 1:-1] = int(CellType.TypeFluid)
    u = torch.randn((batch, 3, RES, RES, RES), generator=gen) * 0.3
    return {"flags": flags, "u_div": u,
            "p_div": torch.zeros(shape),
            "density": torch.rand(shape, generator=gen)}


@pytest.fixture(scope="module")
def model():
    return random_model(_mconf(), seed=1, device=DEV)


def _rollout(model, steps=2):
    f = _fields()
    state = FluidState(u=f["u_div"], p=f["p_div"], flags=f["flags"],
                       density=f["density"])
    return rollout(state, _mconf(), steps, model)


def _train(model, n=2):
    mconf = _mconf()
    state = init_train_state(0, mconf, DEV, model=model)
    draws = Draws(dt=torch.tensor(0.1), gravity=torch.tensor([0., -1., 0.]),
                  b_scale=torch.tensor(1.0), g_scale=torch.tensor(0.0),
                  v_amp=torch.tensor(1.0))
    return train_step(state, _fields(batch=2, seed=3), None, mconf, n,
                      draws=draws)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def test_off_path_is_one_null_context_and_calls_no_torch(model,
                                                         monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a torch function was called")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", refuse)
    a, b = profiler.span("sim.step"), profiler.span("train.loss")
    assert a is b
    with a, a:
        pass
    _rollout(model, steps=1)           # spans all the way, recorder off
    assert profiler._records is None


def test_rollout_spans_nest_in_order(model):
    with profiler.recording() as spans:
        _rollout(model, steps=2)
    steps = [s for s in spans if s.name == "sim.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for s in steps:
        assert _children(spans, s) == list(SIM)
        for c in spans:
            if c.parent == s.id:
                assert s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns
    assert {s.tid for s in spans} == {steps[0].tid}
    assert profiler._records is None


def test_train_step_spans(model):
    with profiler.recording() as spans:
        _train(model, n=2)
    top = [s for s in spans if s.parent is None and s.name == "train.step"]
    assert len(top) == 1
    assert _children(spans, top[0]) == list(TRAIN)
    loss = next(s for s in spans if s.name == "train.loss")
    unroll = [s for s in spans if s.parent == loss.id]
    # Step 1 projects; the last unroll step stops at the forces.
    assert [s.name for s in unroll] == ["sim.step", "sim.step"]
    assert _children(spans, unroll[0]) == list(SIM)
    assert _children(spans, unroll[1]) == ["sim.advect", "sim.forces"]
    # The checkpoint's recompute of step 1 runs inside the backward.
    back = next(s for s in spans if s.name == "train.backward")
    assert [s.name for s in spans if s.parent == back.id] == ["sim.step"]


def test_spans_agree_with_the_traces_annotations(model, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # The profiler's first event on a thread sets up the thread's
        # buffers inside the annotation's interval: keep that out of the
        # spans compared.
        with torch.profiler.record_function("warm-up"):
            pass
        with profiler.recording() as spans:
            _rollout(model, steps=2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and
                  e.get("name", "").startswith("sim.")]
    events.sort(key=lambda e: float(e["ts"]))
    assert [e["name"] for e in events] == [s.name for s in spans]
    assert all(e["tid"] == s.tid for e, s in zip(events, spans))
    for e, s in zip(events, spans):
        traced = float(e["dur"]) * 1e-6
        recorded = (s.end_ns - s.start_ns) * 1e-9
        assert abs(traced - recorded) <= max(50e-6, 0.05 * recorded), \
            (s.name, traced, recorded)
    # Nesting: each span's parent is the innermost traced event around it.
    by_id = {s.id: i for i, s in enumerate(spans)}
    for i, (e, s) in enumerate(zip(events, spans)):
        t0 = float(e["ts"])
        around = [j for j, o in enumerate(events[:i])
                  if float(o["ts"]) + float(o["dur"]) >= t0 +
                  float(e["dur"])]
        assert (around[-1] if around else None) == \
            (by_id[s.parent] if s.parent is not None else None)
