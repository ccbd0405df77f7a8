"""The banked stage path's spans and the trunk's forward counter
(models/fluidnet.py, utils/profiler.py): a forward counts once under its
path (fast, stages, banked), a rollout step once whether it ran op by
op; on the banked path each bank's stages between the split and the join
run in model.bank<i> and the join in model.join, in the trunk's order,
and a chain's capture is cut there; the fast trunk and the one-bank stage
path open no model span. CPU, 8^3 grids."""

import pytest
import torch

from fluidnet_tpu_torch.core.celltype import CellType
from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.models.fluidnet import (num_input_channels,
                                                random_model)
from fluidnet_tpu_torch.sim.simulate import rollout
from fluidnet_tpu_torch.utils import profiler

from tests.torch_port_util import DEV

RES = 8
KNOBS = dict(is_3d=True, conv_compute_dtype="float32",
             advection_method="maccormackOurs", advection_window=1,
             adaptive_window=False, buoyancy_scale=1.0)
# (mconf's knobs, the trunk's path)
MODELS = {
    "default": ({}, "fast"),
    "tog": (dict(model_type="tog"), "stages"),
    "tog_dilate2": (dict(model_type="tog", banks_num=2,
                         banks_type="dilate"), "banked"),
    "tog_mres2": (dict(model_type="tog", banks_num=2), "banked"),
    "default_dilate3_add": (dict(banks_num=3, banks_type="dilate",
                                 banks_aggregate_method="add"), "banked"),
}
BANKED = [k for k, (_, path) in MODELS.items() if path == "banked"]


def _model(name):
    knobs, _ = MODELS[name]
    mconf = ModelConfig(**KNOBS, **knobs)
    return mconf, random_model(mconf, seed=3, device=DEV)


def _input(mconf):
    gen = torch.Generator().manual_seed(0)
    return torch.randn((1, num_input_channels(mconf), RES, RES, RES),
                       generator=gen)


def _model_spans(spans):
    return [s.name for s in spans if s.name.startswith("model.")]


def _bank_order(mconf):
    """The model spans of one forward: each banked stage's banks in order,
    then the join."""
    stages = mconf.banks_join_stage - mconf.banks_split_stage
    return [f"model.bank{ib}" for _ in range(stages)
            for ib in range(mconf.banks_num)] + ["model.join"]


@pytest.mark.parametrize("name", list(MODELS))
def test_a_forward_counts_once_under_its_path(name):
    mconf, net = _model(name)
    before = dict(profiler.trunk_forwards)
    with torch.no_grad():
        net.trunk(_input(mconf))
    moved = {k: v - before.get(k, 0)
             for k, v in profiler.trunk_forwards.items()}
    assert {k: v for k, v in moved.items() if v} == {MODELS[name][1]: 1}
    assert net.path == MODELS[name][1]


@pytest.mark.parametrize("name", list(MODELS))
def test_model_spans_only_on_the_banked_path(name):
    mconf, net = _model(name)
    with profiler.recording() as spans, torch.no_grad():
        net.trunk(_input(mconf))
    want = _bank_order(mconf) if name in BANKED else []
    assert _model_spans(spans) == want
    assert all(s.parent is None for s in spans)
    assert all(s.end_ns is not None for s in spans)


@pytest.mark.parametrize("name", BANKED)
def test_banked_spans_cut_a_capture(name):
    mconf, net = _model(name)
    marks = []
    with profiler.cutting(lambda n, entering: marks.append((n, entering))):
        with torch.no_grad():
            net.trunk(_input(mconf))
    assert marks == [(n, e) for n in _bank_order(mconf)
                     for e in (True, False)]


@pytest.mark.parametrize("name", ["tog_dilate2", "default"])
def test_rollout_steps_count_their_forwards(name):
    mconf, net = _model(name)
    shape = (1, 1, RES, RES, RES)
    flags = torch.full(shape, int(CellType.TypeObstacle), dtype=torch.int32)
    flags[:, :, 1:-1, 1:-1, 1:-1] = int(CellType.TypeFluid)
    gen = torch.Generator().manual_seed(1)
    state = FluidState(u=torch.randn((1, 3, RES, RES, RES), generator=gen),
                       p=torch.zeros(shape), flags=flags,
                       density=torch.rand(shape, generator=gen))
    before = profiler.trunk_forwards[net.path]
    with profiler.recording() as spans:
        rollout(state, mconf, 2, net)
    assert profiler.trunk_forwards[net.path] - before == 2
    project = [s for s in spans if s.name == "sim.project"]
    inside = [s for s in spans if s.name.startswith("model.")]
    assert len(project) == 2
    assert len(inside) == (2 * len(_bank_order(mconf))
                           if name in BANKED else 0)
    ids = {s.id for s in project}
    assert all(s.parent in ids for s in inside)
