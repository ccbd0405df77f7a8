"""What of rollout's CUDA graph chain (sim/simulate.graph_eligible,
_chain_key, sim/chain.py, utils/profiler's cutting and rollout_steps)
holds on the CPU: the eligibility rule over each case, CPU rollouts run
op by op and count their steps so, the spans call the capture's callback
in the step's order, the chain's key moves with what the graphs read by
address, and the benchmark's reader of the replayed share. The replays
themselves are held to the eager steps on the card
(tests/test_torch_cuda.py). CPU, 8^3 grids."""

import collections
import dataclasses

import pytest
import torch

from fluidnet_tpu_torch.core.celltype import CellType
from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.models.fluidnet import random_model
from fluidnet_tpu_torch.sim import simulate as sim
from fluidnet_tpu_torch.utils import profiler

from tests.torch_port_util import DEV

RES = 8
FIXED = dict(is_3d=True, advection_method="maccormackOurs",
             advection_window=1, adaptive_window=False)
CUDA = torch.device("cuda", 0)
SLAB = sim.SlabStep(dx=1.0 / RES, z0=0, window=1, input_scale=None,
                    polish=None, solve=None)

# (mconf's knobs, device, use_kernels, slab, eligible)
ELIGIBILITY = {
    "convnet_fixed_window": (FIXED, CUDA, True, None, True),
    "convnet_polish": (dict(FIXED, polish_iters=8), CUDA, True, None, True),
    "jacobi": (dict(FIXED, sim_method="jacobi", max_iter=34), CUDA, True,
               None, True),
    "window_2_fixed": (dict(FIXED, advection_window=2), CUDA, True, None,
                       True),
    "adaptive_window_1": (dict(FIXED, adaptive_window=True), CUDA, True,
                          None, True),
    "cpu": (FIXED, torch.device("cpu"), True, None, False),
    "plain_ops": (FIXED, CUDA, False, None, False),
    "slab": (FIXED, CUDA, True, SLAB, False),
    "exact_route": (dict(FIXED, advection_window=0), CUDA, True, None,
                    False),
    "adaptive_window_2": (dict(FIXED, advection_window=2,
                               adaptive_window=True), CUDA, True, None,
                          False),
    "pcg": (dict(FIXED, sim_method="pcg"), CUDA, True, None, False),
}


@pytest.mark.parametrize("case", list(ELIGIBILITY))
def test_graph_eligible(case):
    knobs, device, use_kernels, slab, want = ELIGIBILITY[case]
    assert sim.graph_eligible(ModelConfig(**knobs), device, use_kernels,
                              slab) is want


def _mconf(**kw):
    return ModelConfig(**dict(FIXED, conv_compute_dtype="float32",
                              buoyancy_scale=1.0,
                              vorticity_confinement_amp=1.0, **kw))


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    shape = (1, 1, RES, RES, RES)
    flags = torch.full(shape, int(CellType.TypeObstacle), dtype=torch.int32)
    flags[:, :, 1:-1, 1:-1, 1:-1] = int(CellType.TypeFluid)
    return FluidState(u=torch.randn((1, 3, RES, RES, RES), generator=gen)
                      * 0.3, p=torch.zeros(shape), flags=flags,
                      density=torch.rand(shape, generator=gen))


@pytest.fixture(scope="module")
def model():
    return random_model(_mconf(), seed=1, device=DEV)


@pytest.mark.parametrize("consts", [False, True])
def test_cpu_rollouts_run_op_by_op(model, consts):
    kept = sim.FlagConsts() if consts else None
    before = dict(profiler.rollout_steps)
    out = sim.rollout(_state(), _mconf(), 3, model, consts=kept)
    out = sim.rollout(out, _mconf(), 2, model, consts=kept)
    got = {k: profiler.rollout_steps[k] - before.get(k, 0)
           for k in ("eager", "replayed", "chains")}
    assert got == {"eager": 5, "replayed": 0, "chains": 0}
    assert kept is None or kept.chain is None


def test_spans_call_the_capture_callback_in_step_order(model):
    calls = []
    with profiler.cutting(lambda name, entering: calls.append(
            (name, entering))):
        sim.rollout(_state(), _mconf(), 1, model)
    with pytest.raises(RuntimeError):
        with profiler.cutting(lambda *a: calls.append(a)):
            with profiler.span("sim.step"):
                raise RuntimeError("no exit call on the way out")
    assert profiler._cut is None
    names = ["sim.advect", "sim.forces", "sim.project"]
    want = [("sim.step", True)]
    for n in names:
        want += [(n, True), (n, False)]
    assert calls == want + [("sim.step", False), ("sim.step", True)]


def test_chain_key_follows_what_the_graphs_read(model):
    st = _state()
    bcs = sim.create_plume_bcs(st, [1.0], u_scale=0.6, rad=0.2)
    m = _mconf()
    key = sim._chain_key(st, m, model, bcs)
    assert sim._chain_key(st.replace(u=st.u.clone()), _mconf(), model,
                          bcs) == key
    other = random_model(m, seed=2, device=DEV)
    moved = [
        sim._chain_key(st, _mconf(polish_iters=2), model, bcs),
        sim._chain_key(st.replace(flags=st.flags.clone()), m, model, bcs),
        sim._chain_key(st, m, other, bcs),
        sim._chain_key(st, m, model, dataclasses.replace(
            bcs, u_bc=bcs.u_bc.clone())),
        sim._chain_key(st, m, model, None),
        sim._chain_key(st.replace(density=None), m, model, bcs),
    ]
    assert all(k != key for k in moved)
    st.flags[0, 0, 3, 3, 3] = int(CellType.TypeObstacle)
    assert sim._chain_key(st, m, model, bcs) != key
    key = sim._chain_key(st, m, other, bcs)
    with torch.no_grad():
        other.final.weight.add_(1.0)        # in place: read by address
    assert sim._chain_key(st, m, other, bcs) == key


def test_graph_steps_share_reader(monkeypatch):
    from fluidbench import spec, tracing
    read = spec.reader("graph_steps_share.rollout")
    s = tracing.Stretch(kind="rollout", steps=60)
    monkeypatch.setattr(profiler, "rollout_steps", collections.Counter(
        replayed=297, eager=3, chains=1))
    assert read(s) == pytest.approx(99.0)
    assert read(tracing.Stretch(kind="train", steps=6)) is None
    monkeypatch.setattr(profiler, "rollout_steps", collections.Counter())
    assert read(s) is None
    monkeypatch.delattr(profiler, "rollout_steps")
    assert read(s) is None
