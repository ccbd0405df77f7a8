"""The banked ConvNet's pieces on the CPU: the port's tog_dil2 and a tog
with two mres banks against reference/model_banks.py at 16^3 on seeded
weights (one forward and one rollout step, in float32 and with bf16
operands), the banked weight names loaded into FluidNet, the banked
operation count against hand counts and the port's, and the small
tog_dil2 cell: a sound run is correct, the control and a broken rollout
are not, and its readers read."""

import copy
import json
import os

import pytest
import torch

from fluidbench import checks, flops_banks, spec, weights
from fluidbench.projections import convnet_banks
from fluidbench.reference import model_banks
from fluidbench.reference import step as ref_step
from fluidbench.scenes import plume
from fluidbench.tests import small

CELL = "tog_dil2.plume128"
# mconf's changes to tog_dil2.json's.
MODELS = {"tog_dil2": {}, "tog_mres2": {"banks_type": "mres"}}
# The largest relative L2 gap of p and u, port against reference: float32
# on both sides; bf16 operands on both sides (one forward, one step).
TOL = {"fp32": 1e-5, "bf16": 1e-2}


def _config(name, **mconf):
    with open(os.path.join(spec.PKG, "configs", "tog_dil2.json")) as f:
        conf = json.load(f)
    conf["mconf"].update(MODELS[name], **mconf)
    return conf


def _program(conf, w, precision):
    from fluidnet_tpu_torch.core.config import from_dict
    md = dict(conf["mconf"], conv_compute_dtype="float32"
              if precision == "fp32" else "bfloat16")
    return convnet_banks.program(from_dict(md), w, "cpu"), md


def _scene(seed=5, res=16):
    mix = copy.deepcopy(small.cell(CELL).mix)
    mix["res"] = res
    sc = plume.make(mix, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    sc["u"] = torch.randn(sc["u"].shape, generator=gen) * 0.3
    sc["p"] = torch.randn(sc["p"].shape, generator=gen) * 0.1
    sc["density"] = torch.rand(sc["density"].shape, generator=gen)
    return mix, sc


def _gaps(a, b):
    return max(checks.rel_l2(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("precision", list(TOL))
@pytest.mark.parametrize("name", list(MODELS))
def test_port_forward_equals_the_reference(name, precision):
    conf = _config(name)
    w = convnet_banks.weights(conf, 7, "cpu", training=False)
    net, md = _program(conf, w, precision)
    _, sc = _scene()
    with torch.no_grad():
        p, u = net(sc["p"], sc["u"], sc["flags"])
    rp, ru = model_banks.forward(w, ref_step.namespace(md), conf["layers"],
                                 sc["p"], sc["u"], sc["flags"], precision)
    assert _gaps((p, u), (rp, ru)) < TOL[precision]


@pytest.mark.parametrize("precision", list(TOL))
@pytest.mark.parametrize("name", list(MODELS))
def test_port_rollout_step_equals_the_reference(name, precision):
    from fluidnet_tpu_torch.core.config import from_dict
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.sim.simulate import Boundaries, rollout
    conf = _config(name)
    w = convnet_banks.weights(conf, 9, "cpu", training=False)
    mix, sc = _scene(seed=3)
    net, md = _program(conf, w, precision)
    md = {**md, **mix["knobs"]}
    (ub, ui), (db, di) = sc["bcs"]["u"], sc["bcs"]["density"]
    bcs = Boundaries(u_bc=ub, u_bc_inv_mask=ui, density_bc=db,
                     density_bc_inv_mask=di)
    st = FluidState(u=sc["u"], p=sc["p"], flags=sc["flags"],
                    density=sc["density"])
    port = rollout(st, from_dict(md), 1, net, bcs, use_kernels=False)
    ref = ref_step.frame(w, ref_step.namespace(md), conf["layers"], st.u,
                         st.p, st.density, sc["flags"], sc["bcs"], 1,
                         precision, model_banks.forward)
    assert _gaps((port.u, port.p, port.density), ref) < TOL[precision]


@pytest.mark.parametrize("name", list(MODELS))
def test_banked_weights_load_into_fluidnet(name):
    from fluidnet_tpu_torch.core.config import from_dict
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    conf = _config(name)
    w = convnet_banks.weights(conf, 11, "cpu", training=False)
    net = FluidNet(from_dict(conf["mconf"]), device="cpu")
    named = dict(net.jax_named_parameters())
    assert list(w) == list(named)
    assert {k: tuple(v.shape) for k, v in w.items()} == \
        {k: tuple(v.shape) for k, v in named.items()}
    assert list(w) == model_banks.param_names(
        ref_step.namespace(conf["mconf"]), conf["layers"])
    weights.load_into(net, w)
    for k, p in net.jax_named_parameters():
        assert torch.equal(p, w[k]), k
    bank1 = [k for k in w if k.startswith("stages/") and k.split("/")[2] ==
             "1"]
    assert bank1 == ["stages/0/1/conv/w", "stages/0/1/conv/b",
                     "stages/1/1/conv/w", "stages/1/1/conv/b"]
    assert not any(torch.equal(w[k], w[k.replace("/1/conv", "/0/conv")])
                   for k in bank1)
    # The join stage takes both banks' 16 channels.
    assert tuple(w["stages/2/0/conv/w"].shape) == (16, 32, 3, 3, 3)


def test_operations_by_hand():
    """At 128^3 (hand counts from the layer table): tog 14,159,970,304;
    a second dilate bank runs stages 1-2 again at 128^3 and 64^3
    (9,059,696,640) and doubles stage 3's input (452,984,832 more); a
    second mres bank runs them at 64^3 and 32^3 (1,585,446,912)."""
    conf = _config("tog_dil2")
    m, layers = conf["mconf"], conf["layers"]
    size = (128, 128, 128)

    def count(**kw):
        return flops_banks.model_flops(layers, dict(m, **kw), 3, size)
    assert count(banks_num=1) == 14_159_970_304
    assert count() == 23_672_651_776
    assert count(banks_type="mres") == 15_745_417_216
    assert flops_banks.bank_flops(layers, m, 3, size, 1) == 9_059_696_640
    assert flops_banks.bank_flops(layers, m, 3, size, 0) == 9_059_696_640
    assert flops_banks.bank_flops(layers, dict(m, banks_type="mres"), 3,
                                  size, 1) == 1_132_462_080


@pytest.mark.parametrize("kw", [{}, {"banks_type": "mres"},
                                {"banks_num": 1},
                                {"banks_aggregate_method": "add"},
                                {"banks_num": 3, "banks_join_stage": 4}])
def test_operations_equal_the_ports(kw):
    from fluidnet_tpu_torch.core.config import from_dict
    from fluidnet_tpu_torch.utils.flops import model_flops
    conf = _config("tog_dil2", **kw)
    for size in ((128, 128, 128), (64, 32, 16)):
        assert flops_banks.model_flops(
            conf["layers"], conf["mconf"],
            weights.in_channels(conf["mconf"]), size) == \
            model_flops(from_dict(conf["mconf"]), size)


def test_a_sound_run_is_correct_and_the_control_is_not():
    c, r = small.run(CELL)
    ok, rows = checks.judge(r.readings(), c.limits())
    assert ok, rows
    ok, rows = checks.judge(r.readings(control=True), c.limits())
    assert not ok, rows


def test_a_broken_rollout_is_not_correct(monkeypatch):
    c = small.cell(CELL)
    r = spec.driver(c)(c, small.SEED, "cpu")
    real = r.step_frame
    monkeypatch.setattr(r, "step_frame", lambda s: real(s).replace(
        density=real(s).density * 1.01))
    r.setup()
    r.window(0.5)
    ok, rows = checks.judge(r.readings(), c.limits())
    assert not ok, rows


def test_readers_on_the_small_cells_stretch():
    from fluidnet_tpu_torch.utils import profiler
    c = small.cell(CELL)
    run = spec.driver(c)(c, small.SEED, "cpu")
    before = dict(profiler.trunk_forwards)
    run.setup()
    stretch, _, _ = run.stretch()
    stretch.peaks = spec.peaks()
    got = {m["name"]: spec.reader(m["name"])(stretch) for m in c.per_layer}
    for name in ("bank0_device_ms.rollout", "bank1_device_ms.rollout",
                 "join_device_ms.rollout", "banked_forwards_share.rollout"):
        assert got[name] is not None, got
    moved = {k: v - before.get(k, 0)
             for k, v in profiler.trunk_forwards.items()}
    # Set-up's steps, the stretch's unprofiled and profiled frames, and the
    # model spans' traced pass of the stretch's frames.
    mix = c.mix
    steps = mix["warmup_steps"] + (mix["plain_repeats"] + 2) * \
        mix["trace_frames"] * mix["steps_per_frame"]
    assert {k: v for k, v in moved.items() if v} == {"banked": steps}
    run.free()
