"""The reference against the port's plain path on the CPU (float32
convolutions on both sides, where they must agree to rounding), then the
comparison that decides `correct` on small cells: a sound run passes, the
control (the reference in fp8 in the program's place) fails, and a run
with the timed path broken underneath fails, once for each fault the
cell can have."""

import copy

import pytest
import torch

from fluidbench import checks, spec, weights
from fluidbench.reference import step as ref_step
from fluidbench.scenes import noise_pool, plume
from fluidbench.tests import small

ROLLOUTS = ["m3d_v5.plume128", "tog.plume128"]
TRAINS = ["m3d_v5.train64", "tog.train64"]


@pytest.mark.parametrize("name", ROLLOUTS)
def test_reference_frame_equals_the_ports_plain_rollout(name):
    from fluidnet_tpu_torch.core.config import from_dict
    from fluidnet_tpu_torch.core.grids import FluidState
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_tpu_torch.sim.simulate import Boundaries, rollout
    c = small.cell(name)
    md = {**c.config["mconf"], **c.mix["knobs"],
          "conv_compute_dtype": "float32"}
    w = weights.from_seed(c.config, 5, "cpu")
    net = weights.load_into(FluidNet(from_dict(md), device="cpu"), w)
    sc = plume.make(c.mix, 5, "cpu")
    (ub, ui), (db, di) = sc["bcs"]["u"], sc["bcs"]["density"]
    bcs = Boundaries(u_bc=ub, u_bc_inv_mask=ui, density_bc=db,
                     density_bc_inv_mask=di)
    st = FluidState(u=sc["u"], p=sc["p"], flags=sc["flags"],
                    density=sc["density"])
    st = rollout(st, from_dict(md), 6, net, bcs, use_kernels=False)
    port = rollout(st, from_dict(md), 3, net, bcs, use_kernels=False)
    ref = ref_step.frame(w, ref_step.namespace(md), c.config["layers"],
                         st.u, st.p, st.density, sc["flags"], sc["bcs"], 3,
                         "fp32")
    gaps = checks.frame_gaps((port.u, port.p, port.density), ref)
    assert max(gaps.values()) < 1e-5, gaps


@pytest.mark.parametrize("name", TRAINS)
def test_reference_loss_and_gradients_equal_the_ports(name):
    from fluidnet_tpu_torch.core.config import from_dict
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_tpu_torch.train.train import Draws, loss_fn
    c = small.cell(name)
    md = {**c.config["mconf"], "conv_compute_dtype": "float32"}
    w = weights.from_seed(c.config, 5, "cpu")
    net = weights.load_into(FluidNet(from_dict(md), device="cpu"), w)
    pool = noise_pool.make(c.mix, 5, "cpu")
    batch = {k: torch.from_numpy(v[:2]) for k, v in pool.items()}
    d = spec.plugin("drivers", "train").draws(md, 5, 1)
    total, _ = loss_fn(net, batch, None, from_dict(md), 3,
                       draws=Draws(*d))
    names = [k for k, _ in net.jax_named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in
                                        net.jax_named_parameters()])
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = ref_step.loss(leaves, ref_step.namespace(md), c.config["layers"],
                        batch, d, 3, "fp32")
    ref_grads = torch.autograd.grad(ref, [leaves[k] for k in names])
    total, ref = float(total.detach()), float(ref.detach())
    assert abs(total - ref) <= 1e-6 * abs(ref)
    for k, g, r in zip(names, grads, ref_grads):
        assert checks.rel_l2(g, r) < 1e-4, k


@pytest.mark.parametrize("name", ROLLOUTS + TRAINS)
def test_a_sound_run_is_correct(name):
    c, r = small.run(name)
    ok, rows = checks.judge(r.readings(), c.limits())
    assert ok, rows


@pytest.mark.parametrize("name", ROLLOUTS + TRAINS)
def test_the_control_is_not_correct(name):
    c, r = small.run(name)
    ok, rows = checks.judge(r.readings(control=True), c.limits())
    assert not ok, rows


def _unchanged_frame(run):
    return lambda state: state


def _altered_frame(run):
    real = run.step_frame

    def altered(state):
        out = real(state)
        return out.replace(density=out.density * 1.01)
    return altered


@pytest.mark.parametrize("fault", [_unchanged_frame, _altered_frame])
@pytest.mark.parametrize("name", ROLLOUTS)
def test_a_broken_rollout_is_not_correct(name, fault, monkeypatch):
    c = small.cell(name)
    r = spec.driver(c)(c, small.SEED, "cpu")
    monkeypatch.setattr(r, "step_frame", fault(r))
    r.setup()
    r.window(0.5)
    ok, rows = checks.judge(r.readings(), c.limits())
    assert not ok, rows


def _unchanged_step(run):
    from fluidnet_tpu_torch.train.train import eval_step

    def unchanged(batch, n, draws):
        terms = eval_step(batch, run.state.model, None, run.mconf, n,
                          draws=draws)
        run.state.step += 1
        return run.state, terms
    return unchanged


def _half_batch_step(run):
    real = run.train_step

    def half(batch, n, draws):
        b = next(iter(batch.values())).shape[0] // 2
        return real({k: v[:b] for k, v in batch.items()}, n, draws)
    return half


def _altered_loss_step(run):
    real = run.train_step

    def altered(batch, n, draws):
        state, terms = real(batch, n, draws)
        return state, dict(terms, total=terms["total"] * 1.01)
    return altered


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_step,
                                   _altered_loss_step])
@pytest.mark.parametrize("name", TRAINS)
def test_a_broken_train_step_is_not_correct(name, fault, monkeypatch):
    c = small.cell(name)
    r = spec.driver(c)(c, small.SEED, "cpu")
    monkeypatch.setattr(r, "train_step", fault(r))
    r.setup()
    r.window(0.5)
    r.free()
    ok, rows = checks.judge(r.readings(), c.limits())
    assert not ok, rows


def test_leaf_gaps_leave_out_leaves_the_reference_does_not_move():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.0, "b": 2.0, "c": 5e-9}
    keep = checks.moved_leaves(ref)
    assert keep == {"a", "b"}
    assert checks.leaf_gaps(prog, ref, keep) == 0.0
    assert checks.leaf_gaps(copy.copy(prog), ref) == pytest.approx(4e-9)


def test_grad_is_read_at_the_first_accepted_update():
    """The recipe's guard drops the first three steps' updates (their
    losses, ~0.02 at this seed, reach the threshold set here): set-up
    steps on until one is accepted, the first gradient the optimizer got
    is the fourth step's, on both sides, and a sound run still passes."""
    c = small.cell("tog.train64")
    c.config["mconf"]["loss_reject_threshold"] = 0.0195
    r = spec.driver(c)(c, 2 ** 31 + 5, "cpu")
    r.setup()
    r.free()
    assert [s.rejected for s in r.first] == [True, True, True, False]
    ref = r.reference(r.proj.precisions(c.config)[0])
    assert ref["rejected"] == [True, True, True, False]
    readings = checks.train_readings(r.program(), ref)
    assert 0 < readings["grad"] < c.limits()["grad"], readings
    ok, rows = checks.judge(readings, c.limits())
    assert ok, rows
