"""The port's generic stage path (every ConvNet ModelConfig builds) against
the JAX package: tog, multi-resolution and dilation banks (concat, add,
weight sharing), batch norm (affine and not) and the pressure skip, in 2-D
and 3-D.

`FluidNet.load_jax_params` + `forward` are held against JAX `apply_model`
on params from `init_model`, with batch norm's scale, bias, mean and var
redrawn from the seed (JAX draws 1, 0, 0, 1, which would hide a wrong
formula), with and without the prologue's precomputed divergence, on
(2, 1, 8, 12, 16) grids (3-D) and (2, 1, 1, 12, 16) (2-D): each extent
divides by the product of the pools (4 for 3-D tog). Tolerances:
  - float32 convs: rtol 1e-4, atol 1e-5;
  - bfloat16 convs: atol 6e-2 * max|p|, |U| of the JAX result, in 3-D as
    tests/test_torch_model.py (JAX's z-fold sums the kz partial convs in
    bf16 where conv3d rounds once) and in 2-D as
    tests/test_torch_model2d.py (accumulation orders differ, a hidden
    activation may land one bf16 ulp apart).
Also: the JAX tree paths of the parameters, a JAX state.msgpack of a tog
model (with and without batch norm) through the port's checkpoint reader
and writer, the analytic FLOPs, and the training CLI with its default
startup profile. The gradients through train.loss_fn are held in
tests/test_torch_model_generic_grad.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidnet_tpu.core.config import ModelConfig as JModelConfig
from fluidnet_tpu.models.fluidnet import apply_model, init_model
from fluidnet_tpu.ops.boundary import set_wall_bcs as j_set_wall_bcs
from fluidnet_tpu.ops.divergence import \
    velocity_divergence as j_velocity_divergence
from fluidnet_tpu.train import train as jtrain
from fluidnet_tpu.utils import checkpoint as jckpt
from fluidnet_tpu.utils import flops as jflops

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.models.fluidnet import FluidNet, from_jax_params
from fluidnet_tpu_torch.train.train import init_train_state
from fluidnet_tpu_torch.utils import checkpoint as ckpt
from fluidnet_tpu_torch.utils import flops

from tests.torch_port_util import DEV, assert_close, np_, random_flags, tt

SHAPE = (2, 1, 8, 12, 16)
SHAPE_2D = (2, 1, 1, 12, 16)
# Each configuration in 2-D and in 3-D, tog's own tables in each, the
# banks with batch norm and the skip together in 3-D.
BASE = {
    "tog": dict(model_type="tog"),
    "tog_max_relu6": dict(model_type="tog", pool_type="max",
                          nonlin_type="relu6"),
    "mres_concat": dict(banks_num=2),
    "mres_add": dict(banks_num=2, banks_aggregate_method="add"),
    "dilate_add": dict(banks_num=2, banks_type="dilate",
                       banks_aggregate_method="add"),
    "mres_shared": dict(banks_num=2, banks_weight_share=True),
    "bn_affine": dict(add_batch_norm=True),
    "bn_plain": dict(add_batch_norm=True, batch_norm_affine=False),
    "skip": dict(add_pressure_skip=True),
}
CASES = {f"{name}_{nd}d": dict(kw, is_3d=nd == 3)
         for name, kw in BASE.items() for nd in (2, 3)}
CASES["mres_bn_skip_3d"] = dict(banks_num=2, add_batch_norm=True,
                                add_pressure_skip=True, is_3d=True)


def _mconfs(case, dtype="float32", **extra):
    kw = dict(CASES[case], conv_compute_dtype=dtype, **extra)
    return JModelConfig(**kw), ModelConfig(**kw)


def _params(jm, seed=11):
    """init_model's params as numpy, batch norm redrawn from `seed`."""
    params = jax.tree_util.tree_map(
        np.asarray, init_model(jax.random.PRNGKey(seed), jm))
    rng = np.random.default_rng(seed)
    params["bn"] = [None if bn is None else {
        "scale": rng.uniform(0.5, 1.5, bn["scale"].shape),
        "bias": rng.normal(0, 0.2, bn["bias"].shape),
        "mean": rng.normal(0, 0.2, bn["mean"].shape),
        "var": rng.uniform(0.5, 2.0, bn["var"].shape)} for bn in params["bn"]]
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)


def _inputs(is_3d, seed=40):
    shape = SHAPE if is_3d else SHAPE_2D
    rng = np.random.default_rng(seed)
    flags = random_flags(rng, shape, p_obstacle=0.1, stick_empty=True)
    p = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal((2, 3 if is_3d else 2) + shape[2:]) \
        .astype(np.float32)
    return p, u, flags


def _assert_close(tp, tu, jp, ju, dtype):
    if dtype == "float32":
        assert_close(tp, jp, 1e-4, 1e-5, "p")
        assert_close(tu, ju, 1e-4, 1e-5, "U")
    else:
        for a, b, name in ((tp, jp, "p"), (tu, ju, "U")):
            b = np_(b)
            assert_close(a, b, 0, 6e-2 * np.abs(b).max(), name)


def _at(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _leaf_paths(tree):
    return sorted("/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                           for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precomputed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_generic_path_matches_apply_model(case, precomputed, dtype):
    jm, tm = _mconfs(case, dtype)
    params = _params(jm)
    p, u, flags = _inputs(jm.is_3d)
    jf, ju = jnp.asarray(flags), jnp.asarray(u)
    div = None
    if precomputed:
        ju = j_set_wall_bcs(ju, jf)
        div = j_velocity_divergence(ju, jf)
    jp_out, ju_out = apply_model(params, jm, jnp.asarray(p), ju, jf,
                                 precomputed_div=div)
    model = from_jax_params(params, tm, device=DEV)
    assert not model.fast
    with torch.no_grad():
        tp_out, tu_out = model(tt(p), tt(ju), tt(flags),
                               precomputed_div=None if div is None
                               else tt(div))
    assert tp_out.dtype == torch.float32 and tp_out.shape == p.shape
    assert tu_out.shape == u.shape
    _assert_close(tp_out, tu_out, jp_out, ju_out, dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_named_parameters_are_the_tree_paths(case):
    jm, tm = _mconfs(case)
    params = init_model(jax.random.PRNGKey(0), jm)
    model = FluidNet(tm, device=DEV)
    names = [k for k, _ in model.jax_named_parameters()]
    assert sorted(names) == _leaf_paths(params)
    assert len(set(names)) == len(names)
    for k, t in model.jax_named_parameters():
        assert tuple(t.shape) == _at(params, k).shape, k
        # Batch-norm statistics train like the rest (fault F11).
        assert t.requires_grad, k


@pytest.mark.parametrize("bn", [False, True])
def test_jax_checkpoint_loads_and_port_checkpoint_round_trips(tmp_path, bn):
    """A JAX state.msgpack of the 3-D tog model (`bn` None entries without
    batch norm) loads through the port's reader with JAX's params and
    Adam state; the port's save_checkpoint then reloads bit-equal."""
    jm, tm = _mconfs("tog_3d", add_batch_norm=bn)
    params = _params(jm, seed=5)
    rng = np.random.default_rng(6)
    opt = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim else a,
        jtrain.make_optimizer(jm).init(params))
    jstate = dataclasses.replace(
        jtrain.init_train_state(jax.random.PRNGKey(5), jm), params=params,
        opt_state=opt, step=jnp.asarray(7, jnp.int32))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, jm, {"epoch": 3})
    if not bn:
        assert ckpt.load_params(str(tmp_path / "jax"))["bn"] == [None] * 6
    state, mconf, extra = ckpt.load_checkpoint(
        str(tmp_path / "jax"), init_train_state(0, tm, DEV))
    assert mconf == tm and extra == {"epoch": 3} and state.step == 7
    mu = opt[1].inner_state[0].mu
    for i, (k, t) in enumerate(state.model.jax_named_parameters()):
        np.testing.assert_array_equal(np_(t), _at(params, k), err_msg=k)
        np.testing.assert_array_equal(np_(state.opt_state["mu"][i]),
                                      _at(mu, k), err_msg=k)

    ckpt.save_checkpoint(str(tmp_path / "port"), state, tm, extra)
    back, _, _ = ckpt.load_checkpoint(str(tmp_path / "port"),
                                      init_train_state(1, tm, DEV))
    for (k, a), (_, b) in zip(state.model.jax_named_parameters(),
                              back.model.jax_named_parameters()):
        assert torch.equal(a, b), k
    for k, v in state.opt_state.items():
        w = back.opt_state[k]
        for a, b in (zip(v, w) if isinstance(v, list) else [(v, w)]):
            assert torch.equal(a, b), k


# --- FLOPs and the startup profile -----------------------------------------


# Banked cases whose JAX count is off (fluidnet_tpu/utils/flops.py counts
# a dilate bank at the mres pyramid's size and forgets a bank's pools at
# the join): the port's count is held to the convolutions a forward runs.
FLOPS_BY_RUN = ("dilate_add_2d", "dilate_add_3d")


def _flops_of_a_run(tm, size, monkeypatch):
    """2 x each convolution's output elements x its weight's fan-in, over
    the convolutions of one trunk forward on a batch of 1 at `size` (x, y,
    z), run on meta tensors (shapes only)."""
    import math

    import torch.nn.functional as F

    from fluidnet_tpu_torch.models.fluidnet import num_input_channels
    total = []
    for name in ("conv2d", "conv3d"):
        real = getattr(F, name)

        def counted(x, w, *a, _real=real, **k):
            out = _real(x, w, *a, **k)
            total.append(2 * out.numel() * math.prod(w.shape[1:]))
            return out
        monkeypatch.setattr(F, name, counted)
    net = FluidNet(tm, device="meta")
    X, Y, Z = size if tm.is_3d else size[:2] + (1,)
    net.trunk(torch.empty((1, num_input_channels(tm), Z, Y, X),
                          device="meta"))
    monkeypatch.undo()
    return sum(total)


@pytest.mark.parametrize("case", sorted(CASES) + ["default_2d", "default_3d",
                                                  "yang_3d"])
def test_model_flops_match_jax(case, monkeypatch):
    if case in CASES:
        jm, tm = _mconfs(case)
    else:
        kw = dict(is_3d=case.endswith("3d"), model_type=case[:-3])
        if kw["model_type"] == "yang":
            from fluidnet_tpu.core.config import InputChannels as JIC
            from fluidnet_tpu_torch.core.config import InputChannels as TIC
            jm = JModelConfig(nonlin_type="sigmoid",
                              input_channels=JIC(u_div=False), **kw)
            tm = ModelConfig(nonlin_type="sigmoid",
                             input_channels=TIC(u_div=False), **kw)
        else:
            jm, tm = JModelConfig(**kw), ModelConfig(**kw)
    for size in ((128, 128, 128 if tm.is_3d else 1), (64, 32, 16)):
        want = _flops_of_a_run(tm, size, monkeypatch) \
            if case in FLOPS_BY_RUN else jflops.model_flops(jm, size)
        assert flops.model_flops(tm, size) == want
        assert flops.model_peak_activation(tm, size) == \
            jflops.model_peak_activation(jm, size)


def test_bundled_m2d_flops():
    """The bundled 2-D model: the JAX package's analytic count exactly
    (241,172,480 at 128x128), within 5% of the 243,793,922 the reference
    recorded (data/models/myModel2D_mconf.txt:17), which also counts the
    nonlinearities and the physics glue (tests/test_utils_cli.py)."""
    mconf = ckpt.load_mconf("data/models_bundled/m2d")
    f = flops.model_flops(mconf, (128, 128, 1))
    assert f == jflops.model_flops(
        jckpt.load_mconf("data/models_bundled/m2d"), (128, 128, 1))
    assert f == 241_172_480
    assert abs(f - 243_793_922) / 243_793_922 < 0.05


def test_train_cli_runs_the_startup_profile(tmp_path, capsys):
    """cli.train with its default -profile true, a 3-D tog model, one
    epoch on a tiny generated set on the CPU."""
    from fluidnet_tpu_torch.cli.train import main
    from fluidnet_tpu_torch.data.generate import generate_dataset
    generate_dataset(str(tmp_path / "d3"), n_tr=2, n_te=1, seed=5,
                     scenes_per_batch=2, size_xyz=(8, 8, 8), is_3d=True,
                     n_frames=4, save_every=2, max_iter=100, device=DEV)
    state, mconf = main(["-data_dir", str(tmp_path), "-dataset", "d3",
                         "-model_dir", str(tmp_path / "models"),
                         "-model_filename", "m", "-batch_size", "2",
                         "-max_epochs", "1", "-rollout_select_steps", "0",
                         "-new_model.model_type", "tog",
                         "-new_model.long_term_div_num_steps", "[1,2]",
                         "-new_model.loss_reject_threshold", "100.0",
                         "--device", "cpu"])
    assert mconf.model_type == "tog" and state.step == 2
    out = capsys.readouterr().out
    want = flops.model_flops(mconf, (128, 128, 128))
    assert want == jflops.model_flops(
        JModelConfig(is_3d=True, model_type="tog"), (128, 128, 128))
    line = [ln for ln in out.splitlines()
            if ln.startswith("==> Model FLOPs/frame @128: ")]
    assert len(line) == 1 and f"{want:,}" in line[0], out
    assert "ms/batch" in line[0]


def test_profiler_timer_profile_fprop_and_trace():
    """profile_fprop times a call; the span recorder records the spans
    entered inside recording() on every thread, each under the span open
    around it on its own thread, and nothing outside it."""
    import threading

    from fluidnet_tpu_torch.utils.profiler import (profile_fprop,
                                                   recording, span)
    x = torch.ones(64, 64)
    assert profile_fprop(lambda a: a @ a, (x,), min_seconds=0.05) > 0
    with span("outside"):
        pass
    with recording() as spans:
        with span("a"):
            with span("b"):
                x @ x
            t = threading.Thread(target=lambda: span("c").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    assert [s.name for s in spans] == ["a", "b", "c"]
    a, b, c = spans
    assert (a.parent, b.parent, c.parent) == (None, a.id, None)
    assert a.tid == b.tid != c.tid
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns
    assert 0 < b.end_ns - b.start_ns <= a.end_ns - a.start_ns
