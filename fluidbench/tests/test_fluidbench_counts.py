"""The yardstick's counts: the trunk's operations, each roofline's bytes
against a count by hand at a small shape, the kernel-name groups, and the
readers on a stretch whose numbers are known."""

import json
import os

import pytest
import torch

from fluidbench import flops, spec, tracing
from fluidbench.kernels import convolutions, k1, k2, k4, k6
from fluidbench.metrics import _common


def _config(name):
    with open(os.path.join(spec.PKG, "configs", name + ".json")) as f:
        return json.load(f)


def test_model_flops():
    m3d, tog = _config("m3d_v5"), _config("tog")
    assert flops.model_flops(m3d["layers"], 3, (1, 1, 1)) == 8352
    assert abs(flops.model_flops(tog["layers"], 3, (128,) * 3) / 1e9 -
               14.2) < 0.05


@pytest.mark.parametrize("name", ["m3d_v5", "tog"])
@pytest.mark.parametrize("res", [64, 128])
def test_model_flops_equal_the_ports(name, res):
    from fluidnet_tpu_torch.core.config import from_dict
    from fluidnet_tpu_torch.utils.flops import model_flops
    c = _config(name)
    assert flops.model_flops(c["layers"], 3, (res,) * 3) == \
        model_flops(from_dict(c["mconf"]), (res, res, res))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_k1_bytes_by_hand():
    """The advection's inputs read once and outputs written once."""
    shape = (2, 1, 6, 7, 8)
    u = torch.zeros((2, 3) + shape[2:])
    s = mask = free = torch.zeros(shape)
    cells = 2 * 6 * 7 * 8
    assert k1.step_cost(cells)[0] == _nbytes(u, s, mask, free) + \
        _nbytes(u, s)
    assert k1.step_cost(cells)[1] == 756 * cells


def test_k2_bytes_by_hand():
    """The prologue's u, flags and density in, u and div out, the
    inflow's slab (bc and mask) in."""
    shape = (1, 1, 6, 7, 8)
    u = torch.zeros((1, 3) + shape[2:])
    flags = torch.zeros(shape, dtype=torch.int32)
    rho = div = torch.zeros(shape)
    ubc = uinv = torch.zeros((1, 3, 6, 4, 8))
    cells, slab = 6 * 7 * 8, 6 * 4 * 8
    assert k2.step_cost(cells, slab)[0] == \
        _nbytes(u, flags, rho, ubc, uinv) + _nbytes(u, div)


def test_k6_bytes_match_the_launches_of_a_train_step(monkeypatch):
    """Each K6 launch of a port train step reads the cotangent and the
    positions and writes the gradient; their sum is train_step_bytes."""
    import fluidnet_tpu_torch.ops.cuda.mac_sweep as ms
    from fluidnet_tpu_torch.train.train import Draws, train_step
    from fluidbench.tests import small
    c, r = small.run("m3d_v5.train64", seconds=0)
    seen = []
    real = ms.warp_transpose

    def counted(g, px, py, pz, *a, **k):
        out = real(g, px, py, pz, *a, **k)
        seen.append(_nbytes(g, px, py, pz, out))
        return out
    monkeypatch.setattr(ms, "warp_transpose", counted)
    from fluidnet_tpu_torch.core.config import from_dict
    from fluidnet_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_tpu_torch.train.train import init_train_state
    from fluidbench import weights
    mconf = from_dict(c.config["mconf"])
    model = weights.load_into(FluidNet(mconf, device="cpu"), r.weights)
    state = init_train_state(0, mconf, "cpu", model=model)
    batch = {k: torch.from_numpy(v[:2]) for k, v in r.pool.items()}
    for n in (2, 3):
        seen.clear()
        d = Draws(*spec.plugin("drivers", "train").draws(
            c.config["mconf"], 5, 0))
        train_step(state, batch, None, mconf, n, draws=d)
        assert sum(seen) == k6.train_step_bytes(n, 2 * 16 ** 3)


NAMES = {
    "void (anonymous namespace)::mac_sweep_tiled<1, 8, true, true, true, "
    "true, true>((anonymous namespace)::Args)": "k1",
    "void (anonymous namespace)::prologue_kernel<true, true, 16>(float "
    "const*, int const*)": "k2",
    "void (anonymous namespace)::prologue_kernel<false, false, 8>(float "
    "const*)": "k4",
    "void (anonymous namespace)::warp_transpose_tiled<1>(float const*)":
        "k6",
    "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize256x32x32_stage4": "conv",
    "void implicit_convolveNd_sgemm<__nv_bfloat16, 3, 1024, 5, 5, 3, 3, 3, "
    "1, false, false, true>(int, int)": "conv",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)": "glue",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
    "impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIterator&)":
        "glue",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_kernel_groups(name):
    got = [g for g, mod in (("k1", k1), ("k2", k2), ("k4", k4), ("k6", k6),
                            ("conv", convolutions)) if mod.matches(name)]
    assert got == ([] if NAMES[name] == "glue" else [NAMES[name]])
    assert _common.is_glue(name) == (NAMES[name] == "glue")


def _stretch(kind, **kw):
    base = dict(kind=kind, steps=10, frames=5, horizons=[4] * 9 + [8],
                cells=1000, cells_per_sample=1000, batch=1,
                config=_config("m3d_v5"), peaks=spec.peaks(),
                plain_wall_s=0.05, host_cpu_s=0.02, window_s=0.1,
                kernels=[("mac_sweep_tiled<1>", 0.002),
                         ("prologue_kernel<true, true, 16>", 0.001),
                         ("warp_transpose_tiled<1>", 0.004),
                         ("sm80_xmma_fprop_implicit_gemm", 0.003),
                         ("vectorized_elementwise_kernel", 0.005)],
                copies=[("Memcpy DtoH (Device -> Pageable)", 0.0025)],
                busy_s=0.04, slab_cells=100)
    base.update(kw)
    return tracing.Stretch(**base)


def test_readers_on_a_known_stretch():
    r = _stretch("rollout")
    read = {m: spec.reader(m)(r) for m in (
        "host_ms_per_step.rollout", "kernels_per_step.rollout",
        "conv_ms_per_step.rollout", "idle_share.rollout", "frame_copy_ms",
        "k1_roofline.rollout", "k2_roofline.rollout", "mfu.rollout",
        "glue_ms_per_step.train")}
    assert read["host_ms_per_step.rollout"] == pytest.approx(2.0)
    assert read["kernels_per_step.rollout"] == pytest.approx(0.5)
    assert read["conv_ms_per_step.rollout"] == pytest.approx(0.3)
    assert read["idle_share.rollout"] == pytest.approx(60.0)
    assert read["frame_copy_ms"] == pytest.approx(0.5)
    assert read["k1_roofline.rollout"] == pytest.approx(
        100 * 10 * 40 * 1000 / 3.35e12 / 0.002)
    assert read["k2_roofline.rollout"] == pytest.approx(
        100 * 10 * (36 * 1000 + 24 * 100) / 3.35e12 / 0.001)
    assert read["mfu.rollout"] == pytest.approx(
        100 * 8352 * 1000 * 10 / 0.05 / 989e12)
    assert read["glue_ms_per_step.train"] is None
    t = _stretch("train", batch=6, cells=6000)
    assert spec.reader("k6_roofline.train")(t) == pytest.approx(
        100 * (9 * 3 + 7) * 200 * 6000 / 3.35e12 / 0.004)
    assert spec.reader("glue_ms_per_step.train")(t) == pytest.approx(0.5)
    assert spec.reader("mfu.train")(t) == pytest.approx(
        100 * 3 * 8352 * 1000 * 6 * (9 * 5 + 9) / 0.05 / 989e12)
    assert spec.reader("k1_roofline.rollout")(t) is None
    assert spec.reader("frame_copy_ms")(_stretch("rollout", copies=[])) \
        is None
    assert spec.reader("k1_roofline.rollout")(
        _stretch("rollout", kernels=[])) is None


def test_trace_reduction():
    """Busy time is the union of device intervals inside the span; a gap
    is labelled by the innermost host span open at its middle."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": tracing.SPAN,
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 10,
           "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 90},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 10, "dur": 15},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 50,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 200,
           "dur": 10}]
    kernels, copies, busy, window, gaps = tracing.reduce(ev)
    assert [n for n, _ in kernels] == ["a", "b"]
    assert busy == pytest.approx(35e-6) and window == pytest.approx(1e-4)
    assert gaps["aten::cat"] == pytest.approx(25e-6)
    assert gaps["outer"] == pytest.approx(40e-6)
    assert set(gaps) == {"aten::cat", "outer"}
    b = tracing.breakdown(kernels, gaps)
    assert b["device_ops"][0] == ["a", pytest.approx(20e-6)]
