"""The port's stability statistics (utils/stats.calc_stats, cli/stats.py)
and the dataset statistics (FluidDataset.field_stats / histogram) against
the JAX package's.

calc_stats: one seeded 3-D batch of two 12^3 samples with 10% obstacles,
restarted from its targets and stepped 3 times with jacobi-34 and with the
bundled m3d_v5_bestRollout ConvNet, with its own config (maccormackOurs,
W = 1) and float32 convolutions (tests/torch_port_util.float32_copy: with
the bundled bf16 ones the JAX trunk's extra bf16 roundings move these
norms by ~0.2%); the JAX side as tests/conftest.py runs it, with the
unfused forms, which its own tests hold equal to the fused ones. The
||div||_2 per step and sample agree to rtol 1e-4: float32 solves and
convolutions summed in other orders move the norm of the field by far
less. cli.stats.compute on a dataset the port generates (8^3, PCG)
writes one TSV per method, finite, and main draws the figure; the
dataset's statistics equal JAX's to rtol 1e-12 (float64 sums over the
same float32 frames) and its histograms exactly.
"""

import os

import numpy as np
import pytest

import jax

from fluidnet_tpu.data.dataset import FluidDataset as JFluidDataset
from fluidnet_tpu.models.fluidnet import apply_model
from fluidnet_tpu.train.train import init_train_state as j_init_train_state
from fluidnet_tpu.utils.checkpoint import load_checkpoint as j_load_ckpt
from fluidnet_tpu.utils.checkpoint import load_mconf as j_load_mconf
from fluidnet_tpu.utils.stats import calc_stats as j_calc_stats

from fluidnet_tpu_torch.cli import stats as stats_cli
from fluidnet_tpu_torch.data.dataset import FluidDataset
from fluidnet_tpu_torch.data.generate import generate_dataset
from fluidnet_tpu_torch.models.fluidnet import FluidNet
from fluidnet_tpu_torch.utils.checkpoint import load_mconf, load_params
from fluidnet_tpu_torch.utils.stats import calc_stats

from tests.torch_port_util import (BUNDLED_3D, DEV, float32_copy,
                                   random_flags)

BUNDLED = BUNDLED_3D
N = 12


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(80)
    shape = (2, 1, N, N, N)
    return {"flags": random_flags(rng, shape, p_obstacle=0.1),
            "u_target": (rng.standard_normal((2, 3, N, N, N)) * 0.3).astype(
                np.float32),
            "p_target": rng.standard_normal(shape).astype(np.float32),
            "density": rng.random(shape).astype(np.float32)}


@pytest.mark.parametrize("method", ["jacobi", "convnet"])
def test_calc_stats_matches_jax(batch, method, tmp_path):
    ckpt = float32_copy(BUNDLED, str(tmp_path / "m3d_v5_f32"))
    jstate, jmconf, _ = j_load_ckpt(ckpt, j_init_train_state(
        jax.random.PRNGKey(0), j_load_mconf(ckpt)))
    jmconf = jmconf.replace(sim_method=method, max_iter=34)
    tmconf = load_mconf(ckpt).replace(sim_method=method, max_iter=34)
    net = method == "convnet"
    j = j_calc_stats(
        [batch], jmconf,
        (lambda pr, p, u, f, **kw: apply_model(pr, jmconf, p, u, f, **kw))
        if net else None, jstate.params if net else None, n_steps=3)
    model = FluidNet(tmconf, device=DEV).load_jax_params(
        load_params(ckpt)) if net else None
    t = calc_stats([batch], tmconf, model, n_steps=3, device=DEV)
    assert t.shape == j.shape == (2, 3)
    assert np.isfinite(t).all() and (t > 0).all()
    np.testing.assert_allclose(t, j, rtol=1e-4)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stats"))
    generate_dataset(os.path.join(root, "tiny3d"), n_tr=0, n_te=1, seed=5,
                     size_xyz=(8, 8, 8), is_3d=True, n_frames=3,
                     max_iter=200, device=DEV)
    return root


def test_stats_cli_compute_and_plot(dataset, tmp_path):
    out = str(tmp_path / "out")
    argv = ["--data_dir", dataset, "--dataset", "tiny3d", "--methods",
            "convnet", "jacobi", "pcg", "--n_steps", "4", "--out_dir", out,
            "--device", "cpu"]
    got = stats_cli.compute(stats_cli.parse_args(argv))
    n = len(FluidDataset(dataset, "tiny3d", "te"))
    assert set(got) == {"jacobi", "pcg"}        # convnet needs --model
    for method, arr in got.items():
        tsv = np.loadtxt(os.path.join(out, f"norm_div_{method}.tsv"),
                         ndmin=2)
        assert tsv.shape == (n, 4) and np.isfinite(tsv).all()
        np.testing.assert_allclose(tsv, arr, rtol=1e-6)
    assert got["pcg"][:, -1].mean() < got["jacobi"][:, -1].mean()
    paths = stats_cli.main(argv[:5] + ["convnet", "--model", BUNDLED] +
                           argv[8:])
    assert os.path.isfile(os.path.join(out, "norm_div_convnet.tsv"))
    assert paths == [os.path.join(out, "norm_div_compare.png")]
    assert os.path.getsize(paths[0]) > 0


def test_dataset_stats_match_jax(dataset, tmp_path):
    t, j = (FluidDataset(dataset, "tiny3d", "te"),
            JFluidDataset(dataset, "tiny3d", "te"))
    ts, js = t.field_stats(), j.field_stats()
    assert ts.keys() == js.keys()
    for f in ts:
        for k in ("mean", "std", "min", "max"):
            np.testing.assert_allclose(ts[f][k], js[f][k], rtol=1e-12)
    for field in ("u_div", "p_div", "density"):
        for a, b in zip(t.histogram(field, max_samples=2),
                        j.histogram(field, max_samples=2)):
            np.testing.assert_array_equal(a, b)
    out = str(tmp_path / "ds")
    args = stats_cli.parse_args(["--data_dir", dataset, "--dataset",
                                 "tiny3d", "--dataset_stats", "--out_dir",
                                 out])
    hists = stats_cli.compute(args)
    assert list(hists) == ["u_div", "p_div", "density"]
    assert os.path.isfile(os.path.join(out, "dataset_stats.json"))
    assert len(stats_cli.plot(args, hists)) == 3
