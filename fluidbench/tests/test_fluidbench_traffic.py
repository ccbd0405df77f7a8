"""The traffic generators repeat by seed, differ across seeds, keep the
same work for every seed, and make what the port's own builders make."""

import random

import numpy as np
import pytest
import torch

from fluidbench import spec
from fluidbench.scenes import noise_pool, plume, shapes
from fluidbench.tests import small

A, B = 2 ** 31 + 101, 2 ** 31 + 202
TRAIN = spec.plugin("drivers", "train")


def test_plume_scene_repeats_by_seed_and_differs_across_seeds():
    mix = small.cell("m3d_v5.plume128").mix
    a, a2, b = (plume.make(mix, s, "cpu") for s in (A, A, B))
    assert torch.equal(a["flags"], a2["flags"])
    assert not torch.equal(a["flags"], b["flags"])
    for k in ("u", "p", "density"):
        assert torch.equal(a[k], b[k])      # the first state: at rest
    assert torch.equal(a["bcs"]["u"][0], b["bcs"]["u"][0])


def test_training_pool_repeats_by_seed_and_differs_across_seeds():
    mix = small.cell("m3d_v5.train64").mix
    a, a2, b = (noise_pool.make(mix, s, "cpu") for s in (A, A, B))
    for k in a:
        assert np.array_equal(a[k], a2[k])
    assert not np.array_equal(a["u_div"], b["u_div"])
    assert not np.array_equal(a["density"], b["density"])
    assert not np.array_equal(a["flags"], b["flags"])
    assert not a["p_div"].any()


def test_pool_fills_the_device_cache_in_whole_batches():
    mix = spec.cell("m3d_v5.train64").mix
    n = noise_pool.pool_size(mix)
    assert n % mix["batch"] == 0
    per = noise_pool.sample_bytes(mix["res"])
    assert per == 4 * 6 * 64 ** 3
    assert n * per <= mix["pool_gb"] * 1e9 < (n + mix["batch"]) * per
    assert n == 1266


def test_pool_chunks_do_not_change_it(monkeypatch):
    mix = dict(small.cell("m3d_v5.train64").mix, res=12)
    whole = noise_pool.make(mix, A, "cpu")
    monkeypatch.setattr(noise_pool, "CHUNK", 3)
    for k, v in noise_pool.make(mix, A, "cpu").items():
        assert np.array_equal(v, whole[k]), k


def test_obstacles_follow_the_generators_laws():
    """Each sample's obstacles are the port's random_obstacle_flags drawn
    from the same numbers."""
    from fluidnet_tpu_torch.core.grids import empty_domain
    res, n = 16, 6
    rng = np.random.default_rng(7)
    draws = noise_pool._obstacle_draws(rng, n, res, 3)
    got = noise_pool._flags(draws, (res,) * 3, "cpu")
    active, is_box, centre, size = draws
    zz, yy, xx = np.meshgrid(*(np.arange(res),) * 3, indexing="ij")
    for i in range(n):
        want = empty_domain((1, 1, res, res, res), True,
                            device="cpu").numpy().copy()
        for j in np.flatnonzero(active[i]):
            (cz, cy, cx), r = centre[i, j], size[i, j]
            if is_box[i, j]:
                m = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r) & \
                    (np.abs(zz - cz) <= r)
            else:
                m = (xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2 <= r * r
            want[0, 0][m] = shapes.TYPE_OBSTACLE
        assert np.array_equal(got[i:i + 1].numpy(), want), i
    assert active.sum(1).max() <= 3 and active.any()
    assert (size >= 2).all() and (size < max(3, res // 6)).all()


def test_draws_repeat_by_seed_and_match_the_ports():
    from fluidnet_tpu_torch.core.config import from_dict
    from fluidnet_tpu_torch.train.train import draw
    mix = small.cell("m3d_v5.train64")
    mconf = mix.config["mconf"]
    for step in range(5):
        a = TRAIN.draws(mconf, A, step)
        assert all(torch.equal(x, y)
                   for x, y in zip(a, TRAIN.draws(mconf, A, step)))
        gen = torch.Generator().manual_seed(
            (A * 1000003 + step) % 2 ** 63)
        assert all(torch.equal(x, y)
                   for x, y in zip(a, draw(gen, from_dict(mconf))))
    assert any(not torch.equal(TRAIN.draws(mconf, A, s)[0],
                               TRAIN.draws(mconf, B, s)[0])
               for s in range(5))


@pytest.mark.parametrize("m", [6, 211])
def test_horizons_are_the_training_clis(m):
    """An epoch's horizons: cli/train.py's _horizon_list, the same share
    of each for every seed, in an order of the seed's."""
    from fluidnet_tpu_torch.cli.train import _horizon_list
    from fluidnet_tpu_torch.core.config import from_dict
    c = spec.cell("m3d_v5.train64")
    mconf = from_dict({**c.config["mconf"],
                       "long_term_div_num_steps": c.mix["horizons"],
                       "long_term_div_probability": c.mix["p_short"]})
    runs = []
    for seed in (A, B):
        got = TRAIN.horizon_list(random.Random(seed), c.mix["horizons"],
                                 c.mix["p_short"], m)
        assert got == _horizon_list(random.Random(seed), mconf, None, m)
        runs.append(got)
    assert sorted(runs[0]) == sorted(runs[1])
    assert got.count(8) == m - round(0.9 * m)
    assert m < 10 or runs[0] != runs[1]


def test_noise_is_divergence_free_on_the_mac_grid():
    from fluidnet_tpu_torch.ops.divergence import velocity_divergence
    rng = np.random.default_rng(3)
    draws = noise_pool._noise_draws(rng, 2, {"n_modes": 24, "max_freq": 6,
                                             "amplitude_low": 3.0,
                                             "amplitude_high": 3.0})
    u = noise_pool._noise(draws, (12, 12, 12), "cpu")
    flags = torch.ones((2, 1, 12, 12, 12), dtype=torch.int32)
    div = velocity_divergence(u, flags)
    assert float(u.abs().max()) > 0
    assert float(div.abs().max()) < 1e-5 * float(u.abs().max())


def test_flags_and_inflow_are_the_ports():
    from fluidnet_tpu_torch.core.grids import FluidState, empty_domain
    from fluidnet_tpu_torch.sim.simulate import create_plume_bcs
    shape = (1, 1, 16, 12, 20)
    assert torch.equal(shapes.empty_flags(1, shape[2:], "cpu"),
                       empty_domain(shape, True, device="cpu"))
    st = FluidState(u=torch.zeros((1, 3) + shape[2:]),
                    p=torch.zeros(shape), flags=empty_domain(
                        shape, True, device="cpu"),
                    density=torch.zeros(shape))
    want = create_plume_bcs(st, [1.0], u_scale=0.6, rad=0.15)
    got = shapes.plume_bcs(1, shape[2:], 1.0, 0.6, 0.15, "cpu")
    assert torch.equal(got["u"][0], want.u_bc)
    assert torch.equal(got["u"][1], want.u_bc_inv_mask)
    assert torch.equal(got["density"][0], want.density_bc)
    assert torch.equal(got["density"][1], want.density_bc_inv_mask)


def test_every_seed_places_the_same_obstacles():
    mix = spec.cell("m3d_v5.plume128").mix
    mix = dict(mix, res=32)
    counts = set()
    for s in range(5):
        sc = plume.make(mix, A + s, "cpu")
        inner = sc["flags"][0, 0, 1:-1, 1:-1, 1:-1]
        counts.add(int((inner == shapes.TYPE_OBSTACLE).sum()) > 0)
    assert counts == {True}
