"""The pool of training samples of a training mix ("scene":
"noise_pool"), made as the port's data generator makes scenes
(data/generate.py): random_obstacle_flags (up to max_obstacles boxes or
spheres of random size and place in the walled domain),
divergence_free_noise (the curl of a band-limited random vector
potential; here the curl by forward differences, so that the MAC grid's
divergence is zero away from the walls, where np.gradient's central
differences leave a divergence that the projection never sees in the
generator's stepped data), a uniform random density, and the pressure
input zero, as the builders' profiler feeds it.

The pool holds as many samples as `pool_gb` gigabytes take, in whole
batches: the mix sets it to the port's default device cache
(cli/train.py's -device_data_cache_max_gb, 8 GB), the largest data set
that training keeps on the card. Every draw of sizes and places comes
from a NumPy generator seeded by the seed, in a few arrays; the fields
are computed on the device a chunk of samples at a time and kept as host
arrays, which DeviceDataset uploads and the reference reads.
"""

import numpy as np
import torch

from fluidbench.scenes.shapes import TYPE_OBSTACLE, empty_flags, solids

KEYS = ("p_div", "u_div", "flags", "density")
CHANNELS = {"p_div": 1, "u_div": 3, "flags": 1, "density": 1}
CHUNK = 64                      # samples computed on the device at once


def sample_bytes(res):
    """A sample's bytes: four-byte cells, CHANNELS channels."""
    return 4 * sum(CHANNELS.values()) * res ** 3


def pool_size(mix):
    """The number of samples: whole batches within pool_gb."""
    per_batch = sample_bytes(mix["res"]) * mix["batch"]
    return max(1, int(mix["pool_gb"] * 1e9 // per_batch)) * mix["batch"]


def _obstacle_draws(rng, n, res, max_obstacles):
    """Per sample and slot: (active, is_box, centre (z, y, x), size), the
    laws of data/generate.random_obstacle_flags (a cube domain)."""
    count = rng.integers(0, max_obstacles + 1, size=n)
    active = np.arange(max_obstacles)[None, :] < count[:, None]
    is_box = rng.random((n, max_obstacles)) < 0.5
    centre = rng.integers(res // 8, res - res // 8, size=(n, max_obstacles, 3))
    size = rng.integers(2, max(3, res // 6), size=(n, max_obstacles))
    return active, is_box, centre, size


def _noise_draws(rng, n, noise):
    """Per sample and mode: the wave numbers (z, y, x), the phase, the
    potential's component and its amplitude (the sample's amplitude,
    uniform in [amplitude_low, amplitude_high], times a standard normal
    over n_modes)."""
    m, f = noise["n_modes"], noise["max_freq"]
    k = rng.integers(1, f + 1, size=(n, m, 3))
    phase = rng.random((n, m)) * 2 * np.pi
    comp = rng.integers(0, 3, size=(n, m))
    lo, hi = noise["amplitude_low"], noise["amplitude_high"]
    amp = (lo + (hi - lo) * rng.random(n))[:, None] * \
        rng.standard_normal((n, m)) / m
    return k, phase, comp, amp


def _flags(draws, shape, device):
    active, is_box, centre, size = (torch.as_tensor(a, device=device)
                                    for a in draws)
    b = active.shape[0]
    flags = empty_flags(b, shape, device)
    for j in range(active.shape[1]):
        solid = solids(is_box[:, j], size[:, j], centre[:, j], shape) & \
            active[:, j].view(b, 1, 1, 1)
        flags = torch.where(solid[:, None], TYPE_OBSTACLE, flags)
    return flags.to(torch.int32)


def _forward_diff(a, dim):
    """a[i + 1] - a[i] along `dim` (0 at the last cell)."""
    n = a.shape[dim]
    return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)],
                     dim=dim) - a


def _noise(draws, shape, device):
    """(b, 3, Z, Y, X) float32: the curl of the potentials, channels (x, y,
    z) as the MAC velocity."""
    k, phase, comp, amp = draws
    b, m = phase.shape
    Z, Y, X = shape
    f32 = dict(device=device, dtype=torch.float32)
    zz, yy, xx = (torch.arange(s, **f32) / s for s in shape)
    zz, yy, xx = zz.view(1, Z, 1, 1), yy.view(1, 1, Y, 1), \
        xx.view(1, 1, 1, X)
    k = torch.as_tensor(k, **f32)
    phase = torch.as_tensor(phase, **f32)
    coef = torch.as_tensor(np.eye(3)[comp] * amp[..., None], **f32)
    pots = torch.zeros((b, 3, Z, Y, X), **f32)
    for i in range(m):
        kz, ky, kx = (k[:, i, c].view(b, 1, 1, 1) for c in range(3))
        wave = torch.cos(2 * np.pi * (kz * zz + ky * yy + kx * xx) +
                         phase[:, i].view(b, 1, 1, 1))
        pots += coef[:, i].view(b, 3, 1, 1, 1) * wave[:, None]
    az, ay, ax = pots[:, 0], pots[:, 1], pots[:, 2]
    d = _forward_diff          # axes (b, z, y, x) = (0, 1, 2, 3)
    return torch.stack([d(az, 2) - d(ay, 1), d(ax, 1) - d(az, 3),
                        d(ay, 3) - d(ax, 2)], dim=1)


def make(mix, seed, device):
    """{"p_div", "u_div", "flags", "density"}: host arrays of pool_size(mix)
    samples at `seed`."""
    res = mix["res"]
    shape = (res, res, res)
    n = pool_size(mix)
    rng = np.random.default_rng(seed)
    obstacles = _obstacle_draws(rng, n, res, mix["max_obstacles"])
    noise = _noise_draws(rng, n, mix["noise"])
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {k: np.empty((n, CHANNELS[k]) + shape,
                       np.int32 if k == "flags" else np.float32)
           for k in KEYS}
    out["p_div"][:] = 0
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        out["flags"][lo:hi] = _flags([a[lo:hi] for a in obstacles], shape,
                                     device).cpu().numpy()
        out["u_div"][lo:hi] = _noise([a[lo:hi] for a in noise], shape,
                                     device).cpu().numpy()
        out["density"][lo:hi] = torch.rand(
            (hi - lo, 1) + shape, generator=gen, device=device).cpu().numpy()
    return out


class Pool:
    """The pool as the dataset DeviceDataset uploads: get_batch(indices)
    gives a dict of stacked host arrays."""

    def __init__(self, fields):
        self.fields = fields

    def __len__(self):
        return len(self.fields["flags"])

    def get_batch(self, indices):
        idx = np.asarray(list(indices))
        return {k: v[idx] for k, v in self.fields.items()}
