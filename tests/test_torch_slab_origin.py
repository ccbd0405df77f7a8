"""The z origin of the port's position kernels, K1 (fused and unfused), K5
and K6, through their plain versions (the card holds each kernel to its
plain version to the bit: tests/test_torch_cuda.py, chip_smoke.py).

A slab of a z-sharded grid gives K1, K5 and K6 the global index z0 of its
first plane. Its positions are then global, (z0 + k) + clip(d) in z, and
a weight p - floor(p) rounds as the whole grid's. Here, on a random
2x16^3 grid with obstacles, Stick and Empty cells:

  - at z0 = 0 every form gives the bits it gave before the origin existed
    (the sha256 of its output, recorded from the tree before the change);
  - the whole grid placed at a global first plane Z0 (0 and two origins in
    the thousands), and a slab of it (own planes [a, b), MARGIN planes
    more on each side) given its own origin Z0 + a - MARGIN, agree to the
    bit on the slab's own planes;
  - the same slab at origin 0, its positions local as they were before
    the origin existed, differs there: the test bites (nearest mode, which
    rounds nothing, keeps global positions and loses the origin);
  - the whole grid at an origin in the thousands agrees with the whole
    grid at 0 but for the positions' rounding (at most ROUND_SHARE of the
    cells past ROUND of the field's largest value), end planes included:
    the clamps and the window tests sit at the array's ends.

K1 computes its positions in-kernel from u. K5 and K6 take them: the
whole grid's are (Z0 + k + 0.5) + d, with d uniform in +-(W - 1e-3) (the
callers' clip), and the slab's at origin 0 are (k + 0.5) + d.
"""

import hashlib

import numpy as np
import pytest
import torch

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.ops.advect_fast import chebyshev_free_space
from fluidnet_tpu_torch.ops.cuda import mac_sweep, warp_transpose
from fluidnet_tpu_torch.ops import warp

from tests.torch_port_util import random_flags

SHAPE = (2, 1, 16, 16, 16)
DT, STRENGTH = 0.1, 0.6
ORIGINS = (0, 1021, 2998)      # the whole grid's first global plane
SLABS = ((3, 8), (8, 13))      # a slab's own planes [a, b)
MARGIN = 3                     # planes a slab holds beyond its own
# The whole grid at an origin against the whole grid at 0: the positions
# round at another magnitude, which moves a value by a few ulps of its
# position times the field's jump across a cell, and flips a corner where
# a displacement lies within an ulp of a whole cell.
ROUND, ROUND_SHARE = 1e-3, 1e-3

# The forms: (kernel, form, window). "fwd" / "bwd" are K1's two sweeps
# ('Ours', renormalised, as the bench), "vel" K1's velocity-only unfused
# sweep; K5 "minmax" is the trilinear warp with the bounds, "nearest"
# gather_cells' mode; K6 "linear" / "nearest" the adjoints.
FORMS = [("k1_fused", "fwd", 1), ("k1_fused", "bwd", 1),
         ("k1_fused", "fwd", 2), ("k1_fused", "bwd", 2),
         ("k1_unfused", "fwd", 1), ("k1_unfused", "bwd", 1),
         ("k1_unfused", "vel", 1), ("k5", "minmax", 1), ("k5", "nearest", 2),
         ("k6", "linear", 1), ("k6", "nearest", 2)]
IDS = [f"{k}-{f}-W{w}" for k, f, w in FORMS]

# sha256 (first 16 hex digits) of each form's output on the whole grid at
# z0 = 0, recorded from the port before the z origin existed.
TODAY = {
    "k1_fused-fwd-W1": "71ac776ee18abb41",
    "k1_fused-bwd-W1": "0ee301d57a9c7b24",
    "k1_fused-fwd-W2": "06bf187b98b02bd1",
    "k1_fused-bwd-W2": "644456fb11444792",
    "k1_unfused-fwd-W1": "fde358644dd6ebf3",
    "k1_unfused-bwd-W1": "b19a8eb8fc19a366",
    "k1_unfused-vel-W1": "084bff180bab90fa",
    "k5-minmax-W1": "64a3115bdfe7cf19",
    "k5-nearest-W2": "57692b8419a217ea",
    "k6-linear-W1": "a1e69bc9ed13c4c5",
    "k6-nearest-W2": "6184046d9d17dba6",
}


def _grid():
    """The random grid's fields (float32 CPU tensors, `flags` int32)."""
    rng = np.random.default_rng(1117)
    B, _, Z, Y, X = SHAPE
    flags = random_flags(rng, SHAPE, stick_empty=True)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    # ~1.5 cells a step at dt 0.1: the +-(W - 1e-3) clip binds at W = 1.
    arr = {"flags": torch.from_numpy(flags),
           "u": t(rng.standard_normal((B, 3, Z, Y, X)) * 15.0),
           "s": t(rng.random(SHAPE)),
           "fwd_u": t(rng.standard_normal((B, 3, Z, Y, X))),
           "fwd_s": t(rng.random(SHAPE)),
           "field": t(rng.standard_normal((B, 3, 1, Z, Y, X))),
           "g": t(rng.standard_normal((B, 3, 1, Z, Y, X)))}
    arr["m"] = is_fluid(arr["flags"]).to(torch.float32)
    for W in (1, 2):
        arr[f"free{W}"] = chebyshev_free_space(arr["flags"], W + 1)
        lim = W - 1e-3
        arr[f"d{W}"] = [t(rng.uniform(-lim, lim, (B, 3, Z, Y, X)))
                        for _ in range(3)]
    return arr


def _positions(arr, W, nearest, first):
    """(px, py, pz) of K5 / K6: the centres plus the displacements d, pz
    from global plane `first`; nearest mode's are whole-cell centres."""
    dx, dy, dz = arr[f"d{W}"]
    Z, Y, X = dx.shape[2:]
    cx = torch.arange(X, dtype=torch.float32).view(1, 1, 1, 1, X) + 0.5
    cy = torch.arange(Y, dtype=torch.float32).view(1, 1, 1, Y, 1) + 0.5
    cz = torch.arange(first, first + Z,
                      dtype=torch.float32).view(1, 1, Z, 1, 1) + 0.5
    pos = [cx + dx, cy + dy, cz + dz]
    if nearest:
        pos = [torch.floor(p) + 0.5 for p in pos]
    return pos


def _cut(x, lo, hi):
    """Planes [lo, hi) of z (axis 2 of K1's fields, 3 of K5 / K6's
    fields; positions (b, G, z, y, x) on axis 2)."""
    ax = 3 if x.dim() == 6 else 2
    return x.narrow(ax, lo, hi - lo).contiguous()


def _run(form, arr, z0, pos_first=None):
    """The form's plain version on `arr` at the z origin z0 (K5 / K6 with
    positions from global plane pos_first, default z0). Returns one
    tensor, z on axis 2 (K5 / K6: of the (b, G * F, z, y, x) view)."""
    kernel, kind, W = form
    a = arr
    if kernel in ("k1_fused", "k1_unfused"):
        free = a[f"free{W}"]
        bwd = kind == "bwd"
        if kernel == "k1_fused":
            out = mac_sweep.sweep_fused_ep_plain(
                a["u"], a["s"], a["m"], a["fwd_u"] if bwd else None,
                a["fwd_s"] if bwd else None, free, DT if bwd else -DT,
                STRENGTH, W, True, True, z0=z0)
            return torch.cat([out[k] for k in sorted(out)], dim=1)
        scalar = kind != "vel"
        return mac_sweep.sweep_plain(
            a["u"], None if bwd or not scalar else a["s"],
            a["m"] if scalar else None, a["fwd_u"] if bwd else None,
            a["fwd_s"] if bwd and scalar else None, free,
            DT if bwd else -DT, W, True, scalar, scalar, z0=z0)
    nearest = kind == "nearest"
    first = z0 if pos_first is None else pos_first
    px, py, pz = _positions(a, W, nearest, first)
    if kernel == "k5":
        out = warp.warp_group_plain(a["field"], px, py, pz, W, nearest,
                                    not nearest, z0=z0)
    else:
        out = warp_transpose.warp_transpose_plain(a["g"], px, py, pz, W,
                                                  nearest, z0=z0)
    return out.flatten(1, 2)


def _slab(arr, lo, hi):
    """The fields of planes [lo, hi); K5 / K6's displacements too."""
    out = {k: _cut(v, lo, hi) for k, v in arr.items()
           if not k.startswith(("d", "free"))}
    for W in (1, 2):
        out[f"d{W}"] = [_cut(d, lo, hi) for d in arr[f"d{W}"]]
        # The free space is a whole-grid input (a slab's own comes from
        # its flags grown by the ghost zone).
        out[f"free{W}"] = _cut(arr[f"free{W}"], lo, hi)
    return out


def _digest(x):
    return hashlib.sha256(np.ascontiguousarray(
        x.numpy()).tobytes()).hexdigest()[:16]


@pytest.fixture(scope="module")
def grid():
    return _grid()


@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_origin_zero_is_unchanged(grid, form):
    """At z0 = 0 the output is the one recorded before the origin existed,
    to the bit."""
    name = IDS[FORMS.index(form)]
    out = _run(form, grid, 0)
    assert torch.isfinite(out[out.abs() < 1e29]).all()
    assert _digest(out) == TODAY[name], name


@pytest.mark.parametrize("origin", ORIGINS)
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_slab_at_its_origin_equals_whole_grid(grid, form, origin):
    """The whole grid at global first plane `origin`; each slab of it,
    given its own first plane, equals it on the slab's own planes to the
    bit."""
    whole = _run(form, grid, origin)
    for a, b in SLABS:
        lo, hi = a - MARGIN, b + MARGIN
        got = _run(form, _slab(grid, lo, hi), origin + lo)
        assert torch.equal(got[:, :, MARGIN:MARGIN + b - a],
                           whole[:, :, a:b]), (form, origin, a, b)


@pytest.mark.parametrize("origin", ORIGINS[1:])
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_slab_at_origin_zero_differs(grid, form, origin):
    """The same slabs at origin 0, with positions local as before the
    origin existed, do not equal the whole grid at `origin` on their own
    planes: the rounding the origin removes is there to see. Nearest mode
    rounds nothing (its positions are whole-cell centres): its slabs keep
    the global positions and lose only the origin, which must show."""
    whole = _run(form, grid, origin)
    for a, b in SLABS:
        lo, hi = a - MARGIN, b + MARGIN
        first = origin + lo if form[1] == "nearest" else 0
        got = _run(form, _slab(grid, lo, hi), 0, pos_first=first)
        assert not torch.equal(got[:, :, MARGIN:MARGIN + b - a],
                               whole[:, :, a:b]), (form, origin, a, b)


@pytest.mark.parametrize("origin", ORIGINS[1:])
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_origin_moves_only_the_rounding(grid, form, origin):
    """The whole grid at `origin` against the whole grid at 0: at most
    ROUND_SHARE of the cells differ by more than ROUND of the field's
    largest value (the bounds' +-1e30 sentinels count as equal when both
    are), the end planes, where the clamps act, among them."""
    got, want = _run(form, grid, origin), _run(form, grid, 0)
    big = want.abs() >= 1e29
    assert torch.equal(got.abs() >= 1e29, big), form
    scale = float(want[~big].abs().max())
    err = torch.where(big, 0.0, (got - want).abs()) / scale
    assert float((err > ROUND).double().mean()) <= ROUND_SHARE, form
    ends = err[:, :, [0, -1]]
    assert float((ends > ROUND).double().mean()) <= ROUND_SHARE, form


# The advections that take the origin, as the z-sharded step runs them:
# (method, fused epilogue); "maccormack" is Manta's, its density on K5
# (with the clamp lookups' gathers) and its velocity on K1's unfused
# sweeps, the rest the combined sweeps of advect_vel_scalar_fast.
ADVECTIONS = [("maccormack", None), ("maccormackOurs", True),
              ("maccormackOurs", False)]
ADV_OWN, ADV_MARGIN = (6, 10), 4   # a slab's own planes; 2W + 2 a side


def _advect(arr, method, fused, z0):
    """(s, u) after one advection at W = 1 and the z origin z0."""
    from fluidnet_tpu_torch.ops.advect_fast import (advect_scalar_fast,
                                                    advect_vel_fast,
                                                    advect_vel_scalar_fast)
    u, s, flags = arr["u"] * 0.1, arr["s"], arr["flags"]
    if fused is None:
        return (advect_scalar_fast(DT, s, u, flags, method, False, STRENGTH,
                                   1, z0=z0),
                advect_vel_fast(DT, u, flags, method, STRENGTH, 1, z0=z0))
    return advect_vel_scalar_fast(DT, s, u, flags, method, False, STRENGTH,
                                  1, fused_epilogue=fused, z0=z0)


@pytest.mark.parametrize("method,fused", ADVECTIONS)
def test_advection_on_a_slab_equals_whole_grid(grid, method, fused):
    """The whole grid's advection at global first plane ORIGINS[-1], and a
    slab of it grown by 2W + 2 planes a side at its own origin: equal on
    the slab's own planes to the bit (s and u), every clamp lookup and
    free space the slab's own; at origin 0 the slab differs there. The
    whole grid at that origin agrees with the whole grid at 0 but for the
    positions' rounding (as test_origin_moves_only_the_rounding)."""
    (a, b), m = ADV_OWN, ADV_MARGIN
    whole = _advect(grid, method, fused, ORIGINS[-1])
    slab = _slab(grid, a - m, b + m)
    got = _advect(slab, method, fused, ORIGINS[-1] + a - m)
    local = _advect(slab, method, fused, 0)
    for w, g, l, w0 in zip(whole, got, local,
                           _advect(grid, method, fused, 0)):
        assert torch.equal(g[:, :, m:m + b - a], w[:, :, a:b]), method
        err = (w - w0).abs() / float(w0.abs().max())
        assert float((err > ROUND).double().mean()) <= ROUND_SHARE, method
    assert not all(torch.equal(l[:, :, m:m + b - a], w[:, :, a:b])
                   for w, l in zip(whole, local)), method
