"""Advection of scalar fields and MAC velocity: the public entry points.

Port of fluidnet_tpu.ops.advect's `advect_scalar` and `advect_vel`
(tfluids.advectScalar / advectVel, torch/tfluids/init.lua:89-220) along
their `window` dispatch: an integer window runs the windowed fast path
(ops/advect_fast.py, kernel K5). The exact gather path (window=None) is not
ported and raises. `_maccormack_correct_mac` is the MacCormack correction
of the velocity that the fast path shares with it.
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.ops import stencil as st

METHODS = ("euler", "maccormack", "eulerOurs", "rk2Ours", "rk3Ours",
           "maccormackOurs")


def _check(method, window):
    if method not in METHODS:
        raise ValueError(f"bad advection method {method!r}")
    if not window:
        raise NotImplementedError("the exact gather advection (window=None) "
                                  "is not ported (ROADMAP queue 1, ops off "
                                  "the main path)")


def advect_scalar(dt, s, u, flags, method="maccormackOurs",
                  sample_outside_fluid=False, maccormack_strength=0.75,
                  boundary_width=1, max_trace_steps=8, window=None,
                  free_space=None, plain=False):
    """Advects the scalar field s (b, 1, z, y, x) by the MAC velocity u.
    `window` W >= 1 runs the windowed fast path with displacements clamped
    to +-W cells. `plain=True` runs K5's plain version on any device."""
    from fluidnet_tpu_torch.ops.advect_fast import advect_scalar_fast
    del boundary_width, max_trace_steps  # the exact path's knobs
    _check(method, window)
    return advect_scalar_fast(dt, s, u, flags, method, sample_outside_fluid,
                              maccormack_strength, window, free=free_space,
                              plain=plain)


def advect_vel(dt, u, flags, method="maccormackOurs",
               maccormack_strength=0.75, boundary_width=1, max_trace_steps=8,
               window=None, free_space=None, plain=False):
    """Self-advects the MAC velocity u (2-D); `window` and `plain` as in
    advect_scalar."""
    from fluidnet_tpu_torch.ops.advect_fast import advect_vel_fast
    del boundary_width, max_trace_steps
    _check(method, window)
    return advect_vel_fast(dt, u, flags, method, maccormack_strength, window,
                           free=free_space, plain=plain)


def _maccormack_correct_mac(old, fwd, bwd, flags, strength, is_3d):
    """MacCormackCorrectMAC (tfluids.cc:660-699): per component, skip where
    the cell or its -axis neighbour is non-fluid; the neighbour counts as
    fluid at the low edge (the reference tests it only for i > 0)."""
    fl = is_fluid(flags)[:, 0]
    skip_all = ~fl
    skips = [skip_all | ~st.xm(fl, True), skip_all | ~st.ym(fl, True)]
    if is_3d:
        skips.append(skip_all | ~st.zm(fl, True))
    comps = []
    for c, skip in enumerate(skips):
        corr = fwd[:, c] + strength * 0.5 * (old[:, c] - bwd[:, c])
        comps.append(torch.where(skip, fwd[:, c], corr))
    return torch.stack(comps, dim=1)
