"""Frozen copy of the plain PyTorch ops of fluidnet_tpu_torch at commit
a3725f6 (ops/sdf.py, train/loss.py), kept here so that the benchmark's
reference does not move with the program. Edits: the kernel dispatch is
gone (every op runs its plain version, on any device), and the grid
masks are built on the device they are asked for.
"""

from typing import Optional

import torch

from fluidbench.reference import grid as st
from fluidbench.reference.grid import is_obstacle
from fluidbench.reference.physics import velocity_divergence


def signed_distance_field(flags, search_rad: int):
    """Distance (in cells, Euclidean) to the nearest obstacle within
    search_rad; clamped at search_rad; 0 inside obstacles."""
    is_3d = flags.shape[2] > 1
    ob = is_obstacle(flags)
    r = int(search_rad)
    dist_sq = torch.full(flags.shape, float(r * r), dtype=torch.float32,
                         device=flags.device)
    zr = range(-r, r + 1) if is_3d else [0]
    for dz in zr:
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                d2 = float(dz * dz + dy * dy + dx * dx)
                if d2 >= r * r and (dz, dy, dx) != (0, 0, 0):
                    continue
                m = ob
                if dz:
                    m = st.shift(m, dz, st.AX_Z, False)
                if dy:
                    m = st.shift(m, dy, st.AX_Y, False)
                if dx:
                    m = st.shift(m, dx, st.AX_X, False)
                dist_sq = torch.where(m, torch.clamp_max(dist_sq, d2),
                                      dist_sq)
    return torch.where(ob, 0.0, torch.sqrt(dist_sq))


def _box_blur_axis(x, rad: int, axis: int):
    """Mean over the window [i - rad, i + rad] with edge-replicated samples
    and a constant 1 / (2r + 1), as DoRectangularBlurAlongAxis
    (generic/tfluids.cc:642-668): the difference of a cumulative sum over
    the edge-padded axis, as the JAX package computes it."""
    n = x.shape[axis]
    idx = torch.arange(-rad, n + rad, device=x.device).clamp(0, n - 1)
    c = torch.cumsum(x.index_select(axis, idx), dim=axis)
    cpad = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
    return (cpad.narrow(axis, 2 * rad + 1, n) - cpad.narrow(axis, 0, n)) / \
        float(2 * rad + 1)


def rectangular_blur(src, blur_rad: int, is_3d: bool):
    """Separable box blur: z (3-D only), then y, then x."""
    out = src
    if is_3d:
        out = _box_blur_axis(out, blur_rad, src.ndim - 3)
    out = _box_blur_axis(out, blur_rad, src.ndim - 2)
    return _box_blur_axis(out, blur_rad, src.ndim - 1)


def border_loss_weights(flags, border_weight: float, border_width: int):
    """Inverse-distance ramp: weight in [1, border_weight], border_weight at
    cells adjacent to obstacles (fluid_criterion.lua:145-158)."""
    w = signed_distance_field(flags, border_width)
    w = w.clamp(1.0, float(border_width)) - 1.0            # [0, width-1]
    w = w * (-1.0 / (border_width - 1)) + 1.0              # [1, 0] adj->far
    return w * (border_weight - 1.0) + 1.0                 # [weight, 1]


def _wmse(a, b, w):
    if w is None:
        return torch.mean((a - b) ** 2)
    return torch.mean((w * a - w * b) ** 2)


def fluid_loss(mconf, p_pred, u_pred, p_target, u_target, flags,
               p_lambda: Optional[float] = None,
               u_lambda: Optional[float] = None,
               div_lambda: Optional[float] = None,
               weights=None):
    """Returns (total, {'p': ..., 'u': ..., 'div': ...}), 0-d tensors.

    Lambda overrides serve the long-term term's re-weighting
    (run_epoch.lua:273-298). `weights` can carry a precomputed border
    weight field (the flags do not change within a batch)."""
    p_lambda = mconf.loss_p_lambda if p_lambda is None else p_lambda
    u_lambda = mconf.loss_u_lambda if u_lambda is None else u_lambda
    div_lambda = mconf.loss_div_lambda if div_lambda is None else div_lambda

    w = weights
    if w is None and mconf.loss_func_border_weight != 1.0:
        w = border_loss_weights(flags, mconf.loss_func_border_weight,
                                mconf.loss_func_border_width)

    zero = torch.zeros((), device=u_pred.device)
    terms, total = {}, None
    for k, lam, pred, tgt in (("p", p_lambda, p_pred, p_target),
                              ("u", u_lambda, u_pred, u_target)):
        terms[k] = lam * _wmse(pred, tgt, w) if lam != 0.0 else zero
        if lam != 0.0:
            total = terms[k] if total is None else total + terms[k]
    div = velocity_divergence(u_pred, flags)
    terms["div"] = div_lambda * _wmse(div, torch.zeros_like(div), w)
    total = terms["div"] if total is None else total + terms["div"]
    return total, terms
