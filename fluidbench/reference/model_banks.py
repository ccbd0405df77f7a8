"""A configuration's banked ConvNet, in plain PyTorch.

The trunk of reference/model.py with model.lua's banks (model.lua:266-331,
as the port states them in models/fluidnet.py): at the split stage the
input goes to `banks_num` banks, each running the stages up to the join
with weights of its own ("stages/<i>/<bank>/conv/{w,b}"):

  - dilate: every bank takes the input as it is; bank b convolves at
    dilation 2^b (padding 2^b (k - 1) / 2, so each output cell keeps its
    place), except in a stage that upsamples (dilation 1 there);
  - mres: bank b takes the input average-pooled by 2, b times over (a
    pyramid, each level pooled from the one before).

Each bank's stage is the stage path's: the convolution, the bias, the
nonlinearity, the stage's pool (avg or max). At the join stage the
banks' outputs meet: for mres, bank b's is first repeated 2^b times
along each axis (nearest upsampling back to bank 0's size); then they
are concatenated along the channels in bank order (concat) or summed
(add), and the stages from the join on run once, as in model.py.

Precision as model.py's stage path: every convolution runs in float32
with TF32 off (the caller sets it) on operands rounded to the compute
type and its result rounded to it, the bias added in float32 after; the
nonlinearity, the pools, the pyramid and the join run in float32 on
what they get, unrounded (the next convolution rounds its operand, as
the program casts it there). `precision` names the type as model.py
does ("bf16", "fp8", "fp32").

Departures from model.lua, each as the port has them: batch norm and
the pressure skip are not built here (no configuration of the benchmark
asks for them; asking raises); weight sharing (banks_weight_share) is the
weights' matter, not the trunk's.
"""

import torch
import torch.nn.functional as F

from fluidbench.reference import model
from fluidbench.reference.grid import is_obstacle
from fluidbench.reference.physics import (set_wall_bcs, velocity_divergence,
                                          velocity_update)


def banks_at(mconf, i):
    """The number of banks stage i (0-based) runs in."""
    n = mconf.banks_num
    if n > 1 and mconf.banks_split_stage <= i + 1 < mconf.banks_join_stage:
        return n
    return 1


def dilation(mconf, layers, i, bank):
    """The dilation of bank `bank`'s convolution at stage i."""
    if mconf.banks_num > 1 and mconf.banks_type == "dilate" and \
            banks_at(mconf, i) > 1 and layers["usize"][i] == 1:
        return 2 ** bank
    return 1


def param_names(mconf, layers):
    """The weights' names in the port's order: stage by stage, bank by
    bank, w then b, then the head."""
    names = []
    for i in range(len(layers["osize"]) - 1):
        for ib in range(banks_at(mconf, i)):
            names += [f"stages/{i}/{ib}/conv/w", f"stages/{i}/{ib}/conv/b"]
    return names + ["final/conv/w", "final/conv/b"]


def param_shapes(mconf, layers, in_channels):
    """{name: shape} of the weights: conv3d (out * up^3, in, k, k, k); the
    join stage takes banks_num times the channels with concat."""
    shapes, c = {}, in_channels
    osize, ksize, usize = layers["osize"], layers["ksize"], layers["usize"]
    n = len(osize)
    for i in range(n):
        if mconf.banks_num > 1 and i + 1 == mconf.banks_join_stage and \
                mconf.banks_aggregate_method == "concat":
            c *= mconf.banks_num
        out = osize[i] * usize[i] ** 3
        k = ksize[i]
        for ib in range(banks_at(mconf, i) if i < n - 1 else 1):
            stem = f"stages/{i}/{ib}" if i < n - 1 else "final"
            shapes[f"{stem}/conv/w"] = (out, c, k, k, k)
            shapes[f"{stem}/conv/b"] = (out,)
        c = osize[i]
    return shapes


def _upsample(x, ratio):
    """Each spatial axis repeated `ratio` times (nearest upsampling)."""
    for ax in (2, 3, 4):
        x = x.repeat_interleave(ratio, dim=ax)
    return x


def _join(mconf, hs):
    if mconf.banks_type == "mres":
        hs = [h if ib == 0 else _upsample(h, 2 ** ib)
              for ib, h in enumerate(hs)]
    if mconf.banks_aggregate_method == "concat":
        return torch.cat(hs, dim=1)
    if mconf.banks_aggregate_method == "add":
        out = hs[0]
        for h in hs[1:]:
            out = out + h
        return out
    raise ValueError(mconf.banks_aggregate_method)


def _pool(x, size, kind):
    if kind == "avg":
        return F.avg_pool3d(x, size)
    if kind == "max":
        return F.max_pool3d(x, size)
    raise ValueError(kind)


def trunk(params, x, mconf, layers, precision):
    """The banked conv trunk on (b, c, z, y, x) float32; returns the
    pressure (b, 1, z, y, x) float32."""
    if getattr(mconf, "add_batch_norm", False) or \
            getattr(mconf, "add_pressure_skip", False):
        raise NotImplementedError("the reference builds neither batch norm "
                                  "nor the pressure skip")
    r = model.rounder(precision)
    act = {"relu": F.relu, "sigmoid": torch.sigmoid,
           "relu6": F.relu6}[mconf.nonlin_type]
    n = len(layers["osize"])
    hs = [x]
    for i in range(n):
        nb = banks_at(mconf, i) if i < n - 1 else 1
        if nb > 1 and len(hs) == 1:
            if mconf.banks_type == "mres":
                for _ in range(1, nb):
                    hs.append(F.avg_pool3d(hs[-1], 2))
            else:
                hs = hs * nb
        if nb == 1 and len(hs) > 1:
            hs = [_join(mconf, hs)]
        out_hs = []
        for ib, h in enumerate(hs):
            stem = f"stages/{i}/{ib}" if i < n - 1 else "final"
            w, b = params[f"{stem}/conv/w"], params[f"{stem}/conv/b"]
            d = dilation(mconf, layers, i, ib)
            pad = (layers["ksize"][i] - 1) // 2 * d
            out = r(F.conv3d(r(h), r(w), None, padding=pad, dilation=d))
            out = out + b.view(1, -1, 1, 1, 1)
            if layers["usize"][i] > 1:
                out = model._pixel_shuffle(out, layers["usize"][i])
            if i < n - 1:
                out = act(out)
                if layers["psize"][i] > 1:
                    out = _pool(out, layers["psize"][i], mconf.pool_type)
            out_hs.append(out)
        hs = out_hs
    (h,) = hs
    return h


def forward(params, mconf, layers, p_div, u_div, flags, precision,
            precomputed_div=None):
    """The projection net: (p, U) of (pDiv, UDiv, flags), model.py's
    forward around the banked trunk."""
    ic = mconf.input_channels
    if precomputed_div is None:
        u_div = set_wall_bcs(u_div, flags)
        div = velocity_divergence(u_div, flags) if ic["div"] else None
    else:
        div = precomputed_div if ic["div"] else None
    if mconf.normalize_input:
        s = model.input_scale(mconf, p_div, u_div, div)
        p_div = p_div / s
        u_div = u_div / s
        if div is not None:
            div = div / s
    chans = [c for c, on in ((p_div, ic["p_div"]), (u_div, ic["u_div"]),
                             (div, ic["div"])) if on]
    x = torch.cat(chans + [is_obstacle(flags).to(torch.float32)], dim=1)
    p = trunk(params, x, mconf, layers, precision)
    u = velocity_update(u_div, flags, p)
    if mconf.normalize_input:
        p = p * s
        u = u * s
    return p, set_wall_bcs(u, flags)
