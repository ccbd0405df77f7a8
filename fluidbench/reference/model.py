"""A configuration's ConvNet, in plain PyTorch.

The layer table comes from the configuration's file (`layers`: each
stage's output channels, kernel size, pool and upsampling factor), the
weights as a dict of tensors under the JAX tree's names
("stages/<i>/0/conv/w", ..., "final/conv/b"). The forward pass follows
Tompson et al.'s model (model.lua:27-401) as the port states it:

  setWallBcs(UDiv) and its divergence (or the prologue's), the input
  scale (the unbiased std of UDiv, clamped below), the inputs divided by
  it, concat([pDiv], [UDiv], [div], occupancy), the trunk, the velocity
  update with the trunk's pressure, both scaled back, setWallBcs.

Every convolution runs in float32 with TF32 off (the caller sets it) on
operands rounded to the configuration's compute type, and its result is
rounded to that type too, which is what a convolution in that type
computes up to the order of its sums. A trunk without pools or
upsampling keeps its activations and the bias add in that type between
layers (the fast trunk); any other keeps them in float32 and adds the
bias in float32 (the stage path). `precision` names the type: "bf16",
what the configurations state, or "fp8" (float8 e4m3, saturated at its
largest value), the lower precision that the control runs.
"""

import torch
import torch.nn.functional as F

from fluidbench.reference.grid import is_obstacle
from fluidbench.reference.physics import (set_wall_bcs, velocity_divergence,
                                          velocity_update)

FP8_MAX = 448.0


def rounder(precision):
    """x -> x rounded to the compute type of `precision`, as float32. In
    bf16 the gradient is rounded at the same point, as autograd rounds
    the gradient of a bf16 tensor (the program's convolutions run their
    backward in bf16 too); fp8 lowers the forward operands only and keeps
    the bf16 gradient, as fp8 training keeps a wider type for gradients."""
    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp32":
        return lambda x: x
    if precision == "bf16":
        return bf16
    if precision == "fp8":
        def fp8(x):
            d = x.detach()
            q = d.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
            return bf16(x + (q.to(torch.float32) - d))
        return fp8
    raise ValueError(f"unknown precision {precision!r}")


def fast_trunk(layers):
    """Whether the trunk keeps its activations in the compute type: no
    pool and no upsampling in any stage."""
    return all(p == 1 for p in layers["psize"]) and \
        all(u == 1 for u in layers["usize"])


def param_names(layers):
    """The weights' names in the port's order: stage by stage, w then b,
    then the head."""
    n = len(layers["osize"])
    names = []
    for i in range(n - 1):
        names += [f"stages/{i}/0/conv/w", f"stages/{i}/0/conv/b"]
    return names + ["final/conv/w", "final/conv/b"]


def param_shapes(layers, in_channels):
    """{name: shape} of the weights: conv3d (out * up^3, in, k, k, k)."""
    shapes, c = {}, in_channels
    osize, ksize, usize = layers["osize"], layers["ksize"], layers["usize"]
    for i, name in enumerate(param_names(layers)[::2]):
        out = osize[i] * usize[i] ** 3
        k = ksize[i]
        shapes[name] = (out, c, k, k, k)
        shapes[name[:-1] + "b"] = (out,)
        c = osize[i]
    return shapes


def _pixel_shuffle(x, up):
    """(c * up^3) channels interleaved into space, channel
    c' = oc * up^3 + (sub-position in C order)."""
    b, c = x.shape[:2]
    sp = x.shape[2:]
    x = x.reshape((b, c // up ** 3) + (up,) * 3 + tuple(sp))
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape((b, c // up ** 3) + tuple(s * up for s in sp))


def trunk(params, x, layers, nonlin, precision):
    """The conv trunk on (b, c, z, y, x) float32; returns the pressure
    (b, 1, z, y, x) float32."""
    r = rounder(precision)
    act = {"relu": F.relu, "sigmoid": torch.sigmoid,
           "relu6": F.relu6}[nonlin]
    names = param_names(layers)
    n = len(layers["osize"])
    fast = fast_trunk(layers)
    h = r(x)
    for i in range(n):
        w, b = params[names[2 * i]], params[names[2 * i + 1]]
        pad = (layers["ksize"][i] - 1) // 2
        out = r(F.conv3d(h, r(w), None, padding=pad))
        if fast:
            out = r(out + r(b).view(1, -1, 1, 1, 1))
        else:
            out = out + b.view(1, -1, 1, 1, 1)
            if layers["usize"][i] > 1:
                out = _pixel_shuffle(out, layers["usize"][i])
        if i < n - 1:
            out = act(out)
            if layers["psize"][i] > 1:
                out = F.avg_pool3d(out, layers["psize"][i])
            if not fast:
                out = r(out)
        h = out
    return h


def scale_of(sq, thr):
    """The input scale from the per-sample (b,) variance: its root,
    clamped below at the threshold; (b, 1, 1, 1, 1)."""
    ok = sq > thr * thr
    s = torch.where(ok, torch.sqrt(torch.where(ok, sq, 1.0)), thr)
    return s.clamp_min(thr).reshape(-1, 1, 1, 1, 1)


def input_scale(mconf, p_div, u_div, div):
    """The per-sample scale (model.lua:92-131): the unbiased std (or the
    l2 norm) of the chosen channel."""
    chan = {"UDiv": u_div, "pDiv": p_div, "div": div}[
        mconf.normalize_input_chan]
    flat = chan.reshape(chan.shape[0], -1)
    if mconf.normalize_input_func == "std":
        mean = flat.mean(dim=1, keepdim=True)
        sq = ((flat - mean) ** 2).sum(dim=1) / (flat.shape[1] - 1)
    else:
        sq = (flat * flat).sum(dim=1)
    return scale_of(sq, mconf.normalize_input_threshold)


def forward(params, mconf, layers, p_div, u_div, flags, precision,
            precomputed_div=None):
    """The projection net: (p, U) of (pDiv, UDiv, flags)."""
    ic = mconf.input_channels
    if precomputed_div is None:
        u_div = set_wall_bcs(u_div, flags)
        div = velocity_divergence(u_div, flags) if ic["div"] else None
    else:
        div = precomputed_div if ic["div"] else None
    if mconf.normalize_input:
        s = input_scale(mconf, p_div, u_div, div)
        p_div = p_div / s
        u_div = u_div / s
        if div is not None:
            div = div / s
    chans = [c for c, on in ((p_div, ic["p_div"]), (u_div, ic["u_div"]),
                             (div, ic["div"])) if on]
    x = torch.cat(chans + [is_obstacle(flags).to(torch.float32)], dim=1)
    p = trunk(params, x, layers, mconf.nonlin_type, precision)
    u = velocity_update(u_div, flags, p)
    if mconf.normalize_input:
        p = p * s
        u = u * s
    return p, set_wall_bcs(u, flags)
