"""The learned pressure-projection ConvNet.

Port of fluidnet_tpu.models.fluidnet for the default and yang models (no
banks, pooling, batch norm, upsampling, gates, low rank or pressure skip),
in 3-D along the fast trunk (`_trunk_fast_ok`, fluidnet.py:278-304) and in
2-D along the generic stage path (fluidnet.py:561-613). Forward pass, like
the reference (model.lua:27-401):

  input {pDiv, UDiv, flags}
  -> setWallBcs(UDiv), div = velocityDivergence(UDiv)  (or the prologue's)
  -> per-sample std scale s of UDiv (or pDiv / div)
  -> concat([pDiv,] [UDiv,] [div,] occupancy(flags))
  -> conv trunk (stride 1, same padding) + nonlinearity, 1-channel head
     (2-D: on the input squeezed to (b, c, y, x), p unsqueezed after)
  -> U = velocityUpdate(p, UDiv, flags); p, U *= s; setWallBcs(U)

The trunk runs in mconf.conv_compute_dtype and rounds where JAX rounds. The
3-D fast trunk keeps the activations AND the bias add in bf16 between
layers and upcasts once at the end (fluidnet.py:290-304, 236); its convs
run channels_last_3d, and the JAX z-fold (the same math in another
summation order) is not ported. The 2-D stage path casts each layer's
input and weights to the compute dtype, convolves to that dtype, upcasts
to float32 and adds the bias in float32, with the nonlinearity in float32
between layers (`_conv`, fluidnet.py:190-195). The convolutions are
cuDNN's (the JAX package left them to XLA too); the physics around them
stays float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import flags_to_occupancy, resolve_device
from fluidnet_tpu_torch.ops.boundary import set_wall_bcs
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.velocity_update import velocity_update


def layer_spec(mconf: ModelConfig):
    """Per-stage (osize, ksize, psize, usize) tables (model.lua:160-239)."""
    t = mconf.model_type
    if not mconf.is_3d:
        if t == "tog":
            return ((16, 32, 32, 64, 64, 32, 1), (5, 5, 5, 5, 1, 1, 3),
                    (2, 1, 1, 1, 1, 1, 1), (1, 1, 1, 1, 1, 1, 2))
        if t == "default":
            return ((16, 16, 16, 16, 1), (3, 3, 3, 3, 1), (1,) * 5, (1,) * 5)
        if t == "yang":
            _check_yang(mconf)
            return ((6, 6, 6, 1), (3, 1, 1, 1), (1,) * 4, (1,) * 4)
        raise ValueError(f"bad 2-D modelType {t}")
    if t == "tog":
        return ((16, 16, 16, 16, 32, 32, 1), (3, 3, 3, 3, 1, 1, 3),
                (2, 2, 1, 1, 1, 1, 1), (1, 1, 1, 1, 1, 2, 2))
    if t == "default":
        return ((8, 8, 8, 8, 1), (3, 3, 3, 1, 1), (1,) * 5, (1,) * 5)
    if t == "yang":
        _check_yang(mconf)
        return ((6, 6, 6, 1), (3, 1, 1, 1), (1,) * 4, (1,) * 4)
    raise ValueError(f"bad 3-D modelType {t}")


def _check_yang(mconf):
    """torch.checkYangSettings (model_utils.lua:211-227)."""
    ic = mconf.input_channels
    if mconf.nonlin_type != "sigmoid" or not ic.p_div or not ic.div or \
            ic.u_div or not ic.flags:
        raise ValueError("yang model needs sigmoid nonlinearity and "
                         "pDiv+div+flags (no UDiv) inputs")


def num_input_channels(mconf: ModelConfig) -> int:
    ic = mconf.input_channels
    if not ic.flags:
        raise ValueError("flags input is required (model.lua:39-42)")
    return (int(ic.p_div) + (3 if mconf.is_3d else 2) * int(ic.u_div) +
            1 + int(ic.div))


def _check_ported(mconf, psize, usize):
    """The ported trunks: the JAX `_trunk_fast_ok` preconditions in 3-D,
    and the same plain conv stack on the generic stage path in 2-D."""
    if not (mconf.banks_num == 1
            and not mconf.add_batch_norm and not mconf.add_pressure_skip
            and all(p == 1 for p in psize) and all(u == 1 for u in usize)):
        raise NotImplementedError(
            f"model {mconf.model_type!r} (is_3d={mconf.is_3d}, banks, batch "
            f"norm, pressure skip, pooling or upsampling) is not ported yet: "
            f"only the default/yang conv stacks are (ROADMAP queue 1, rest "
            f"of models/fluidnet.py)")


def _nonlin(x, kind):
    if kind == "relu":
        return F.relu(x)
    if kind == "relu6":
        return F.relu6(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(kind)


def _input_scale(mconf, p_div, u_div, div):
    """Per-sample normalization scale (model.lua:92-131): std (unbiased)
    or l2 norm of the chosen channel, clamped below at the threshold.
    Returns (b, 1, 1, 1, 1)."""
    chan = {"UDiv": u_div, "pDiv": p_div, "div": div}[
        mconf.normalize_input_chan]
    b = chan.shape[0]
    flat = chan.reshape(b, -1)
    thr = mconf.normalize_input_threshold
    if mconf.normalize_input_func == "std":
        mean = flat.mean(dim=1, keepdim=True)
        sq = ((flat - mean) ** 2).sum(dim=1) / (flat.shape[1] - 1)
    elif mconf.normalize_input_func == "norm":
        sq = (flat * flat).sum(dim=1)
    else:
        raise ValueError(mconf.normalize_input_func)
    ok = sq > thr * thr
    s = torch.where(ok, torch.sqrt(torch.where(ok, sq, 1.0)), thr)
    return s.clamp_min(thr).reshape(b, 1, 1, 1, 1)


class FluidNet(nn.Module):
    """The projection net: forward(p_div, u_div, flags, precomputed_div)
    -> (p, U), all (b, c, z, y, x).

    `precomputed_div`: the projection prologue (ops.prologue) already
    applied setWallBcs to u_div and computed its divergence; passing it
    skips both input ops. Passing it is the explicit capability signal
    the JAX package probed with try/except (fault F2).

    The weights are built on `device`, the CUDA device by default
    (core.grids.resolve_device: no silent fall back to the CPU)."""

    def __init__(self, mconf: ModelConfig, device=None):
        super().__init__()
        osize, ksize, psize, usize = layer_spec(mconf)
        _check_ported(mconf, psize, usize)
        if mconf.conv_compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(mconf.conv_compute_dtype)
        device = resolve_device(device)
        self.mconf = mconf
        in_c = num_input_channels(mconf)
        conv = nn.Conv3d if mconf.is_3d else nn.Conv2d
        self.stages = nn.ModuleList()
        for o, k in zip(osize[:-1], ksize[:-1]):
            self.stages.append(conv(in_c, o, k, padding=k // 2,
                                    device=device))
            in_c = o
        self.final = conv(in_c, osize[-1], ksize[-1], padding=ksize[-1] // 2,
                          device=device)

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.mconf.conv_compute_dtype == \
            "bfloat16" else torch.float32

    def load_jax_params(self, params):
        """Loads the JAX params pytree (numpy leaves):
        {"stages": [[{"conv": {"w", "b"}}], ...], "final": {"conv": ...}}.
        `w` is (O, I, kz, ky, kx) or in 2-D (O, I, ky, kx), already
        Conv3d's / Conv2d's layout."""
        convs = [st[0]["conv"] for st in params["stages"]] + \
            [params["final"]["conv"]]
        mods = list(self.stages) + [self.final]
        if len(convs) != len(mods) or any(len(st) != 1 or set(st[0]) !=
                                          {"conv"}
                                          for st in params["stages"]):
            raise ValueError("params do not match the conv-stack layout "
                             f"of model {self.mconf.model_type!r}")
        with torch.no_grad():
            for mod, conv in zip(mods, convs):
                w = torch.tensor(np.asarray(conv["w"]), dtype=torch.float32)
                b = torch.tensor(np.asarray(conv["b"]), dtype=torch.float32)
                if w.shape != mod.weight.shape or b.shape != mod.bias.shape:
                    raise ValueError(f"conv shape {tuple(w.shape)} does not "
                                     f"match {tuple(mod.weight.shape)}")
                mod.weight.copy_(w)
                mod.bias.copy_(b)
        return self

    def trunk(self, x):
        """The conv trunk: the 3-D fast trunk, or in 2-D the stage path."""
        if not self.mconf.is_3d:
            return self._stages_2d(x[:, :, 0])[:, :, None]
        cdt = self.compute_dtype
        h = x.to(cdt).contiguous(memory_format=torch.channels_last_3d)
        mods = list(self.stages) + [self.final]
        for li, mod in enumerate(mods):
            h = F.conv3d(h, mod.weight.to(cdt), None, padding=mod.padding)
            h = h + mod.bias.to(cdt).view(1, -1, 1, 1, 1)
            if li < len(mods) - 1:
                h = _nonlin(h, self.mconf.nonlin_type)
        return h.to(torch.float32).contiguous()

    def _stages_2d(self, h):
        """The generic stage path on (b, c, y, x): each conv from
        compute-dtype operands to a compute-dtype result, then float32 and
        the float32 bias; the nonlinearity in float32."""
        cdt = self.compute_dtype
        mods = list(self.stages) + [self.final]
        for li, mod in enumerate(mods):
            h = F.conv2d(h.to(cdt), mod.weight.to(cdt), None,
                         padding=mod.padding)
            h = h.to(torch.float32) + mod.bias.view(1, -1, 1, 1)
            if li < len(mods) - 1:
                h = _nonlin(h, self.mconf.nonlin_type)
        return h

    def forward(self, p_div, u_div, flags, precomputed_div=None):
        mconf = self.mconf
        ic = mconf.input_channels
        if precomputed_div is None:
            u_div = set_wall_bcs(u_div, flags)
            div = velocity_divergence(u_div, flags) if ic.div else None
        else:
            div = precomputed_div if ic.div else None

        if mconf.normalize_input:
            s = _input_scale(mconf, p_div, u_div, div)
            p_div = p_div / s
            u_div = u_div / s
            if div is not None:
                div = div / s

        chans = [c for c, on in ((p_div, ic.p_div), (u_div, ic.u_div),
                                 (div, ic.div)) if on]
        x = torch.cat(chans + [flags_to_occupancy(flags)], dim=1)
        p = self.trunk(x)
        u = velocity_update(u_div, flags, p)
        if mconf.normalize_input:
            p = p * s
            u = u * s
        return p, set_wall_bcs(u, flags)


def from_jax_params(params, mconf: ModelConfig, device=None) -> FluidNet:
    """A FluidNet holding the JAX params pytree (numpy leaves), on
    `device` (the CUDA device by default)."""
    return FluidNet(mconf, device=device).load_jax_params(params)


def random_model(mconf: ModelConfig, seed: int = 0,
                 device=None) -> FluidNet:
    """A FluidNet with the torch default conv init the JAX package also
    uses (`_init_conv`: weights and biases U(-s, s), s = 1 / sqrt(fan_in)),
    drawn from an explicit CPU torch.Generator seeded `seed`, so the draw
    does not depend on the device or the global RNG. (JAX's PRNG gives
    other numbers from the same seed.)"""
    net = FluidNet(mconf, device=device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in list(net.stages) + [net.final]:
            s = 1.0 / float(np.sqrt(mod.weight[0].numel()))
            for t in (mod.weight, mod.bias):
                draw = torch.rand(t.shape, generator=gen) * (2 * s) - s
                t.copy_(draw)
    return net
