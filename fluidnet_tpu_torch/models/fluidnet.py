"""The learned pressure-projection ConvNet.

Port of fluidnet_tpu.models.fluidnet: every model `ModelConfig` builds
(default, tog, yang; multi-resolution or dilation banks joined by concat
or add, with or without weight sharing; avg or max pooling; upsampling
convs; batch norm; the pressure skip), in 2-D and 3-D. Forward pass, like
the reference (model.lua:27-401):

  input {pDiv, UDiv, flags}
  -> setWallBcs(UDiv), div = velocityDivergence(UDiv)  (or the prologue's)
  -> per-sample std scale s of UDiv (or pDiv / div)
  -> concat([pDiv,] [UDiv,] [div,] occupancy(flags))
  -> conv trunk, 1-channel head (2-D: on the input squeezed to
     (b, c, y, x), p unsqueezed after)
  -> U = velocityUpdate(p, UDiv, flags); p, U *= s; setWallBcs(U)

Two trunks, as in JAX. The 3-D default/yang models (`_trunk_fast_ok`,
fluidnet.py:278-287) take the fast trunk: channels_last_3d convs that keep
the activations AND the bias add in bf16 between layers and upcast once
at the end (fluidnet.py:290-304, 236); the JAX z-fold (the same math in
another summation order) is not ported. Every other model takes the
generic stage path (fluidnet.py:561-620): each conv casts its input and
weights to the compute dtype, convolves to that dtype, upcasts to float32
and adds the bias in float32 (`_conv`, fluidnet.py:140-195); the
nonlinearity, pooling, pixel shuffle, upsampling and batch norm run in
float32. The convolutions are cuDNN's (the JAX package left them to XLA
too); the physics around them stays float32.

Each trunk forward counts in utils/profiler.trunk_forwards by its path
(`FluidNet.path`); a banked stage path marks each bank's stages and the
join with spans (model.bank<i>, model.join), which cut a rollout's CUDA
graph chain there as the step's own spans do (sim/chain.py).

Two quirks of the reference are kept (ROADMAP, faults F11 and F12): batch
norm always runs its eval-mode formula, and its running mean and
variance are trainable parameters like its scale and bias (no JAX caller
passes training=True); weight-shared banks start from equal weights but
are separate parameters, each with its own gradient.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import flags_to_occupancy, resolve_device
from fluidnet_tpu_torch.ops.boundary import set_wall_bcs
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.velocity_update import velocity_update
from fluidnet_tpu_torch.utils import profiler

BN_KEYS = ("scale", "bias", "mean", "var")
_NO_SPAN = contextlib.nullcontext()


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


def _check_banks(mconf, n_stage):
    """init_model's bank preconditions (fluidnet.py:447-451)."""
    if mconf.banks_num < 1:
        raise ValueError(f"banks_num {mconf.banks_num} < 1")
    if mconf.banks_num > 1 and not (
            1 <= mconf.banks_split_stage < mconf.banks_join_stage < n_stage):
        raise ValueError(f"banks split stage {mconf.banks_split_stage} and "
                         f"join stage {mconf.banks_join_stage} must satisfy "
                         f"1 <= split < join < {n_stage}")


def _trunk_fast_ok(mconf, psize, usize):
    """The fast trunk's preconditions (fluidnet.py:278-287): the 3-D
    default/yang conv stacks."""
    return (mconf.is_3d and mconf.banks_num == 1
            and not mconf.add_batch_norm and not mconf.add_pressure_skip
            and all(p == 1 for p in psize) and all(u == 1 for u in usize))


def _nonlin(x, kind):
    if kind == "relu":
        return F.relu(x)
    if kind == "relu6":
        return F.relu6(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(kind)


def _conv(x, w, b, nd, dilation=1, compute_dtype=torch.bfloat16):
    """SAME-padded stride-1 conv of the stage path (fluidnet.py:140-195):
    operands in the compute dtype, the result in the compute dtype, then
    float32 and the float32 bias."""
    pad = [(k - 1) // 2 * dilation for k in w.shape[2:]]
    conv = F.conv3d if nd == 3 else F.conv2d
    out = conv(x.to(compute_dtype), w.to(compute_dtype), None, padding=pad,
               dilation=dilation)
    return out.to(torch.float32) + b.view((1, -1) + (1,) * nd)


def _pixel_shuffle(x, up, nd):
    """(out * up^nd) channels interleaved into space, channel
    c = oc * up^nd + (sub-position in C order) (fluidnet.py:307-321)."""
    b, c = x.shape[:2]
    sp = x.shape[2:]
    x = x.reshape((b, c // up ** nd) + (up,) * nd + tuple(sp))
    perm = [0, 1] + [a for i in range(nd) for a in (2 + nd + i, 2 + i)]
    return x.permute(perm).reshape((b, c // up ** nd) +
                                   tuple(s * up for s in sp))


def _pool(x, size, nd, kind):
    """VALID windows of size = stride (fluidnet.py:324-332)."""
    if kind == "avg":
        return (F.avg_pool3d if nd == 3 else F.avg_pool2d)(x, size)
    if kind == "max":
        return (F.max_pool3d if nd == 3 else F.max_pool2d)(x, size)
    raise ValueError(kind)


def _nearest_upsample(x, ratio, nd):
    """Each of the nd spatial axes repeated `ratio` times
    (fluidnet.py:335-340)."""
    for ax in range(x.ndim - nd, x.ndim):
        x = x.repeat_interleave(ratio, dim=ax)
    return x


def _apply_stage(conv, x, nd, up, compute_dtype):
    """One stage's conv (fluidnet.py:397-412); with up > 1 a conv to
    out * up^nd channels, then the pixel shuffle."""
    out = _conv(x, conv.weight, conv.bias, nd, conv.dilation[0],
                compute_dtype)
    return _pixel_shuffle(out, up, nd) if up > 1 else out


class BatchNorm(nn.Module):
    """Batch norm as the JAX package applies it (fluidnet.py:420-435,
    training=False): (x - mean) * rsqrt(var + eps), then * scale + bias
    when affine. All four are parameters that train (fault F11)."""

    def __init__(self, c, device):
        super().__init__()
        for name, fill in zip(BN_KEYS, (1.0, 0.0, 0.0, 1.0)):
            setattr(self, name, nn.Parameter(
                torch.full((c,), fill, device=device)))

    def forward(self, x, nd, eps, affine):
        shape = (1, -1) + (1,) * nd
        out = (x - self.mean.view(shape)) * torch.rsqrt(
            self.var.view(shape) + eps)
        if affine:
            out = out * self.scale.view(shape) + self.bias.view(shape)
        return out


def input_chan(mconf, p_div, u_div, div):
    """The channel the input scale is taken of (normalize_input_chan)."""
    return {"UDiv": u_div, "pDiv": p_div, "div": div}[
        mconf.normalize_input_chan]


def scale_of(mconf, sq):
    """The input scale from the per-sample (b,) variance or squared norm:
    its root, clamped below at the threshold. Returns (b, 1, 1, 1, 1)."""
    thr = mconf.normalize_input_threshold
    ok = sq > thr * thr
    s = torch.where(ok, torch.sqrt(torch.where(ok, sq, 1.0)), thr)
    return s.clamp_min(thr).reshape(-1, 1, 1, 1, 1)


def _input_scale(mconf, p_div, u_div, div):
    """Per-sample normalization scale (model.lua:92-131): std (unbiased)
    or l2 norm of the chosen channel, clamped below at the threshold.
    Returns (b, 1, 1, 1, 1)."""
    chan = input_chan(mconf, p_div, u_div, div)
    flat = chan.reshape(chan.shape[0], -1)
    if mconf.normalize_input_func == "std":
        mean = flat.mean(dim=1, keepdim=True)
        sq = ((flat - mean) ** 2).sum(dim=1) / (flat.shape[1] - 1)
    elif mconf.normalize_input_func == "norm":
        sq = (flat * flat).sum(dim=1)
    else:
        raise ValueError(mconf.normalize_input_func)
    return scale_of(mconf, sq)


def _flatten(tree, prefix=""):
    """{JAX tree path: leaf} of a params pytree (dicts and lists; None
    entries hold no leaf)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


class FluidNet(nn.Module):
    """The projection net: forward(p_div, u_div, flags, precomputed_div)
    -> (p, U), all (b, c, z, y, x).

    The layout is the JAX params tree's (init_model, fluidnet.py:439-478):
    `stages[i][ib]` the conv of stage i's bank ib, `bn[i]` stage i's batch
    norm (`bn` None when off) and `final` the head.

    `precomputed_div`: the projection prologue (ops.prologue) already
    applied setWallBcs to u_div and computed its divergence; passing it
    skips both input ops. Passing it is the explicit capability signal
    the JAX package probed with try/except (fault F2).

    `input_scale`: with normalize_input, the function (mconf, p_div, u_div,
    div) -> (b, 1, 1, 1, 1) scale that replaces `_input_scale` (a slab of
    a z-sharded grid takes the scale of the whole grid:
    parallel/simulate_sharded.py).

    The weights are built on `device`, the CUDA device by default
    (core.grids.resolve_device: no silent fall back to the CPU)."""

    def __init__(self, mconf: ModelConfig, device=None):
        super().__init__()
        osize, ksize, psize, usize = layer_spec(mconf)
        n_stage = len(osize)
        _check_banks(mconf, n_stage)
        if mconf.conv_compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(mconf.conv_compute_dtype)
        device = resolve_device(device)
        self.mconf = mconf
        self.nd = nd = 3 if mconf.is_3d else 2
        self.psize, self.usize = psize, usize
        self.fast = _trunk_fast_ok(mconf, psize, usize)
        conv = nn.Conv3d if mconf.is_3d else nn.Conv2d

        def make(in_c, out_c, k, up, dilation=1):
            return conv(in_c, out_c * up ** nd, k, dilation=dilation,
                        padding=(k - 1) // 2 * dilation, device=device)

        in_c = num_input_channels(mconf)
        banks = mconf.banks_num
        n_banks = 1
        self.stages = nn.ModuleList()
        for lid in range(n_stage - 1):
            if banks > 1 and lid + 1 == mconf.banks_split_stage:
                n_banks = banks
            if banks > 1 and lid + 1 == mconf.banks_join_stage:
                if mconf.banks_aggregate_method == "concat":
                    in_c *= banks
                n_banks = 1
            self.stages.append(nn.ModuleList(
                make(in_c, osize[lid], ksize[lid], usize[lid],
                     2 ** ib if mconf.banks_type == "dilate" and
                     usize[lid] == 1 else 1)
                for ib in range(n_banks)))
            in_c = osize[lid]
        self.bn = nn.ModuleList(
            BatchNorm(o, device) for o in osize[:-1]) \
            if mconf.add_batch_norm else None
        if mconf.add_pressure_skip:
            in_c += 1
        self.final = make(in_c, osize[-1], ksize[-1], usize[-1])

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.mconf.conv_compute_dtype == \
            "bfloat16" else torch.float32

    def load_jax_params(self, params):
        """Loads the JAX params pytree (numpy leaves): {"stages":
        [[{"conv": {"w", "b"}}, ...], ...], "bn": [None | {"scale", "bias",
        "mean", "var"}, ...], "final": {"conv": ...}} ("bn" may be left
        out when batch norm is off). `w` is (O, I, kz, ky, kx) or in 2-D
        (O, I, ky, kx), already Conv3d's / Conv2d's layout."""
        flat = _flatten(params)
        named = dict(self.jax_named_parameters())
        if set(flat) != set(named):
            raise ValueError(
                f"params do not match the layout of model "
                f"{self.mconf.model_type!r}: missing "
                f"{sorted(set(named) - set(flat))}, unexpected "
                f"{sorted(set(flat) - set(named))}")
        with torch.no_grad():
            for k, t in named.items():
                v = torch.tensor(np.asarray(flat[k]), dtype=torch.float32)
                if v.shape != t.shape:
                    raise ValueError(f"{k}: shape {tuple(v.shape)} does not "
                                     f"match {tuple(t.shape)}")
                t.copy_(v)
        return self

    def jax_named_parameters(self):
        """[(JAX tree path, parameter)]: "stages/i/ib/conv/w" and ".../b"
        for each stage and bank, "bn/i/{scale,bias,mean,var}" with batch
        norm, then "final/conv/w" and "final/conv/b". The optimizer state
        follows this order."""
        out = []
        for i, convs in enumerate(self.stages):
            for ib, m in enumerate(convs):
                out += [(f"stages/{i}/{ib}/conv/w", m.weight),
                        (f"stages/{i}/{ib}/conv/b", m.bias)]
        for i, bn in enumerate(self.bn or ()):
            out += [(f"bn/{i}/{k}", getattr(bn, k)) for k in BN_KEYS]
        return out + [("final/conv/w", self.final.weight),
                      ("final/conv/b", self.final.bias)]

    @property
    def path(self):
        """The trunk's path as utils/profiler.trunk_forwards counts it:
        "fast", "stages" or "banked" (the stage path with banks)."""
        if self.fast:
            return "fast"
        return "banked" if self.mconf.banks_num > 1 else "stages"

    def trunk(self, x, skip=None):
        """The conv trunk on the (b, c, z, y, x) input: the fast trunk,
        or the generic stage path; `skip` is the normalized pDiv the
        pressure skip concatenates before the head."""
        profiler.trunk_forwards[self.path] += 1
        if self.fast:
            return self._trunk_fast(x)
        if self.nd == 3:
            return self._stages_path(x, skip)
        skip = None if skip is None else skip[:, :, 0]
        return self._stages_path(x[:, :, 0], skip)[:, :, None]

    def _trunk_fast(self, x):
        cdt = self.compute_dtype
        h = x.to(cdt).contiguous(memory_format=torch.channels_last_3d)
        mods = [convs[0] for convs in self.stages] + [self.final]
        for li, mod in enumerate(mods):
            h = F.conv3d(h, mod.weight.to(cdt), None, padding=mod.padding)
            h = h + mod.bias.to(cdt).view(1, -1, 1, 1, 1)
            if li < len(mods) - 1:
                h = _nonlin(h, self.mconf.nonlin_type)
        return h.to(torch.float32).contiguous()

    def _stages_path(self, x, skip):
        """The generic stage path (fluidnet.py:561-600) on (b, c, *sp):
        the banks split into an avg-pool pyramid (mres) or copies
        (dilate, dilation 2^ib) and join by nearest upsampling (mres) then
        concat or add; each bank's conv, nonlinearity, pool, batch norm.
        With banks, each bank's stage between the split and the join runs
        in the span model.bank<ib> (for mres with the pyramid's pool that
        makes the bank's input), and the join in model.join."""
        m, nd, cdt = self.mconf, self.nd, self.compute_dtype
        banked = m.banks_num > 1
        hl = [x]
        for lid, convs in enumerate(self.stages):
            pyramid = False
            if banked and lid + 1 == m.banks_split_stage:
                # mres: each bank's input is the bank before's, pooled.
                pyramid = m.banks_type == "mres"
                hl = [hl[0]] * m.banks_num
            if banked and lid + 1 == m.banks_join_stage:
                with profiler.span("model.join"):
                    if m.banks_type == "mres":
                        hl = [hl[0]] + [_nearest_upsample(h, 2 ** ib, nd)
                                        for ib, h in enumerate(hl)
                                        if ib > 0]
                    if m.banks_aggregate_method == "concat":
                        hl = [torch.cat(hl, dim=1)]
                    elif m.banks_aggregate_method == "add":
                        hl = [sum(hl)]
                    else:
                        raise ValueError(m.banks_aggregate_method)
            inside = banked and \
                m.banks_split_stage <= lid + 1 < m.banks_join_stage
            new_hl = []
            prev = hl[0]
            for ib, (conv, h) in enumerate(zip(convs, hl, strict=True)):
                with profiler.span(f"model.bank{ib}") if inside \
                        else _NO_SPAN:
                    if pyramid and ib > 0:
                        h = prev = _pool(prev, 2, nd, "avg")
                    out = _nonlin(_apply_stage(conv, h, nd, self.usize[lid],
                                               cdt), m.nonlin_type)
                    if self.psize[lid] > 1:
                        out = _pool(out, self.psize[lid], nd, m.pool_type)
                    if self.bn is not None:
                        out = self.bn[lid](out, nd, m.batch_norm_eps,
                                           m.batch_norm_affine)
                new_hl.append(out)
            hl = new_hl
        (h,) = hl
        if skip is not None:
            h = torch.cat([h, skip], dim=1)
        return _apply_stage(self.final, h, nd, self.usize[-1], cdt)

    def forward(self, p_div, u_div, flags, precomputed_div=None,
                input_scale=None):
        mconf = self.mconf
        ic = mconf.input_channels
        if precomputed_div is None:
            u_div = set_wall_bcs(u_div, flags)
            div = velocity_divergence(u_div, flags) if ic.div else None
        else:
            div = precomputed_div if ic.div else None

        if mconf.normalize_input:
            s = (input_scale or _input_scale)(mconf, p_div, u_div, div)
            p_div = p_div / s
            u_div = u_div / s
            if div is not None:
                div = div / s

        chans = [c for c, on in ((p_div, ic.p_div), (u_div, ic.u_div),
                                 (div, ic.div)) if on]
        x = torch.cat(chans + [flags_to_occupancy(flags)], dim=1)
        p = self.trunk(x, p_div if mconf.add_pressure_skip else None)
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
    uses (init_model's `_init_conv`: weights and biases U(-s, s),
    s = 1 / sqrt(fan_in)), drawn stage by stage and bank by bank from an
    explicit CPU torch.Generator seeded `seed`, so the draw does not
    depend on the device or the global RNG. (JAX's PRNG gives other
    numbers from the same seed.) Weight-shared banks copy bank 0's draw;
    batch norm starts at scale 1, bias 0, mean 0, var 1. Its parameters
    train: train.train.init_train_state starts from it."""
    net = FluidNet(mconf, device=device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for convs in list(net.stages) + [[net.final]]:
            for ib, mod in enumerate(convs):
                if ib > 0 and mconf.banks_weight_share:
                    mod.weight.copy_(convs[0].weight)
                    mod.bias.copy_(convs[0].bias)
                    continue
                s = 1.0 / float(np.sqrt(mod.weight[0].numel()))
                for t in (mod.weight, mod.bias):
                    draw = torch.rand(t.shape, generator=gen) * (2 * s) - s
                    t.copy_(draw)
    return net
