"""Auxiliary differentiable modules (torch/lib/modules/ equivalents).

Port of fluidnet_tpu.models.modules: the reference's nn modules beyond the
default model graph (SURVEY.md §2.2 "Aux nn modules"), as pure functions
whose gradients come from autograd:

  central_divergence        spatial/volumetric_divergence.lua (non-MAC,
                            central differences, replicated edges)
  finite_elements           spatial/volumetric_finite_elements.lua
                            (central-difference dF/dx,dy[,dz])
  mse_si_loss               mse_si_criterion.lua (Eigen et al.
                            scale-invariant MSE)
  lerp_loss                 lerp_criterion.lua (blend of two criteria)
  residual_block            residual_layer.lua
  apply_scale               apply_scale.lua (per-sample scale/unscale)
  standard_deviation        standard_deviation.lua + variance.lua
                            (unbiased sample std over non-batch dims)
  upsample_nearest          volumetric_up_sampling_nearest.lua
  normalize_subtractive /   spatial_{subtractive,divisive}_
  normalize_divisive        normalization_batch.lua (mean/std window
                            normalization with a box kernel)
  select_fluid_input        select_fluid_input.lua
  inject_tensor             inject_tensor.lua
"""

import torch
import torch.nn.functional as F

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.ops.sdf import rectangular_blur


def _central_diff(a, axis):
    """Central difference with one-sided differences at the borders
    (spatial_finite_elements.lua): interior (a[i+1] - a[i-1]) / 2."""
    n = a.shape[axis]
    interior = (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2)) * 0.5
    first = a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)
    last = a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1)
    return torch.cat([first, interior, last], dim=axis)


def finite_elements(f, step_sizes=None):
    """Per-channel central-difference gradient. f: (b, c, z, y, x) (z == 1
    for 2-D). Returns (b, c*dims, z, y, x) with derivatives ordered
    (dx, dy[, dz]) per channel like the reference modules."""
    is_3d = f.shape[2] > 1
    steps = step_sizes or (1.0, 1.0, 1.0)
    outs = []
    for c in range(f.shape[1]):
        fc = f[:, c:c + 1]
        outs.append(_central_diff(fc, 4) / steps[0])
        outs.append(_central_diff(fc, 3) / steps[1])
        if is_3d:
            outs.append(_central_diff(fc, 2) / steps[2])
    return torch.cat(outs, dim=1)


def central_divergence(u, step_sizes=None):
    """Divergence of a cell-centered (NON-MAC) vector field via central
    differences (spatial/volumetric_divergence.lua). u: (b, 2|3, z, y, x);
    returns (b, 1, z, y, x)."""
    is_3d = u.shape[1] == 3
    steps = step_sizes or (1.0, 1.0, 1.0)
    div = _central_diff(u[:, 0:1], 4) / steps[0] + \
        _central_diff(u[:, 1:2], 3) / steps[1]
    if is_3d:
        div = div + _central_diff(u[:, 2:3], 2) / steps[2]
    return div


def mse_si_loss(pred, target, lam: float = 0.5):
    """Scale-invariant MSE (mse_si_criterion.lua, after Eigen et al. 2014):
    mean(d^2) - lam * mean(d)^2 with d = pred - target, per batch sample,
    averaged over the batch."""
    d = (pred - target).reshape(pred.shape[0], -1)
    return torch.mean(torch.mean(d * d, dim=1) -
                      lam * torch.mean(d, dim=1) ** 2)


def lerp_loss(loss_a, loss_b, t):
    """lerp_criterion.lua: (1 - t) * A + t * B."""
    return (1.0 - t) * loss_a + t * loss_b


def apply_scale(x, scale, invert: bool):
    """Per-sample broadcast scale (apply_scale.lua): x * scale or
    x / scale; scale (b,) or (b, 1)."""
    s = scale.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return x / s if invert else x * s


def standard_deviation(x):
    """Unbiased sample std over all non-batch dims (standard_deviation.lua
    + variance.lua:16-17). Returns (b,)."""
    flat = x.reshape(x.shape[0], -1)
    mean = torch.mean(flat, dim=1, keepdim=True)
    var = torch.sum((flat - mean) ** 2, dim=1) / (flat.shape[1] - 1)
    return torch.sqrt(var)


def upsample_nearest(x, ratio: int):
    """3-D (or 2-D with z == 1) nearest upsample of the spatial dims
    (volumetric_up_sampling_nearest.lua); x: (b, c, z, y, x)."""
    for ax in ((2, 3, 4) if x.shape[2] > 1 else (3, 4)):
        x = x.repeat_interleave(ratio, dim=ax)
    return x


def residual_block(params, x, apply_conv):
    """residual_layer.lua: y = x + conv2(relu(conv1(x))), with a projection
    shortcut when channel counts differ. `apply_conv(p, x)` is the conv
    primitive (a models.fluidnet._conv partial)."""
    h = apply_conv(params["conv2"], F.relu(apply_conv(params["conv1"], x)))
    if "proj" in params:
        x = apply_conv(params["proj"], x)
    return x + h


def normalize_subtractive(x, blur_rad: int):
    """Subtractive window normalization: x - boxblur(x)
    (spatial_subtractive_normalization_batch.lua with a flat kernel)."""
    return x - rectangular_blur(x, blur_rad, x.shape[2] > 1)


def normalize_divisive(x, blur_rad: int, eps: float = 1e-5):
    """Divisive window normalization: x / sqrt(boxblur(x^2) + eps)."""
    return x / torch.sqrt(rectangular_blur(x * x, blur_rad, x.shape[2] > 1)
                          + eps)


def select_fluid_input(x, flags):
    """select_fluid_input.lua: zero out non-fluid cells of x."""
    return torch.where(is_fluid(flags), x, torch.zeros_like(x))


def inject_tensor(x, injected, mask):
    """inject_tensor.lua: blend a fixed tensor where mask == 1."""
    return x * (1.0 - mask) + injected * mask
