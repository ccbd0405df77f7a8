"""FluidNet training loss.

Port of fluidnet_tpu.train.loss (nn.FluidCriterion,
torch/lib/modules/fluid_criterion.lua:29-258):

  L = pLambda * wMSE(p, pTarget) + uLambda * wMSE(U, UTarget)
    + divLambda * wMSE(div(U, flags), 0)

with optional border weighting: the weight ramps from borderWeight next to
obstacles down to 1 at distance borderWidth (via the signed distance field,
fluid_criterion.lua:145-159). wMSE is mean((w*a - w*b)^2): the weight is
applied to input AND target, so it enters squared
(weighted_flat_mse_criterion.lua:35-41).
"""

from typing import Optional

import torch

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.sdf import signed_distance_field


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


def fluid_loss(mconf: ModelConfig, p_pred, u_pred, p_target, u_target, flags,
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
