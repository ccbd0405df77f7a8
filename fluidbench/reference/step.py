"""The simulation step, the training loss and the optimizer, in plain
PyTorch: the reference that a cell's `correct` is decided by.

The step is sim.simulate's 3-D ConvNet step as the port states it
(simulate.lua:175-327): the MacCormack advection of the density and the
MAC velocity ("maccormackOurs", its window, the two-direction clamp);
the slab BCs on p and the density; the projection prologue (the u slab,
buoyancy, gravity, vorticity confinement, the u slab again, setWallBcs,
the divergence); the ConvNet and its velocity update; the slab BCs; u
clipped to +-1e6. Training's last unroll step stops after the forces
(the divergent state). The loss is run_epoch.lua's: the divergence loss
of the first projection plus the long-term divergence loss after an
unroll of n steps, every step but the last differentiated through, each
advection's gradient being the JAX VJP of the sweeps (advection.py), the
prologue's and the forces' their plain compositions'. The optimizer is
optax's: the global-norm clip, then Adam, an update dropped when the
loss is not finite or reaches the reject threshold.

`mconf` is a namespace of the configuration's `mconf` with the traffic's
knobs applied; `params` a dict of the weights by name; `precision` the
ConvNet's compute type (model.py).
"""

import types

import torch

from fluidbench.reference import model
from fluidbench.reference.advection import (advect_vel_scalar_fast,
                                            chebyshev_free_space)
from fluidbench.reference.grid import get_dx
from fluidbench.reference.loss import border_loss_weights, fluid_loss
from fluidbench.reference.physics import (forces_block_xla, prologue_plain,
                                          slab)

U_CLAMP = 1e6
F32 = torch.float32


def namespace(mconf_dict, **knobs):
    """The configuration's mconf dict, with `knobs` applied, as an object
    with attributes."""
    return types.SimpleNamespace(**{**mconf_dict, **knobs})


def _scale(g_vec, scale):
    scale = torch.as_tensor(scale, dtype=F32)
    return g_vec * scale


def forces_config(dx, gravity, b_scale, g_scale, v_amp, has_buoy, has_grav,
                  has_vc):
    """(buoy_g, grav_g, amp) of simulate.lua:216-239, float32 on the
    host."""
    g_vec = torch.as_tensor(gravity, dtype=F32).cpu()
    zero3 = torch.zeros(3)
    coef = -(dx / 4.0)
    buoy_g = _scale(g_vec, coef * torch.as_tensor(b_scale, dtype=F32)
                    .cpu()) if has_buoy else zero3
    grav_g = _scale(g_vec, coef * torch.as_tensor(g_scale, dtype=F32)
                    .cpu()) if has_grav else zero3
    amp = dx * torch.as_tensor(v_amp, dtype=F32).cpu() \
        if has_vc else torch.zeros(())
    return buoy_g, grav_g, amp


def scene_forces(mconf, dx):
    """The forces of a rollout step: the configuration's scales, each on
    when positive, gravity (0, 1, 0) unless stated."""
    gravity = (0.0, 1.0, 0.0) if mconf.gravity is None else mconf.gravity
    return forces_config(dx, gravity, mconf.buoyancy_scale,
                         mconf.gravity_scale, mconf.vorticity_confinement_amp,
                         mconf.buoyancy_scale > 0, mconf.gravity_scale > 0,
                         mconf.vorticity_confinement_amp > 0)


def _slab_bcs(u, p, density, bcs, with_u=True):
    """The frozen slab BCs: bcs a dict of (bc, inv) pairs by field."""
    if bcs is None:
        return u, p, density
    if with_u and "u" in bcs:
        u = slab(u, *bcs["u"])
    if "p" in bcs:
        p = slab(p, *bcs["p"])
    if "density" in bcs:
        density = slab(density, *bcs["density"])
    return u, p, density


def step(params, mconf, layers, u, p, density, flags, free, bcs, dt,
         forces, precision, output_div=False, project=model.forward):
    """One 3-D step; with output_div the divergent state after the forces
    (training's last unroll step). `forces` is (buoy_g, grav_g, amp);
    `free` the Chebyshev free space of the window; `project` the
    projection, called as model.forward is (a configuration's
    projections/<name>.py gives it). Returns (u, p, density)."""
    W = mconf.advection_window
    density, u = advect_vel_scalar_fast(
        dt, density, u, flags, mconf.advection_method, False,
        mconf.maccormack_strength, W, free=free, plain=True)
    buoy_g, grav_g, amp = forces
    if output_div:
        u, p, density = _slab_bcs(u, p, density, bcs)
        u = forces_block_xla(u, flags, density[:, 0:1], buoy_g, grav_g, amp,
                             dt)
        return u, p, density
    u, p, density = _slab_bcs(u, p, density, bcs, with_u=False)
    ubc = bcs.get("u") if bcs else None
    u, div = prologue_plain(u, flags, density[:, 0:1], buoy_g, grav_g, amp,
                            float(dt), *(ubc or (None, None)))
    u, p, density = _slab_bcs(u, p, density, bcs, with_u=False)
    p, u = project(params, mconf, layers, p, u, flags, precision,
                   precomputed_div=div)
    u, p, density = _slab_bcs(u, p, density, bcs)
    lim = u.new_tensor(U_CLAMP)
    return torch.minimum(torch.maximum(u, -lim), lim), p, density


def frame(params, mconf, layers, u, p, density, flags, bcs, n_steps,
          precision, project=model.forward):
    """`n_steps` rollout steps from (u, p, density), without gradients."""
    dt = mconf.dt
    free = chebyshev_free_space(flags, mconf.advection_window + 1)
    forces = scene_forces(mconf, get_dx(flags))
    with torch.no_grad():
        for _ in range(n_steps):
            u, p, density = step(params, mconf, layers, u, p, density, flags,
                                 free, bcs, dt, forces, precision,
                                 project=project)
    return u, p, density


def loss(params, mconf, layers, batch, draws, n_future, precision,
         project=model.forward):
    """The total loss of one batch (train.py:179-276, the manta target
    source, the p and u losses off) for the draws (dt, gravity, b_scale,
    g_scale, v_amp) and the horizon n_future."""
    flags = batch["flags"]
    dt, gravity, b_scale, g_scale, v_amp = draws
    weights = None
    if mconf.loss_func_border_weight != 1.0:
        with torch.no_grad():
            weights = border_loss_weights(flags, mconf.loss_func_border_weight,
                                          mconf.loss_func_border_width)
    zeros_p = torch.zeros_like(batch["p_div"])
    p_pred, u_pred = project(params, mconf, layers, batch["p_div"],
                             batch["u_div"], flags, precision)
    total, _ = fluid_loss(mconf, p_pred, u_pred, zeros_p,
                          torch.zeros_like(batch["u_div"]), flags,
                          weights=weights)
    if n_future <= 0 or mconf.long_term_div_lambda <= 0:
        return total
    with torch.no_grad():
        free = chebyshev_free_space(flags, mconf.advection_window + 1)
    forces = forces_config(get_dx(flags), gravity, b_scale, g_scale, v_amp,
                           True, True, True)
    u, p, density = batch["u_div"], batch["p_div"], batch["density"]
    for i in range(n_future):
        u, p, density = step(params, mconf, layers, u, p, density, flags,
                             free, None, dt, forces, precision,
                             output_div=i == n_future - 1, project=project)
    p_lt, u_lt = project(params, mconf, layers, p, u, flags, precision)
    lt_total, _ = fluid_loss(mconf, p_lt, u_lt, p, u, flags, p_lambda=0.0,
                             u_lambda=0.0,
                             div_lambda=mconf.long_term_div_lambda,
                             weights=weights)
    return total + lt_total


def global_norm(tensors):
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def adam_init(params):
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in
                               params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def train_step(params, opt, mconf, layers, batch, draws, n_future,
               precision, project=model.forward):
    """One optimizer step: returns (params, opt, loss, the clipped
    gradients the optimizer got). The update is dropped (params and opt
    kept) when the loss is not finite or reaches the reject threshold."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = loss(leaves, mconf, layers, batch, draws, n_future, precision,
                 project)
    names = list(leaves)
    grads = torch.autograd.grad(total, [leaves[k] for k in names])
    with torch.no_grad():
        gn = global_norm(grads)
        g = [t if gn < mconf.grad_norm_threshold else
             (t / gn) * mconf.grad_norm_threshold for t in grads]
        clipped = dict(zip(names, g))
        ok = bool(torch.isfinite(total)) and bool(torch.isfinite(gn))
        if mconf.loss_reject_threshold > 0:
            ok = ok and float(total) < mconf.loss_reject_threshold
        if not ok:
            return params, opt, float(total), clipped
        o = mconf.optim
        b1, b2 = o["beta1"], o["beta2"]
        count = opt["count"] + 1
        bc1 = 1 - torch.tensor(b1, dtype=F32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=F32) ** count
        mu, nu, new = {}, {}, {}
        for k, t in clipped.items():
            mu[k] = (1 - b1) * t + b1 * opt["mu"][k]
            nu[k] = (1 - b2) * (t ** 2) + b2 * opt["nu"][k]
            upd = (mu[k] / bc1.to(t.device)) / (
                torch.sqrt(nu[k] / bc2.to(t.device)) + o["epsilon"])
            new[k] = params[k] + upd * -o["learning_rate"]
    return new, {"count": count, "mu": mu, "nu": nu}, float(total.detach()), \
        clipped
