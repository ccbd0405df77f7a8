"""The training loss on a batch z-sharded over the mesh's 'sp' ranks: what
GSPMD gives the JAX package when `train_step` runs on a batch that
`shard_batch` splits over 'dp' (samples) and 'sp' (z) (fluidnet_tpu/
parallel/mesh.py:47-50, train/train.py:179-276), spelled out.

Each rank holds its slab of every field of its samples. `loss_fn_sharded`
returns this rank's share of the loss: each term is a sum over the rank's
own planes divided by the cell count of its samples' whole grid, so the
shares of the 'sp' ranks add up to the loss of their samples
(train/loss.fluid_loss's means). Each rank backpropagates its own share;
the exchanges' and the input scale's adjoints (parallel/halo.py,
parallel/mesh.py) carry the cotangents across the cuts, and
train.train_step(mesh=) sums the gradients over 'sp' and averages them
over 'dp' in one all_reduce.

  1. The flags are extended once a loss, to the widest reach of a step
     (parallel/simulate_sharded._Slab). The border weights
     (train/loss.border_loss_weights, a signed-distance reach of
     loss_func_border_width - 1 planes) are computed on them and cropped
     to the own planes.
  2. A model call on a slab (the first on p_div / u_div, the last on the
     unroll's state) runs on its inputs extended by their own ghost zone
     of `model_ghost(mconf)` planes, with the grid's input scale
     (all_reduced sums over the own planes). The zone covers the reach of
     what the loss reads of the model's output: the model's setWallBcs
     and divergence of its input (2), the trunk's conv radii (3 for the
     default 8-8-8-8-1 stack), its velocity update and setWallBcs (2) and
     the loss's divergence of u_pred (1): 8 planes for the default model.
     With augment_without_targets, the first call's exchange grows p_div,
     u_div and density by `model_ghost(mconf) + AUGMENT_REACH` planes
     instead: train/train._data_augmentation (buoyancy, gravity, K4's
     vorticity confinement) runs there without gradients (JAX's
     stop_gradient), with the grid's dx, and its result is cropped to the
     model's ghost zone and to the own planes (the unroll's start).
     AUGMENT_REACH is 4: K4 reads u 3 planes away (the centred velocity,
     the curl, the gradient of its norm, the face average of the force)
     and buoyancy and gravity the density and flags of the face below,
     the reach of K2's forces block, which composes the same three. So
     augmentation adds no exchange and one K4 launch a step.
  3. The unroll is n_future sharded steps (simulate_sharded._sharded_step,
     one ghost exchange each), each but the last under a non-reentrant
     checkpoint in 'full' mode, as train/train.loss_fn. The recompute in
     the backward reruns a step's forward exchanges: every rank reaches
     the same exchanges in the same order, since every rank builds the
     same graph.

  4. Solver targets (train_target_source 'pcg' or 'jacobi' with the p/u
     losses on): the first call's exchange grows p_div, u_div and density
     by model_ghost + TARGET_REACH + AUGMENT_REACH planes, the
     augmentation runs there, then train/train._calc_pu_targets on the
     slab without gradients (`_slab_targets`): setWallBcs and the
     divergence on the grown slab, the solve on the own planes
     (pcg_sharded.solve_pcg_z_sharded, tol 1e-4, max_iter or 100; or
     halo.slab_jacobi_solve, max_iter or 50 sweeps on K3, the flags grown
     by its h once a loss), an exchange of p by 2 planes, the velocity
     update and setWallBcs, cropped to the own planes. The wall-BC'd
     u_div, grown by model_ghost, is the first model call's input and
     its own planes the unroll's start. The long-term frame solves for
     its targets again on the unroll's u, grown by one exchange of
     TARGET_REACH + 2 planes (JAX's train.py:263-266).
  5. loss_p_lambda > 0 (and the long-term solver targets): the target
     pressure's per-component mean is the whole grid's
     (pcg_sharded.normalize_pressure_mean_z_sharded), with the
     components labelled across the slabs once a loss.

Every rank must take the same horizon and the same draws (JAX has one key
for the whole batch): they come from equal generator seeds, and
`loss_fn_sharded` checks them with one all_reduce.

Not ported: what the sharded step refuses (NotImplementedError, each
naming its ROADMAP item: pooled or banked models, item 10; 2-D, no
density, window 0, item 6).
"""

import functools

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.models.fluidnet import layer_spec
from fluidnet_tpu_torch.ops.boundary import set_wall_bcs
from fluidnet_tpu_torch.ops.cuda.forces_kernel import HALO as K2_HALO
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.velocity_update import velocity_update
from fluidnet_tpu_torch.parallel.halo import (exchange_ghost,
                                              slab_jacobi_solve)
from fluidnet_tpu_torch.parallel.mesh import all_reduce_max
from fluidnet_tpu_torch.parallel.pcg_sharded import (
    normalize_pressure_mean_z_sharded, slab_components, solve_pcg_z_sharded)
from fluidnet_tpu_torch.parallel.simulate_sharded import (_check, _Slab,
                                                          _sharded_step)
from fluidnet_tpu_torch.sim.simulate import _resolve_forces
from fluidnet_tpu_torch.train.loss import border_loss_weights
from fluidnet_tpu_torch.train.train import _data_augmentation, draw

# The planes augment_without_targets reads beyond a cell (the module's
# note, step 2): K2's forces block composes the same three forces.
AUGMENT_REACH = K2_HALO
# The planes the solver targets' setWallBcs reads beyond a cell: the
# wall-BC'd u_div is right on one plane fewer than the u it is given
# (_slab_targets).
TARGET_REACH = 1


def model_ghost(mconf: ModelConfig) -> int:
    """The planes a model call's inputs are extended by on each side, so
    that the loss's divergence of its velocity is the whole grid's on the
    own planes (the module's note, step 2)."""
    return sum((k - 1) // 2 for k in layer_spec(mconf)[1]) + 5


def _jacobi_sweeps(mconf: ModelConfig) -> int:
    """The sweeps of the 'jacobi' solver targets (train/train.
    _calc_pu_targets)."""
    return mconf.max_iter or 50


def _slab_targets(slab, mesh, mconf, u, have: int, segs, use_kernels):
    """train/train._calc_pu_targets on this rank's slab, without
    gradients: `u`, its u_div grown by `have` >= 3 planes (one-sided at
    the global ends), right on every plane. setWallBcs and the divergence
    run on the grown slab, the solve on the own planes (`segs`: the
    slab_components of the flags), the velocity update and setWallBcs on
    the own planes grown by 2 (p exchanged by 2 planes). Returns (the
    wall-BC'd u on the slab grown by have - 1, p_target and u_target on
    the own planes)."""
    fe = slab.crop(slab.flags_reach, slab.reach, have)
    uw = set_wall_bcs(u, fe)
    div = slab.crop(velocity_divergence(uw, fe), have, 0).contiguous()
    f_own = slab.crop(fe, have, 0).contiguous()
    if mconf.train_target_source == "pcg":
        p_t, _, _ = solve_pcg_z_sharded(
            f_own, div, mesh, slab.z_own, tol=1e-4,
            max_iter=mconf.max_iter or 100, labels=segs,
            flags_ext=slab.crop(fe, have, 1))
    elif mconf.train_target_source == "jacobi":
        n = _jacobi_sweeps(mconf)
        p_t = slab_jacobi_solve(
            f_own, div, mesh, n, use_kernels,
            slab.crop(slab.flags_reach, slab.reach, min(n, slab.zl)))
    else:
        raise ValueError(
            f"bad train_target_source {mconf.train_target_source}")
    pe, = exchange_ghost([p_t], 2, slab.group)
    f2 = slab.crop(fe, have, 2)
    u_t = set_wall_bcs(velocity_update(slab.crop(uw, have, 2), f2, pe), f2)
    return slab.crop(uw, have, have - 1), p_t, slab.crop(u_t, 2, 0)


def check_same(n_future: int, draws, group, device):
    """Raises unless every rank of `group` holds the same horizon and
    draws (one all_reduce MAX of them and their negatives, on
    `device`)."""
    v = torch.cat([torch.tensor([float(n_future)])] +
                  [torch.as_tensor(t, dtype=torch.float32).reshape(-1)
                   for t in draws])
    both = all_reduce_max(torch.cat([v, -v]).to(device), group).cpu()
    if not torch.equal(both[:v.numel()], -both[v.numel():]):
        raise ValueError("sharded loss: the ranks drew different horizons "
                         "or draws (seed every rank's generator alike)")


def _slab_terms(mconf, crop, count, p_pred, u_pred, p_target, u_target,
                flags, w, p_lambda, u_lambda, div_lambda):
    """train/loss.fluid_loss as this rank's share: p_pred, u_pred and
    flags are extended slabs, `crop` cuts their own planes; the targets
    and the weights `w` are own planes; each term is a sum over the own
    planes over `count` (the cells of a field's channel in the whole
    grid of this rank's samples) times its channels."""
    def wsse(a, b, chans):
        d = (a - b) ** 2 if w is None else (w * a - w * b) ** 2
        return d.sum() / (count * chans)

    zero = torch.zeros((), device=u_pred.device)
    terms, total = {}, None
    for k, lam, pred, tgt in (("p", p_lambda, p_pred, p_target),
                              ("u", u_lambda, u_pred, u_target)):
        terms[k] = lam * wsse(crop(pred), tgt, pred.shape[1]) \
            if lam != 0.0 else zero
        if lam != 0.0:
            total = terms[k] if total is None else total + terms[k]
    div = crop(velocity_divergence(u_pred, flags))
    terms["div"] = div_lambda * wsse(div, torch.zeros_like(div), 1)
    total = terms["div"] if total is None else total + terms["div"]
    return total, terms


def loss_fn_sharded(model, batch_l, gen, mconf: ModelConfig, n_future: int,
                    mesh, draws=None, use_kernels: bool = True):
    """train/train.loss_fn on this rank's part of a batch (shard_batch's:
    samples over 'dp', z over 'sp'): returns (this rank's share of the
    total, {term: share}), 0-d tensors. The draws come from the CPU
    generator `gen` unless given in `draws`; every rank of the mesh calls
    it with the same horizon and draws. The unroll records gradients when
    autograd is on; a backward through the share then runs the exchanges'
    adjoints, so every rank must run it."""
    flags = batch_l["flags"]
    state_l = FluidState(u=batch_l["u_div"], p=batch_l["p_div"], flags=flags,
                         density=batch_l.get("density"))
    _check(state_l, mconf, model)
    if draws is None:
        draws = draw(gen, mconf)
    check_same(n_future, draws, dist.group.WORLD, flags.device)
    grad = torch.is_grad_enabled()
    use_solver_gt = (mconf.train_target_source != "manta" and
                     (mconf.loss_p_lambda > 0 or mconf.loss_u_lambda > 0))
    gm = model_ghost(mconf)
    ga = gm
    if use_solver_gt:
        ga = gm + TARGET_REACH + AUGMENT_REACH
    elif mconf.augment_without_targets:
        ga = gm + AUGMENT_REACH
    solve_h = min(_jacobi_sweeps(mconf), flags.shape[2]) \
        if mconf.train_target_source == "jacobi" else 0
    slab = _Slab(state_l, mconf, mesh, None,
                 max(ga, mconf.loss_func_border_width, solve_h,
                     TARGET_REACH + 2))
    flags_m = slab.crop(slab.flags_reach, slab.reach, gm)

    def crop(x):
        return slab.crop(x, gm, 0)
    count = flags.shape[0] * flags.shape[2] * slab.n * flags.shape[3] * \
        flags.shape[4]

    u_div = batch_l["u_div"]
    p_target = batch_l.get("p_target")
    u_target = batch_l.get("u_target")
    if p_target is None or u_target is None:
        if mconf.loss_p_lambda != 0 or mconf.loss_u_lambda != 0:
            raise ValueError("p/u losses need target fields in the batch")
        p_target = torch.zeros_like(batch_l["p_div"])
        u_target = torch.zeros_like(u_div)
    weights = None
    if mconf.loss_func_border_weight != 1.0:
        with torch.no_grad():
            weights = slab.crop(border_loss_weights(
                slab.flags_reach, mconf.loss_func_border_weight,
                mconf.loss_func_border_width), slab.reach, 0)
    scale = functools.partial(slab.input_scale, ghost=gm)

    def model_loss(p, u, p_tgt, u_tgt, grown=None, **lambdas):
        pe, ue = exchange_ghost([p, u], gm, slab.group) if grown is None \
            else grown
        p_pred, u_pred = model(pe, ue, flags_m, input_scale=scale)
        return _slab_terms(mconf, crop, count, p_pred, u_pred, p_tgt, u_tgt,
                           flags_m, weights, **lambdas)

    segs = None
    if mconf.loss_p_lambda > 0 or mconf.train_target_source != "manta":
        # The components across the slabs, once a loss.
        segs = slab_components(flags, mesh, slab.z_own)

    grown = None
    if use_solver_gt or mconf.augment_without_targets:
        if not use_solver_gt and (mconf.loss_p_lambda != 0 or
                                  mconf.loss_u_lambda != 0):
            raise ValueError("augment_without_targets requires the p/u "
                             "losses off")
        with torch.no_grad():
            pa, ua, da = exchange_ghost(
                [batch_l["p_div"], u_div, state_l.density], ga, slab.group)
            ua = _data_augmentation(
                ua, slab.crop(slab.flags_reach, slab.reach, ga).contiguous(),
                da, mconf, draws, use_kernels, dx=slab.dx)
            gu = ga
            if use_solver_gt:
                have = ga - AUGMENT_REACH
                ua, p_target, u_target = _slab_targets(
                    slab, mesh, mconf, slab.crop(ua, ga, have), have, segs,
                    use_kernels)
                gu = have - 1
            grown = (slab.crop(pa, ga, gm), slab.crop(ua, gu, gm))
            u_div = slab.crop(ua, gu, 0).contiguous()
    if mconf.loss_p_lambda > 0:
        with torch.no_grad():
            p_target = normalize_pressure_mean_z_sharded(p_target, flags,
                                                         segs)

    total, terms = model_loss(
        batch_l["p_div"], u_div, p_target, u_target, grown,
        p_lambda=mconf.loss_p_lambda, u_lambda=mconf.loss_u_lambda,
        div_lambda=mconf.loss_div_lambda)

    if n_future > 0 and mconf.long_term_div_lambda > 0:
        forces = _resolve_forces(state_l, mconf, draws.dt, draws.b_scale,
                                 draws.g_scale, draws.v_amp, draws.gravity)

        def step(u, p, density, output_div):
            s = _sharded_step(FluidState(u=u, p=p, flags=flags,
                                         density=density), mconf, model,
                              slab, forces, use_kernels, output_div)
            return s.u, s.p, s.density

        fields = (u_div, batch_l["p_div"], batch_l.get("density"))
        if mconf.long_term_grad_mode == "full":
            for _ in range(n_future - 1):
                fields = checkpoint(step, *fields, False,
                                    use_reentrant=False,
                                    preserve_rng_state=False) if grad \
                    else step(*fields, False)
            fields = step(*fields, True)
        elif mconf.long_term_grad_mode == "last":
            with torch.no_grad():
                for i in range(n_future):
                    fields = step(*fields, i == n_future - 1)
        else:
            raise ValueError(f"bad long_term_grad_mode "
                             f"{mconf.long_term_grad_mode}")
        u_lt, p_lt = fields[0], fields[1]
        if mconf.train_target_source == "manta":
            # No ground truth for future frames: the p and u lambdas
            # zeroed (run_epoch.lua:273-277).
            lt_total, lt_terms = model_loss(
                p_lt, u_lt, p_lt, u_lt, p_lambda=0.0, u_lambda=0.0,
                div_lambda=mconf.long_term_div_lambda)
        else:
            # Solver ground truth for the future frame too
            # (run_epoch.lua:278-283).
            have = TARGET_REACH + 2
            with torch.no_grad():
                ue, = exchange_ghost([u_lt], have, slab.group)
                _, p_lt_t, u_lt_t = _slab_targets(slab, mesh, mconf, ue,
                                                  have, segs, use_kernels)
                p_lt_t = normalize_pressure_mean_z_sharded(p_lt_t, flags,
                                                           segs)
            lt_total, lt_terms = model_loss(
                p_lt, u_lt, p_lt_t, u_lt_t, p_lambda=mconf.loss_p_lambda,
                u_lambda=mconf.loss_u_lambda,
                div_lambda=mconf.long_term_div_lambda)
        total = total + lt_total
        terms["long_term_div"] = lt_terms["div"]
    else:
        terms["long_term_div"] = torch.zeros((), device=total.device)
    terms["total"] = total
    return total, terms
