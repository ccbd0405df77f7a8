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

Every rank must take the same horizon and the same draws (JAX has one key
for the whole batch): they come from equal generator seeds, and
`loss_fn_sharded` checks them with one all_reduce.

Not ported (NotImplementedError, each naming its ROADMAP item): solver
targets with the p/u losses on and loss_p_lambda > 0 (normalize_pressure_
mean sums per connected component, which needs components labelled across
slabs: item 9), and what the sharded step refuses (pooled or banked
models: item 10; 2-D, no density, window 0: item 6).
"""

import functools

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState
from fluidnet_tpu_torch.models.fluidnet import layer_spec
from fluidnet_tpu_torch.ops.cuda.forces_kernel import HALO as K2_HALO
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.parallel.halo import exchange_ghost
from fluidnet_tpu_torch.parallel.mesh import all_reduce_max
from fluidnet_tpu_torch.parallel.simulate_sharded import (_check, _Slab,
                                                          _sharded_step)
from fluidnet_tpu_torch.sim.simulate import _resolve_forces
from fluidnet_tpu_torch.train.loss import border_loss_weights
from fluidnet_tpu_torch.train.train import _data_augmentation, draw

# The planes augment_without_targets reads beyond a cell (the module's
# note, step 2): K2's forces block composes the same three forces.
AUGMENT_REACH = K2_HALO


def model_ghost(mconf: ModelConfig) -> int:
    """The planes a model call's inputs are extended by on each side, so
    that the loss's divergence of its velocity is the whole grid's on the
    own planes (the module's note, step 2)."""
    return sum((k - 1) // 2 for k in layer_spec(mconf)[1]) + 5


def _refuse(mconf: ModelConfig):
    if mconf.train_target_source != "manta" and (
            mconf.loss_p_lambda > 0 or mconf.loss_u_lambda > 0):
        raise NotImplementedError(
            f"solver targets ({mconf.train_target_source}) with the p/u "
            f"losses on a z-sharded batch are not ported: the target "
            f"pressure's per-component mean needs components labelled "
            f"across slabs (ROADMAP queue 1, item 9: sharded PCG)")
    if mconf.loss_p_lambda > 0:
        raise NotImplementedError(
            "loss_p_lambda > 0 on a z-sharded batch is not ported: the "
            "target pressure's per-component mean needs components "
            "labelled across slabs (ROADMAP queue 1, item 9: sharded PCG)")


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
    _refuse(mconf)
    flags = batch_l["flags"]
    state_l = FluidState(u=batch_l["u_div"], p=batch_l["p_div"], flags=flags,
                         density=batch_l.get("density"))
    _check(state_l, mconf, model)
    if draws is None:
        draws = draw(gen, mconf)
    check_same(n_future, draws, dist.group.WORLD, flags.device)
    grad = torch.is_grad_enabled()
    gm = model_ghost(mconf)
    ga = gm + AUGMENT_REACH if mconf.augment_without_targets else gm
    slab = _Slab(state_l, mconf, mesh, None,
                 max(ga, mconf.loss_func_border_width))
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

    grown = None
    if mconf.augment_without_targets:
        if mconf.loss_p_lambda != 0 or mconf.loss_u_lambda != 0:
            raise ValueError("augment_without_targets requires the p/u "
                             "losses off")
        with torch.no_grad():
            pa, ua, da = exchange_ghost(
                [batch_l["p_div"], u_div, state_l.density], ga, slab.group)
            ua = _data_augmentation(
                ua, slab.crop(slab.flags_reach, slab.reach, ga).contiguous(),
                da, mconf, draws, use_kernels, dx=slab.dx)
            grown = (slab.crop(pa, ga, gm), slab.crop(ua, ga, gm))
            u_div = slab.crop(ua, ga, 0).contiguous()

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
        # Manta targets: no ground truth for future frames, the p and u
        # lambdas zeroed (run_epoch.lua:273-277). Solver targets reach
        # here only with both losses off (_refuse), so their terms are 0.
        lt_total, lt_terms = model_loss(
            p_lt, u_lt, p_lt, u_lt, p_lambda=0.0, u_lambda=0.0,
            div_lambda=mconf.long_term_div_lambda)
        total = total + lt_total
        terms["long_term_div"] = lt_terms["div"]
    else:
        terms["long_term_div"] = torch.zeros((), device=total.device)
    terms["total"] = total
    return total, terms
