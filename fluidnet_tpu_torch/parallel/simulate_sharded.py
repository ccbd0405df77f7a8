"""The whole simulation step on a grid z-sharded over the mesh's 'sp'
ranks: what GSPMD gives the JAX package for inference (simulate / rollout
on a z-sharded state, tests/test_parallel.py:137-194), spelled out.

Each rank holds a slab of zl = Z / n_sp planes of every field (batch over
'dp', z over 'sp': `shard_state`, `shard_bcs`). A step:

  1. the advection window from the grid's max|u| (one all_reduce MAX, only
     with adaptive_window and advection_window > 1), so that every rank
     takes the same W;
  2. one exchange (`halo.exchange_ghost`) extends u, density and, for the
     ConvNet, p by the ghost zone of G planes from each neighbour, and by
     nothing past the global z ends;
  3. sim.simulate's own `_step` runs on the extended slab with a
     `SlabStep`: the grid's dx, the extended slab's z origin (the global
     index of its first plane), that window, the ConvNet's input scale
     from the grid's sums over each rank's own planes (all_reduces of
     per-sample partial sums), and the solves that reach past G: the
     polish (an exchange of u by n + 2 planes, then divergence, n Jacobi
     sweeps on K3, the velocity update, on that extension), jacobi-n
     (the divergence, `halo.slab_jacobi_solve`: K3 in rounds of at most
     h = min(n, zl) sweeps on the slab grown by h planes, then an
     exchange of p by one plane, the velocity update) and PCG (the
     divergence, `pcg_sharded.solve_pcg_z_sharded`: an exchange of d by
     one plane and two all_reduces over 'sp' a CG iteration, then an
     exchange of p by one plane, the velocity update);
  4. the extended slab is cropped back to the rank's own planes.

The flags and the BC masks do not change within a rollout: one exchange
extends them at its start, to the widest reach a step needs (h for
jacobi-n). PCG's connected components are labelled across the slabs
once, at the same start (pcg_sharded.slab_components: a label exchange
and an all_reduce MAX a sweep, then one all_gather of the labels
present).

Why one-sided. An extended slab is then a contiguous range of the whole
grid, so every positional border test on the path falls where it falls on
the whole grid (K2's `interior`, the border masks of the advection, the
divergence, the velocity update and the forces, K3's zero border, K1's
index clamps), and each 3-wide conv of the trunk zero-pads z at the global
ends as the whole grid does. A slab's own ends lie inside the ghost zone:
what the positional tests and the zero pads spoil there reaches at most G
planes in and is cropped away.

The ghost zone G is the sum of the stencil radii of one step before its
Jacobi solves (`ghost_planes`): the advection 2W + 2 (W the largest window
mconf allows), K2's halo of 4 (the prologue, or the forces block), then
for the ConvNet the trunk's conv radii (3 for the default 8-8-8-8-1 stack)
and the model's velocity update and setWallBcs (2), for jacobi-n and PCG
the setWallBcs and the divergence (2): 13 planes for the ConvNet at W = 1,
10 for jacobi-n and PCG.

Exchanges a step: the ConvNet 1 (u, p, density: 5 channels x G planes each
way), plus 1 with the polish (u: 3 channels x (n + 2) planes); jacobi-n 1
(u, density: 4 x G), 1 + (ceil(n / h) - 1) in the solve (div by h, then p
by h before each round after the first: 1 x h) and 1 for the velocity
update (p: 1 x 1): 4 for jacobi-34 at 128^3 over 4 ranks (h = 32, two
rounds); PCG 2 + k, and 4 + 2k all_reduces, at k CG iterations (d: 1 x 1
an iteration; the all_reduces: the component sums of has_dirichlet, the
RHS mean and the p mean, the first dot products, then 2 an iteration; with
more than one 'dp' group k + 2 more, the stop test's and the residual's
max over the mesh). All reductions (the input scale, the window, the dot
products, the component sums) run over each rank's own planes, never the
ghost planes.

Every rank's own planes after one step equal the whole grid's to the bit
through the advection and K2, and for jacobi-n through the whole step.
The advection takes the z origin: its positions are global, (z0 + k) +
clip(d) in z, so K1's and K5's weights round as the whole grid's, and
their clamps and window tests sit at the slab's ends expressed globally
(ops/cuda/mac_sweep.py, ops/warp.py); the slab's ends lie in the ghost
zone. The jacobi-n solve adds nothing: each rank's p equals K3 on the
whole grid's divergence to the bit. What stays apart on the ConvNet: the
input scale sums in another order, and cuDNN rounds the trunk's
convolutions differently on another shape; so the whole ConvNet step
agrees with the whole grid's to that rounding, not to the bit. PCG's
labels are the whole grid's exactly, but its dot products and
component sums add in another order, so its p agrees with the whole
grid's to the solver's rounding; a rerun on the same ranks gives the
same bits.

Not ported here (NotImplementedError, each naming its ROADMAP item):
models with pooling, pixel shuffles or banks (their halos must align to
the pooling factor), 2-D states, states without density and
advection_window 0.

Training: under autograd (`simulate_z_sharded(grad=True)`, the unroll of
parallel/train_sharded.py) the same step records its graph on the slab.
The exchanges and the input scale's all_reduces are differentiable
(halo.exchange_ghost, mesh.all_reduce_sum): the backward sends each ghost
plane's cotangent to the rank that owns the plane, and sums the input
scale's cotangents over the ranks. The kernels keep their gradient rules
on the slab (ops/replay.py for K1's fused sweeps and K2 with the grid's
dx; K1's unfused sweeps, whose backward is K6).
"""

from typing import Optional

import torch
import torch.distributed as dist

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import FluidState, get_dx
from fluidnet_tpu_torch.models.fluidnet import (input_chan, layer_spec,
                                                scale_of)
from fluidnet_tpu_torch.ops.cuda.forces_kernel import HALO as K2_HALO
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.velocity_update import velocity_update
from fluidnet_tpu_torch.parallel.halo import (exchange_ghost,
                                              slab_jacobi_solve)
from fluidnet_tpu_torch.parallel.mesh import (all_reduce_max,
                                              all_reduce_sum, batch_sharding,
                                              host_staged, local_part,
                                              mesh_device)
from fluidnet_tpu_torch.parallel.pcg_sharded import (slab_components,
                                                     solve_pcg_z_sharded)
from fluidnet_tpu_torch.sim.simulate import (Boundaries, FlagConsts,
                                             SlabStep, _check_slice,
                                             _fixed_jacobi, _resolve_forces,
                                             _step, _window)

BC_FIELDS = ("u_bc", "u_bc_inv_mask", "p_bc", "p_bc_inv_mask", "density_bc",
             "density_bc_inv_mask")


def ghost_planes(mconf: ModelConfig) -> int:
    """G, the planes a step's exchange adds on each side: the stencil
    radii of the step before its Jacobi solves, at the largest window
    mconf allows."""
    advection = 2 * mconf.advection_window + 2
    if mconf.sim_method == "convnet":
        trunk = sum((k - 1) // 2 for k in layer_spec(mconf)[1])
        return advection + K2_HALO + trunk + 2
    return advection + K2_HALO + 2


def _check(state_l: FluidState, mconf: ModelConfig, model):
    """Refuses what the sharded step does not port."""
    _check_slice(state_l, mconf, model)
    if mconf.sim_method == "convnet":
        _, _, psize, usize = layer_spec(mconf)
        if mconf.banks_num > 1 or max(psize) > 1 or max(usize) > 1:
            raise NotImplementedError(
                f"model {mconf.model_type!r} with pooling, pixel shuffles "
                f"or banks on a z-sharded state is not ported: its halos "
                f"must align to the pooling factor (ROADMAP queue 1, item "
                f"10: sharded pooled and banked models)")
    if not state_l.is_3d:
        raise NotImplementedError("the z-sharded step is 3-D: a 2-D state "
                                  "has no z to split (ROADMAP queue 1, item "
                                  "6: left out)")
    if state_l.density is None:
        raise NotImplementedError("the z-sharded step needs a density "
                                  "field (ROADMAP queue 1, item 6: left "
                                  "out)")
    if not mconf.advection_window:
        raise NotImplementedError("the exact advection (advection_window "
                                  "0) on a z-sharded state is not ported "
                                  "(ROADMAP queue 1, item 6: left out)")


class _Slab:
    """This rank's slab of the grid for one rollout: its place, the
    ghost zones, and the flags and BC masks extended once to the widest
    reach a step needs (G, the polish's n + 2, jacobi-n's h), or `reach`
    if wider (one-sided at the global ends)."""

    def __init__(self, state_l, mconf, mesh, bcs_l, reach: int = 0):
        sp = mesh["sp"]
        self.mesh, self.group = mesh, sp.get_group()
        idx, self.n = sp.get_local_rank(), sp.size()
        self.below, self.above = idx > 0, idx < self.n - 1
        self.zl = zl = state_l.u.shape[2]
        Y, X = state_l.u.shape[3:]
        self.dx = get_dx((zl * self.n, Y, X))
        self.g = ghost_planes(mconf)
        # The global index of the own and the G-extended slab's first
        # plane.
        self.z_own = idx * zl
        self.z0 = self.z_own - self.g * self.below
        self.polish = mconf.polish_iters + 2 \
            if mconf.sim_method == "convnet" and mconf.polish_iters > 0 \
            else 0
        self.solve_h = min(mconf.max_iter, zl) \
            if mconf.sim_method == "jacobi" else 0
        self.reach = max(self.g, self.polish, self.solve_h, reach)
        if zl < self.reach:
            raise ValueError(f"shard z-length {zl} < ghost zone "
                             f"{self.reach}: the exchange only reaches "
                             f"immediate neighbours (use fewer sp shards)")
        names = [k for k in BC_FIELDS
                 if bcs_l is not None and getattr(bcs_l, k) is not None]
        ext = exchange_ghost(
            [state_l.flags] + [getattr(bcs_l, k) for k in names],
            self.reach, self.group)
        self.flags = self.crop(ext[0], self.reach, self.g)
        self.bcs = None if bcs_l is None else Boundaries(**{
            k: self.crop(x, self.reach, self.g)
            for k, x in zip(names, ext[1:])})
        self.flags_reach = ext[0]
        self.consts = FlagConsts()
        # PCG's components depend on the flags alone: labelled once.
        self.labels = slab_components(state_l.flags, mesh, self.z_own) \
            if mconf.sim_method == "pcg" else None

    def crop(self, x, have: int, want: int):
        """x, this rank's slab extended by `have` planes (one-sided),
        cut to the slab extended by `want` <= have."""
        start = (have - want) * self.below
        return x[:, :, start:start + self.zl + want * (self.below +
                                                       self.above)]

    def own(self, x):
        """This rank's own planes of a G-extended slab."""
        return self.crop(x, self.g, 0)

    def embed(self, x, part):
        """The G-extended slab x with its own planes replaced by part."""
        lo = self.g * self.below
        return torch.cat([x[:, :, :lo], part, x[:, :, lo + self.zl:]],
                         dim=2)

    def input_scale(self, mconf, p_div, u_div, div, ghost=None):
        """models.fluidnet._input_scale of the whole grid, from per-sample
        sums over each rank's own planes of slabs extended by `ghost`
        planes (None: G), all_reduced over the ranks. The std takes JAX's
        two passes: the grid's sum over its cell count gives the mean,
        then the grid's sum of squared deviations over the count less
        one."""
        chan = self.crop(input_chan(mconf, p_div, u_div, div),
                         self.g if ghost is None else ghost, 0)
        flat = chan.reshape(chan.shape[0], -1)

        def total(t):
            return all_reduce_sum(t, self.group)
        if mconf.normalize_input_func == "std":
            n = flat.shape[1] * self.n
            mean = total(flat.sum(dim=1, keepdim=True)) / n
            sq = total(((flat - mean) ** 2).sum(dim=1)) / (n - 1)
        elif mconf.normalize_input_func == "norm":
            sq = total((flat * flat).sum(dim=1))
        else:
            raise ValueError(mconf.normalize_input_func)
        return scale_of(mconf, sq)

    def polish_step(self, state, mconf, p, u, use_kernels):
        """sim.simulate._polish on the slab: u's own planes extended by
        the polish's reach (one exchange), then the residual divergence,
        mconf.polish_iters Jacobi sweeps (K3), the velocity update and
        p += dp there; the own planes go back into the G-extended slab."""
        if not self.polish:
            return state.replace(u=u, p=p)
        ue, = exchange_ghost([self.own(u)], self.polish, self.group)
        fe = self.crop(self.flags_reach, self.reach, self.polish)
        dp = _fixed_jacobi(fe, velocity_divergence(ue, fe),
                           mconf.polish_iters, use_kernels)
        u_own = self.crop(velocity_update(ue, fe, dp), self.polish, 0)
        p_own = self.own(p) + self.crop(dp, self.polish, 0)
        return state.replace(u=self.embed(u, u_own), p=self.embed(p, p_own))

    def jacobi_solve(self, state, mconf, consts, use_kernels):
        """sim.simulate._solver_projection for jacobi-n on the slab: the
        divergence of the own planes, halo.slab_jacobi_solve (K3 in
        rounds on the slab grown by h, with the flags grown once at the
        rollout's start; equal to the bit to K3 on the whole grid), then
        p extended by one plane and the velocity update."""
        flags, u = state.flags, state.u
        div = velocity_divergence(u, flags)
        p = slab_jacobi_solve(
            self.own(flags), self.own(div), self.mesh, mconf.max_iter,
            use_kernels, self.crop(self.flags_reach, self.reach,
                                   self.solve_h))
        pe, = exchange_ghost([p], 1, self.group)
        u1 = velocity_update(self.crop(u, self.g, 1),
                             self.crop(flags, self.g, 1), pe)
        return state.replace(u=self.embed(u, self.crop(u1, 1, 0)),
                             p=self.embed(state.p, p))


    def pcg_solve(self, state, mconf, consts, use_kernels):
        """sim.simulate._solver_projection for PCG on the slab: the
        divergence of the own planes, pcg_sharded.solve_pcg_z_sharded
        (its dot products and component sums all_reduced over 'sp', the
        labels and the flags grown by one plane kept from the rollout's
        start), then p extended by one plane and the velocity update."""
        flags, u = state.flags, state.u
        div = velocity_divergence(u, flags)
        p, _, _ = solve_pcg_z_sharded(
            self.own(flags), self.own(div), self.mesh, self.z_own,
            mconf.pcg_tol, mconf.max_iter,
            labels=self.labels,
            flags_ext=self.crop(self.flags_reach, self.reach, 1))
        pe, = exchange_ghost([p], 1, self.group)
        u1 = velocity_update(self.crop(u, self.g, 1),
                             self.crop(flags, self.g, 1), pe)
        return state.replace(u=self.embed(u, self.crop(u1, 1, 0)),
                             p=self.embed(state.p, p))


def step_window(mconf: ModelConfig, u_l, dt, group) -> int:
    """The advection window every rank takes: sim.simulate._window on the
    grid's max|u| (an all_reduce MAX over `group` of each rank's own
    planes), so that no two ranks choose differently."""
    W = mconf.advection_window
    if mconf.adaptive_window and W > 1:
        return _window(mconf, all_reduce_max(u_l.detach().abs().max(),
                                             group), dt)
    return W


def _sharded_step(state_l, mconf, model, slab, forces, use_kernels,
                  output_div=False):
    """sim.simulate._step on this rank's slab (`slab`: the flags and BC
    masks extended once); `output_div` returns the divergent state after
    the forces, as the unsharded step does."""
    W = step_window(mconf, state_l.u, forces.dt, slab.group)
    convnet = mconf.sim_method == "convnet"
    fields = [state_l.u, state_l.density] + ([state_l.p] if convnet else [])
    ext = exchange_ghost(fields, slab.g, slab.group)
    if convnet:
        ue, de, pe = ext
    else:
        # jacobi-n overwrites p: its ghost planes need no exchange.
        ue, de = ext
        pe = slab.embed(torch.zeros_like(ue[:, :1]), state_l.p)
    hooks = SlabStep(dx=slab.dx, z0=slab.z0, window=W,
                     input_scale=slab.input_scale,
                     polish=slab.polish_step,
                     solve=slab.pcg_solve if mconf.sim_method == "pcg"
                     else slab.jacobi_solve)
    out = _step(FluidState(u=ue, p=pe, flags=slab.flags, density=de), mconf,
                model, slab.bcs, slab.consts, use_kernels, forces,
                output_div, slab=hooks)
    return FluidState(u=slab.own(out.u).contiguous(),
                      p=slab.own(out.p).contiguous(), flags=state_l.flags,
                      density=slab.own(out.density).contiguous())


def rollout_z_sharded(state_l: FluidState, mconf: ModelConfig, n_steps: int,
                      mesh, model=None, bcs_l: Optional[Boundaries] = None,
                      save_every: int = 0, use_kernels: bool = True):
    """sim.simulate.rollout on this rank's slab of a state z-sharded over
    the mesh's 'sp' dim (and batch-split over 'dp'): state_l and bcs_l
    as shard_state and shard_bcs give them. Every rank of the mesh calls
    it. `use_kernels=False` runs every kernel's plain version.

    Returns this rank's slab of the final state; with `save_every > 0`
    also its density every `save_every` steps, stacked (n_steps //
    save_every, b, c, zl, y, x). Raises NotImplementedError on what is not
    ported (the module's note) and ValueError when a slab is shorter than
    the ghost zone."""
    if save_every > 1 and n_steps % save_every:
        raise ValueError(f"n_steps ({n_steps}) must be divisible by "
                         f"save_every ({save_every})")
    _check(state_l, mconf, model)
    forces = _resolve_forces(state_l, mconf, None, None, None, None)
    frames = []
    with torch.no_grad():
        slab = _Slab(state_l, mconf, mesh, bcs_l)
        for i in range(n_steps):
            state_l = _sharded_step(state_l, mconf, model, slab, forces,
                                    use_kernels)
            if save_every and (i + 1) % save_every == 0:
                frames.append(state_l.density)
    if save_every:
        return state_l, torch.stack(frames)
    return state_l


def simulate_z_sharded(state_l: FluidState, mconf: ModelConfig, mesh,
                       model=None, bcs_l: Optional[Boundaries] = None,
                       use_kernels: bool = True,
                       grad: bool = False) -> FluidState:
    """One sim.simulate step on this rank's slab (rollout_z_sharded with
    one step: the flags and BC masks are exchanged on every call).
    grad=True records the step for autograd: a backward through its
    result runs the exchanges' adjoints, so every rank must run it."""
    if not grad:
        return rollout_z_sharded(state_l, mconf, 1, mesh, model, bcs_l,
                                 use_kernels=use_kernels)
    _check(state_l, mconf, model)
    forces = _resolve_forces(state_l, mconf, None, None, None, None)
    with torch.enable_grad():
        slab = _Slab(state_l, mconf, mesh, bcs_l)
        return _sharded_step(state_l, mconf, model, slab, forces,
                             use_kernels)


def shard_state(state: FluidState, mesh, device=None) -> FluidState:
    """This rank's slab of a global FluidState, on `device` (else its
    device on the mesh): batch over 'dp', z over 'sp' (batch_sharding)."""
    return FluidState(**_shard(state, ("u", "p", "flags", "density"), mesh,
                               device))


def shard_bcs(bcs: Optional[Boundaries], mesh,
              device=None) -> Optional[Boundaries]:
    """This rank's slab of global Boundaries (create_plume_bcs's masks,
    built on the whole grid: they depend on the inflow's global place),
    cut as shard_state cuts the state."""
    if bcs is None:
        return None
    return Boundaries(**_shard(bcs, BC_FIELDS, mesh, device))


def _shard(obj, names, mesh, device):
    device = mesh_device(mesh) if device is None else device
    sharding = batch_sharding(mesh)
    return {k: None if getattr(obj, k) is None else
            local_part(getattr(obj, k), sharding).to(device).contiguous()
            for k in names}


def _all_gather(x, group, dim):
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = (x.cpu() if host_staged(x, group) else x).contiguous()
    bufs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(bufs, src, group=group)
    return torch.cat(bufs, dim=dim).to(x.device)


def gather_state(state_l: FluidState, mesh) -> FluidState:
    """The global FluidState from every rank's slab (z gathered over 'sp',
    batch over 'dp'), on every rank. Every rank of the mesh calls it."""
    sp, dp = mesh["sp"].get_group(), mesh["dp"].get_group()

    def gather(x):
        return None if x is None else _all_gather(_all_gather(x, sp, 2), dp,
                                                  0)
    return FluidState(u=gather(state_l.u), p=gather(state_l.p),
                      flags=gather(state_l.flags),
                      density=gather(state_l.density))
