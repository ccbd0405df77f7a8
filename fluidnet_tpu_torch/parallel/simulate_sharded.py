"""The whole simulation step on a grid z-sharded over the mesh's 'sp'
ranks: what GSPMD gives the JAX package for inference (simulate / rollout
on a z-sharded state, tests/test_parallel.py:137-194), spelled out.

Each rank holds a slab of zl = Z / n_sp planes of every field (batch over
'dp', z over 'sp': `shard_state`, `shard_bcs`). A step:

  1. the advection window from the grid's max|u| (one all_reduce MAX, only
     with adaptive_window and advection_window > 1), so that every rank
     takes the same W; at advection_window 0 the ghost zone G from the
     grid's max|u_z| where it depends on the data (below; one all_reduce
     MAX);
  2. one exchange (`halo.exchange_ghost`) extends u, density (when the
     state has one) and, for the ConvNet, p by the ghost zone of G planes
     on each side, from as many ranks as G needs, and by nothing past the
     global z ends;
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
index clamps), and each conv of the trunk zero-pads z at the global ends
as the whole grid does. A slab's own ends lie inside the ghost zone: what
the positional tests and the zero pads spoil there reaches at most G
planes in and is cropped away.

The ghost zone G is the sum of the stencil radii of one step before its
Jacobi solves (`ghost_planes`): the advection's reach (`advection_reach`:
2W + 2 at the largest window W mconf allows; window 0 below), K2's halo
of 4 (the prologue, or the forces block; without density gravity and K4,
the same reach), then
for the ConvNet the trunk's reach (`trunk_reach`) and the model's velocity
update and setWallBcs (2), for jacobi-n and PCG the setWallBcs and the
divergence (2). For the ConvNet G is rounded up to a multiple of the
trunk's pooling factor F (`pool_factor`), and a slab's own length zl must
be one too: then every extended slab starts on a multiple of F (or on 0,
and ends on Z, at the global ends), so each pool window, mres pyramid
level and pixel shuffle block of the slab's trunk covers the planes it
covers on the whole grid. Off alignment the slab's trunk pools other
planes together, and its own planes differ from the whole grid's by the
field's scale, however wide G. G: 13 planes for the default 8-8-8-8-1
model at W = 1 (reach 3, F 1), 28 for tog at W = 1 or 2 (reach 16, F 4),
16 for a two-bank mres model at W = 1 (reach 6, F 2), 10 for jacobi-n
and PCG.

The exact route's reach (advection_window 0: ops/advect.py, plain
PyTorch at the slab's z origin), walked through what it reads, trace by
trace, d the grid's dt max|u_z| (every displacement's z part is at most d:
the centred and face velocities average u):
  - a line trace (the *Ours methods) marches TRACE_STEPS = 8 steps of at
    most one cell (simulate never passes max_trace_steps; a back-off or
    the border intersection only moves a point back along the ray, the
    domain clamp back into the domain), so a ray ends within 8 planes of
    its cell's centre, and the interpolation there reads the corner planes
    floor(p - 0.5) and one above: 9 planes (its direction reads u one plane
    away, within them);
  - eulerOurs: one trace, 9. maccormackOurs: the backward trace
    interpolates the forward's result, 2 x 9 = 18; the scalar clamp reads
    the 3^3 window around the forward's traced cell (9), the velocity
    clamp the 2x2x2 corners around trunc(k -/+ dt u_mac), not line traced:
    floor(d) + 1 <= ceil(d) + 1. rk2Ours and rk3Ours trace every step
    from the cell centre (9); their velocity is maccormackOurs's. So
    max(18, ceil(d) + 1), which d moves only past 17;
  - Manta's euler traces p - dt u with no step limit: ceil(d) + 1;
    maccormack twice that (the backward trace over the forward's result;
    its clamp and obstacle lookups read ceil(d) + 1).
Where the reach depends on d (window 0, all but eulerOurs), each step
takes d from an all_reduce MAX of every rank's own max|u_z| (so every rank
exchanges the same G) and G = ghost_planes(mconf, d), at most (n - 1) zl
(then every rank holds the whole grid). The flags and BC masks are
extended once, at the rollout's start, to that widest reach, the whole
grid (the flags 8 MiB a rank at 128^3), so no step exchanges them again.
G at window 0 while d <= 17: 27 for the default model, 40 for tog, 24 for
jacobi-n and PCG. The traces' 18 are loose by the zero-weight corner: a
ray of 8 whole planes in z lands on a corner with weight 1 and reads the
next with weight 0, so what maccormackOurs's two traces read with weight
lies 16 planes away; the velocity clamp's bound is met at a whole d
(tests/test_torch_sharded_exact.py probes both).

A G wider than a slab's zl planes (tog at window 0 on 32 planes, small
slabs, Manta's methods at a large d) takes planes from as many ranks as
it needs (halo._hops), still one batch of sends and receives, and its
adjoint sends each plane's cotangent back to its owner.

The trunk's reach is how many planes at full resolution one output plane
of the trunk reads on each side, walked from the layer spec and the bank
structure as models.fluidnet.FluidNet._stages_path runs them: a conv of
radius r and dilation d at a level whose planes each cover f planes adds
r d f; a pool or the mres pyramid's pool adds nothing but multiplies f by
its size; a pixel shuffle or the mres join's nearest upsampling from f to
f' adds f - f' (a plane reads the whole coarse plane that holds it); the
skip concat and batch norm (eval-mode, pointwise: fault F11) add nothing;
banks take the widest. It is an upper bound that the trunk meets at some
plane within F of any other (tests/test_torch_sharded_models.py probes
it): the default 3, tog 16, mres with 2 and 3 banks 6 and 12, dilate 5
and 9.

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

A state without density takes sim.simulate's unfused route on the slab
(K1's unfused velocity sweep, gravity and K4, the ConvNet with the slab's
input scale, or the slab solvers), with no plume BCs (create_plume_bcs
needs density). 2-D states are refused (NotImplementedError): JAX's
spatial sharding splits axis 2, which a 2-D state holds at one plane.

Training: under autograd (`simulate_z_sharded(grad=True)`, the unroll of
parallel/train_sharded.py) the same step records its graph on the slab.
The exchanges and the input scale's all_reduces are differentiable
(halo.exchange_ghost, mesh.all_reduce_sum): the backward sends each ghost
plane's cotangent to the rank that owns the plane, and sums the input
scale's cotangents over the ranks. The kernels keep their gradient rules
on the slab (ops/replay.py for K1's fused sweeps and K2 with the grid's
dx; K1's unfused sweeps, whose backward is K6).
"""

import math
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

# The line trace's march steps on the exact route: simulate() never passes
# max_trace_steps (ops/advect.py's default).
TRACE_STEPS = 8
BC_FIELDS = ("u_bc", "u_bc_inv_mask", "p_bc", "p_bc_inv_mask", "density_bc",
             "density_bc_inv_mask")


def _trunk_walk(mconf: ModelConfig):
    """(trunk_reach, pool_factor): the layer spec and the banks walked as
    FluidNet._stages_path runs them, each bank with its reach so far and
    the planes at full resolution that one of its planes covers."""
    _, ksize, psize, usize = layer_spec(mconf)
    nb = mconf.banks_num
    banks, peak = [(0, 1)], 1
    for lid in range(len(ksize)):
        if nb > 1 and lid + 1 == mconf.banks_split_stage:
            r, f = banks[0]
            banks = [(r, f * 2 ** ib if mconf.banks_type == "mres" else f)
                     for ib in range(nb)]
        if nb > 1 and lid + 1 == mconf.banks_join_stage:
            f0 = banks[0][1]
            banks = [(max(r + f - f0 for r, f in banks), f0)]
        grown = []
        for ib, (r, f) in enumerate(banks):
            dil = 2 ** ib if mconf.banks_type == "dilate" and \
                usize[lid] == 1 else 1
            r += (ksize[lid] - 1) // 2 * dil * f
            if usize[lid] > 1:
                r, f = r + f - f // usize[lid], f // usize[lid]
            grown.append((r, f * psize[lid]))
            peak = max(peak, f * psize[lid])
        banks = grown
    (r, _), = banks
    return r, peak


def trunk_reach(mconf: ModelConfig) -> int:
    """The planes at full resolution that one output plane of the trunk
    reads on each side: an upper bound (the module's note)."""
    return _trunk_walk(mconf)[0]


def pool_factor(mconf: ModelConfig) -> int:
    """F, the planes at full resolution that one plane of the trunk's
    coarsest level covers: the stage pools times 2^(banks - 1) for mres
    banks (tog 4, a two-bank mres model 2, dilate banks and the default
    model 1)."""
    return _trunk_walk(mconf)[1]


def _round_up(n: int, f: int) -> int:
    return -(-n // f) * f


def advection_reach(mconf: ModelConfig, d: float = 0.0) -> int:
    """The planes one output plane of the advection reads on each side
    (the module's note): 2W + 2 at the largest window W >= 1 mconf allows;
    at window 0 walked through the exact route, `d` the grid's dt
    max|u_z| (a bound of every displacement's z part)."""
    W = mconf.advection_window
    if W:
        return 2 * W + 2
    plain = math.ceil(d) + 1
    method = mconf.advection_method
    if method == "euler":
        return plain
    if method == "maccormack":
        return 2 * plain
    trace = TRACE_STEPS + 1
    if method == "eulerOurs":
        return trace
    # maccormackOurs, and the velocity of rk2Ours and rk3Ours.
    return max(2 * trace, plain)


def reach_of_data(mconf: ModelConfig) -> bool:
    """Whether advection_reach depends on d: window 0, every method but
    eulerOurs (whose traces are line traced and whose velocity has no
    clamp)."""
    return not mconf.advection_window and \
        mconf.advection_method != "eulerOurs"


def ghost_planes(mconf: ModelConfig, d: float = 0.0) -> int:
    """G, the planes a step's exchange adds on each side: the stencil
    radii of the step before its Jacobi solves, the advection's at the
    largest window mconf allows (at window 0 with the grid's dt max|u_z|
    = d); for the ConvNet rounded up to a multiple of pool_factor."""
    advection = advection_reach(mconf, d)
    if mconf.sim_method == "convnet":
        return _round_up(advection + K2_HALO + trunk_reach(mconf) + 2,
                         pool_factor(mconf))
    return advection + K2_HALO + 2


def check_aligned(zl: int, mconf: ModelConfig):
    """Raises ValueError unless a slab's own length zl is a multiple of
    the model's pooling factor (the module's note)."""
    f = pool_factor(mconf)
    if zl % f:
        raise ValueError(
            f"shard z-length {zl} is not a multiple of model "
            f"{mconf.model_type!r}'s pooling factor {f} (banks "
            f"{mconf.banks_num}): the slab's pool windows would not align "
            f"with the whole grid's (use another number of sp shards)")


def _check(state_l: FluidState, mconf: ModelConfig, model):
    """Refuses what the sharded step cannot run."""
    _check_slice(state_l, mconf, model)
    if not state_l.is_3d:
        raise NotImplementedError(
            "the z-sharded step is 3-D: the JAX package's spatial sharding "
            "splits axis 2 (fluidnet_tpu/parallel/mesh.py:37-39), which a "
            "2-D state holds at one plane, so there is no z to split")


class _Slab:
    """This rank's slab of the grid for one rollout: its place, the
    ghost zones, and the flags and BC masks extended once to the widest
    reach a step can need (G, the polish's n + 2, jacobi-n's h; the whole
    grid where G depends on the data), or `reach` if wider (one-sided at
    the global ends, at most the planes that lie beyond). `at(g)` sets a
    step's ghost zone."""

    def __init__(self, state_l, mconf, mesh, bcs_l, reach: int = 0):
        sp = mesh["sp"]
        self.mesh, self.group = mesh, sp.get_group()
        idx, self.n = sp.get_local_rank(), sp.size()
        self.zl = zl = state_l.u.shape[2]
        Y, X = state_l.u.shape[3:]
        self.Z = zl * self.n
        self.dx = get_dx((self.Z, Y, X))
        # The global index of the own slab's first plane; past (n - 1) zl
        # planes on each side a slab holds the whole grid.
        self.z_own, self.cap = idx * zl, (self.n - 1) * zl
        self.mconf, self.of_data = mconf, reach_of_data(mconf)
        self.g_min = min(ghost_planes(mconf), self.cap)
        self.polish = mconf.polish_iters + 2 \
            if mconf.sim_method == "convnet" and mconf.polish_iters > 0 \
            else 0
        self.solve_h = min(mconf.max_iter, zl) \
            if mconf.sim_method == "jacobi" else 0
        self.reach = min(max(self.g_min, self.polish, self.solve_h, reach,
                             self.cap * self.of_data), self.cap)
        if mconf.sim_method == "convnet":
            check_aligned(zl, mconf)
        names = [k for k in BC_FIELDS
                 if bcs_l is not None and getattr(bcs_l, k) is not None]
        ext = exchange_ghost(
            [state_l.flags] + [getattr(bcs_l, k) for k in names],
            self.reach, self.group)
        self.flags_reach = ext[0]
        self.bcs_reach = None if bcs_l is None else dict(zip(names, ext[1:]))
        self._cut = {}
        self.at(self.g_min)
        # PCG's components depend on the flags alone: labelled once.
        self.labels = slab_components(state_l.flags, mesh, self.z_own) \
            if mconf.sim_method == "pcg" else None

    def lo(self, g: int) -> int:
        """The planes a ghost zone of g adds below the own slab."""
        return min(g, self.z_own)

    def hi(self, g: int) -> int:
        """The planes a ghost zone of g adds above the own slab."""
        return min(g, self.Z - self.z_own - self.zl)

    def at(self, g: int):
        """Sets this step's ghost zone of g planes: the extended slab's z
        origin, and the flags, BC masks and flag constants cut to it."""
        self.g, self.z0 = g, self.z_own - self.lo(g)
        if g not in self._cut:
            self._cut[g] = (
                self.crop(self.flags_reach, self.reach, g).contiguous(),
                None if self.bcs_reach is None else Boundaries(**{
                    k: self.crop(x, self.reach, g).contiguous()
                    for k, x in self.bcs_reach.items()}),
                FlagConsts())
        self.flags, self.bcs, self.consts = self._cut[g]

    def step_ghost(self, u_l, dt) -> int:
        """G for a step from this rank's own planes of u: the fixed G, or
        where it depends on the data, from the grid's dt max|u_z| (an
        all_reduce MAX over the ranks, so every rank takes the same G),
        at most the whole grid."""
        if not self.of_data:
            return self.g_min
        vz = all_reduce_max(u_l.detach()[:, 2].abs().max(), self.group)
        d = float(vz) * float(torch.as_tensor(dt).abs().max())
        return min(ghost_planes(self.mconf, d), self.cap)

    def crop(self, x, have: int, want: int):
        """x, this rank's slab extended by `have` planes (one-sided),
        cut to the slab extended by `want` <= have."""
        start = self.lo(have) - self.lo(want)
        return x[:, :, start:start + self.zl + self.lo(want) +
                 self.hi(want)]

    def own(self, x):
        """This rank's own planes of a G-extended slab."""
        return self.crop(x, self.g, 0)

    def embed(self, x, part):
        """The G-extended slab x with its own planes replaced by part."""
        lo = self.lo(self.g)
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
    the forces, as the unsharded step does. A state without density
    exchanges and returns none."""
    W = step_window(mconf, state_l.u, forces.dt, slab.group)
    slab.at(slab.step_ghost(state_l.u, forces.dt))
    convnet = mconf.sim_method == "convnet"
    has_d = state_l.density is not None
    fields = [state_l.u] + ([state_l.density] if has_d else []) + \
        ([state_l.p] if convnet else [])
    ext = iter(exchange_ghost(fields, slab.g, slab.group))
    ue = next(ext)
    de = next(ext) if has_d else None
    # jacobi-n and PCG overwrite p: its ghost planes need no exchange.
    pe = next(ext) if convnet else \
        slab.embed(torch.zeros_like(ue[:, :1]), state_l.p)
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
                      density=slab.own(out.density).contiguous()
                      if has_d else None)


def rollout_z_sharded(state_l: FluidState, mconf: ModelConfig, n_steps: int,
                      mesh, model=None, bcs_l: Optional[Boundaries] = None,
                      save_every: int = 0, use_kernels: bool = True):
    """sim.simulate.rollout on this rank's slab of a state z-sharded over
    the mesh's 'sp' dim (and batch-split over 'dp'): state_l and bcs_l
    as shard_state and shard_bcs give them. Every rank of the mesh calls
    it. `use_kernels=False` runs every kernel's plain version.

    Returns this rank's slab of the final state; with `save_every > 0`
    also its density every `save_every` steps, stacked (n_steps //
    save_every, b, c, zl, y, x). Raises NotImplementedError on a 2-D state
    (the module's note) and, with the ConvNet, ValueError when a slab's
    length is not a multiple of the model's pooling factor."""
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
