"""Sharded PCG: the pressure solve of solvers/cg.py and the connected
components of solvers/components.py on a grid z-sharded over the mesh's
'sp' ranks. GSPMD shards the JAX package's `solve_pcg` and
`connected_components` as they stand ("shardable over a mesh, where the
dots become psums"); here every collective is spelled out.

Each rank holds a slab of zl = Z / n_sp planes (batch over 'dp', z over
'sp', as parallel/mesh.shard_batch cuts it).

  - connected_components_z_sharded: the min filter of
    solvers.components.connected_components, sweep for sweep, on labels
    that start at each fluid cell's GLOBAL linear index. A sweep is one
    exchange of a label plane with each neighbour (halo.exchange_ghost,
    one-sided at the global z ends), the filter on the grown slab, and the
    own planes kept. The fixpoint test is one all_reduce MAX over the
    whole mesh (every rank of the default group), so that every rank
    takes the same number of sweeps; the cap is the whole grid's Z + Y +
    X. So the labels equal the whole grid's exactly, even where the cap
    stops the loop before the fixpoint. (A slab labelled to its own
    fixpoint and then merged across the cuts would take fewer
    collectives, but gives other labels where the cap binds.)
  - slab_segments / component_mean_z_sharded /
    normalize_pressure_mean_z_sharded: sums per (sample, global label).
    Each rank's sorted set of segments present is all_gathered over 'sp'
    and merged into one sorted union that every rank holds alike; each
    rank sums its cells into that union in the fixed order of
    solvers.components (torch.segment_reduce over a stable sort, no
    index_add_), and one all_reduce over 'sp' adds the ranks' partial
    sums. So the sums repeat to the bit from run to run; against the
    unsharded ones they agree to rounding (another order). The union
    holds the components that meet the slab, not the (b, Z*Y*X + 1)
    dense table: a dense all_reduce would move 8 MiB a sample a call at
    128^3.
  - solve_pcg_z_sharded: solvers.cg.solve_pcg on a slab. The Laplacian's
    masks come from the flags grown by one plane (one-sided), so "out of
    the array" counts as obstacle only past the global z ends and a
    neighbour across a cut is the neighbour's cell. apply_A exchanges one
    plane of d a CG iteration. The per-sample dot products are local sums
    all_reduced over 'sp': dAd in one all_reduce, r.z with ||r||^2 in
    another. The stop test, it < max_iter and max(best_res) > tol, reads
    the max over the whole mesh (with more than one 'dp' group an
    all_reduce MAX over the default group; with one, the 'sp' sums are
    already the same bits on every rank), so that a 'dp' group whose
    samples converged first still runs the whole batch's iterations, as
    JAX's while_loop does: best_p still improves for them. An iteration
    costs 1 exchange and 2 all_reduces (3 with 'dp' groups), and every
    rank takes the same count, which the solve returns.

Every rank of the mesh calls these functions, in the same order.
"""

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.ops import stencil as st
from fluidnet_tpu_torch.parallel.halo import exchange_ghost
from fluidnet_tpu_torch.parallel.mesh import (all_reduce_max,
                                              all_reduce_sum, host_staged)
from fluidnet_tpu_torch.solvers.cg import _laplacian_masks
from fluidnet_tpu_torch.solvers.components import Segments, _segment_sum

SHIFTS = (st.xm, st.xp, st.ym, st.yp, st.zm, st.zp)


def _sp(mesh):
    """(the 'sp' group, this rank's index on it, its size)."""
    sp = mesh["sp"]
    return sp.get_group(), sp.get_local_rank(), sp.size()


def _mesh_max(x, mesh):
    """max(x) over the whole mesh as a Python float. Values all_reduced
    over 'sp' are already the same bits on every rank of an 'sp' group;
    with more than one group an all_reduce MAX over the default group
    (the mesh's ranks, make_mesh) makes them the whole mesh's."""
    m = x.max()
    if dist.get_world_size() > mesh["sp"].size():
        m = all_reduce_max(m, dist.group.WORLD)
    return m.item()


def _grown(x, group):
    """(x grown by one plane of each neighbour on `group`, one-sided at the
    global z ends; a function that crops a grown tensor to x's planes)."""
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    lo, zl = int(idx > 0), x.shape[2]
    xe, = exchange_ghost([x], 1, group)
    return xe, lambda t: t[:, :, lo:lo + zl]


def connected_components_z_sharded(flags_l, mesh, z0: int,
                                   max_iter: int = 0):
    """solvers.components.connected_components on this rank's slab
    flags_l (b, 1, zl, y, x) of a grid z-sharded over the mesh's 'sp' dim,
    whose first plane is global plane z0. Returns (int32 labels of the
    slab, sweeps): a fluid cell gets the smallest global linear index
    (z * Y + y) * X + x of its component, a non-fluid cell n = Z * Y * X;
    max_iter == 0 caps the sweeps at the grid's Z + Y + X. Every rank
    takes the same number of sweeps (an all_reduce MAX of the fixpoint
    test over the whole mesh), so the labels equal the whole grid's
    exactly. Raises ValueError past int32's labels (Z * Y * X >= 2^31)."""
    group, _, n_sp = _sp(mesh)
    b, _, zl, Y, X = flags_l.shape
    Z = zl * n_sp
    n = Z * Y * X
    if Z <= 1:
        raise ValueError("connected_components_z_sharded is for 3-D grids")
    if n >= 2 ** 31:
        raise ValueError(f"connected_components_z_sharded: {Z}x{Y}x{X} "
                         f"cells do not fit int32 labels")
    if max_iter <= 0:
        max_iter = Z + Y + X
    fl = is_fluid(flags_l)
    lin = (torch.arange(zl, dtype=torch.int32, device=flags_l.device)
           .reshape(zl, 1, 1) + int(z0)) * (Y * X) + torch.arange(
        Y * X, dtype=torch.int32, device=flags_l.device).reshape(1, Y, X)
    lin = lin.reshape(1, 1, zl, Y, X).expand(flags_l.shape)

    def sweep(lab):
        ext, own = _grown(lab, group)
        m = lab
        for sh in SHIFTS:
            m = torch.minimum(m, own(sh(ext, n)))
        return torch.where(fl, m, n)

    def changed(lab, prev):
        flag = (lab != prev).any().to(torch.int32).reshape(1)
        return all_reduce_max(flag, dist.group.WORLD).item() > 0

    prev = torch.where(fl, lin, n)
    lab = sweep(prev)
    it = 1
    while it < max_iter and changed(lab, prev):
        prev, lab = lab, sweep(lab)
        it += 1
    return lab, it


class SlabSegments(NamedTuple):
    """The components that meet this rank's slab, laid out for
    fixed-order sums across the slabs: `local`, this rank's cells by
    (sample, global label) segment, sorted (solvers.components.Segments);
    `index`, each local segment's place in `union`, the sorted segments of
    every slab of the 'sp' group (the same on every rank of it); `group`,
    that group."""
    local: Segments
    index: torch.Tensor
    union: torch.Tensor
    group: object


def _gather_sets(vals, group):
    """The sorted union of every rank's sorted int64 set `vals` on `group`
    (one all_reduce MAX of the lengths, one all_gather of the sets padded
    with -1)."""
    n = dist.get_world_size(group)
    if n == 1:
        return vals
    length = all_reduce_max(torch.tensor([vals.numel()], dtype=torch.int64,
                                         device=vals.device), group).item()
    pad = torch.full((length,), -1, dtype=torch.int64, device=vals.device)
    pad[:vals.numel()] = vals
    if host_staged(pad, group):
        pad = pad.cpu()
    bufs = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(bufs, pad, group=group)
    every = torch.cat(bufs).to(vals.device)
    return torch.unique(every[every >= 0], sorted=True)


def slab_segments(labels_l, group) -> SlabSegments:
    """The SlabSegments of this rank's labels (from
    connected_components_z_sharded) on the 'sp' `group`: computed once
    for constant flags, they sum the same components again without
    sorting or gathering."""
    b = labels_l.shape[0]
    cells = labels_l[0].numel()
    n = torch.iinfo(torch.int32).max
    seg = (labels_l.reshape(b, cells).long() +
           torch.arange(b, device=labels_l.device).reshape(b, 1) * (n + 1))
    vals, inverse, lengths = torch.unique(seg.reshape(-1), sorted=True,
                                          return_inverse=True,
                                          return_counts=True)
    union = _gather_sets(vals, group)
    local = Segments(inverse, torch.argsort(inverse, stable=True), lengths)
    return SlabSegments(local, torch.searchsorted(union, vals), union, group)


def component_mean_z_sharded(x, segs: SlabSegments, fluid_mask):
    """solvers.components.component_mean of the whole grid on this rank's
    slab: each component's mean of x over its fluid cells on every slab,
    scattered back to the slab's cells; non-fluid cells get 0. The sums
    and cell counts of each rank's cells, in the fixed order of `segs`,
    go into the union's places, and one all_reduce over 'sp' adds them:
    the same bits run after run."""
    fm = fluid_mask.reshape(-1)
    part = torch.stack([
        _segment_sum(torch.where(fm, x.reshape(-1), 0.0), segs.local),
        _segment_sum(fm.to(x.dtype), segs.local)])
    full = x.new_zeros((2, segs.union.numel()))
    full[:, segs.index] = part
    full = all_reduce_sum(full, segs.group)
    means = full[0] / full[1].clamp_min(1.0)
    return means[segs.index][segs.local.inverse].reshape(x.shape)


def normalize_pressure_mean_z_sharded(p_l, flags_l, segs: SlabSegments):
    """solvers.components.normalize_pressure_mean on this rank's slab: each
    component's mean pressure over the whole grid subtracted from its
    fluid cells. segs: the slab_segments of the flags' components."""
    fl = is_fluid(flags_l)
    return torch.where(fl, p_l - component_mean_z_sharded(p_l, segs, fl),
                       p_l)


def slab_components(flags_l, mesh, z0: int) -> SlabSegments:
    """The slab_segments of the connected components of the grid whose
    slab this rank holds (flags_l, first plane z0)."""
    labels, _ = connected_components_z_sharded(flags_l, mesh, z0)
    return slab_segments(labels, mesh["sp"].get_group())


def solve_pcg_z_sharded(flags_l, div_l, mesh, z0: int, tol: float = 1e-4,
                        max_iter: int = 100, precond: str = "jacobi",
                        remove_null_space: bool = True,
                        labels: Optional[SlabSegments] = None,
                        flags_ext=None):
    """solvers.cg.solve_pcg on this rank's slab (flags_l, div_l: (b, 1, zl,
    y, x), first plane global plane z0) of a grid z-sharded over the
    mesh's 'sp' dim. `labels`: the slab_components of the flags (a
    rollout computes them once), None computes them here; `flags_ext`:
    the flags grown by one plane of each neighbour (one-sided at the
    global ends), None exchanges them here.

    Returns (this rank's slab of p, the residual: the max over the whole
    batch of the best iterate's ||r||_2 as a 0-d tensor, the iteration
    count), the count the same on every rank of the mesh."""
    if precond not in ("jacobi", "none"):
        raise ValueError(f"bad precond {precond!r}")
    group, idx, n_sp = _sp(mesh)
    zl = div_l.shape[2]
    if div_l.dim() != 5 or zl * n_sp <= 1:
        raise ValueError("solve_pcg_z_sharded is for 3-D grids (b, 1, z, "
                         "y, x) with z > 1")
    if flags_l.shape != div_l.shape:
        raise ValueError(f"solve_pcg_z_sharded: flags "
                         f"{tuple(flags_l.shape)} do not match div "
                         f"{tuple(div_l.shape)}")
    lo = int(idx > 0)
    if flags_ext is None:
        flags_ext, = exchange_ghost([flags_l], 1, group)
    elif flags_ext.shape[2] != zl + lo + int(idx < n_sp - 1):
        raise ValueError(f"solve_pcg_z_sharded: flags_ext has "
                         f"{flags_ext.shape[2]} z-planes, expected the "
                         f"slab grown by 1")

    def own(t):
        return t[:, :, lo:lo + zl]
    fl_e, diag_e, nbr_e, shifts = _laplacian_masks(flags_ext, True)
    fl, diag = own(fl_e), own(diag_e)
    nbr_fluid = [own(m) for m in nbr_e]

    def apply_A(d):
        de, _ = _grown(d, group)
        off = torch.zeros_like(d)
        for sh, nf in zip(shifts, nbr_fluid):
            off = off + torch.where(nf, own(sh(de)), 0.0)
        return torch.where(fl, diag * d - off, 0.0)

    b = div_l.shape[0]

    def dots(*pairs):
        """Per-sample dot products of the whole grid: the slab's sums, all
        of them in one all_reduce over 'sp'."""
        local = torch.stack([(x * y).reshape(b, -1).sum(dim=1)
                             for x, y in pairs])
        return all_reduce_sum(local, group).unbind(0)

    rhs = torch.where(fl, div_l, 0.0)
    if remove_null_space:
        if labels is None:
            labels = slab_components(flags_l, mesh, z0)
        n_fluid_nbrs = sum(nf.to(torch.float32) for nf in nbr_fluid)
        nonsing_cell = fl & (diag > n_fluid_nbrs)
        has_dirichlet = component_mean_z_sharded(
            nonsing_cell.to(torch.float32), labels, fl) > 0.0
        mean_rhs = component_mean_z_sharded(rhs, labels, fl)
        rhs = torch.where(fl & ~has_dirichlet, rhs - mean_rhs, rhs)

    if precond == "jacobi":
        inv_diag = torch.where(fl & (diag > 0),
                               1.0 / torch.clamp_min(diag, 1.0), 0.0)

        def M(r):
            return inv_diag * r
    else:
        def M(r):
            return torch.where(fl, r, 0.0)

    bshape = (b, 1, 1, 1, 1)
    p = torch.zeros_like(div_l)
    r = rhs
    z = M(r)
    d = z
    rz, rr = dots((r, z), (r, r))
    best_p = p
    best_res = torch.sqrt(rr)
    it = 0
    while it < max_iter and _mesh_max(best_res, mesh) > tol:
        Ad = apply_A(d)
        dAd, = dots((d, Ad))
        alpha = torch.where(dAd > 0, rz / torch.where(dAd > 0, dAd, 1.0),
                            0.0)
        al = alpha.reshape(bshape)
        p = p + al * d
        r = r - al * Ad
        z = M(r)
        rz_new, rr = dots((r, z), (r, r))
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                           0.0)
        d = z + beta.reshape(bshape) * d
        rz = rz_new
        res = torch.sqrt(rr)
        best_p = torch.where((res < best_res).reshape(bshape), p, best_p)
        best_res = torch.minimum(res, best_res)
        it += 1
    p = best_p

    if remove_null_space:
        p = torch.where(fl, p - component_mean_z_sharded(p, labels, fl), p)
    return p, p.new_tensor(_mesh_max(best_res, mesh)), it
