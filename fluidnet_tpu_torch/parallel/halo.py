"""Explicit halo exchange over a z-sharded grid, and the halo Jacobi.

Port of fluidnet_tpu.parallel.halo: the scale-out answer to the
reference's single-GPU Jacobi solver (generic/tfluids.cu:1764-1926). The
grid's z axis is split over the mesh's 'sp' dim; every rank holds a slab
of zl = Z / n_sp planes, and every sweep exchanges one z-plane with each
neighbour (SURVEY.md §5.8: halos for domain decomposition). Where JAX
runs `ppermute` inside a `shard_map`, each rank here posts its sends and
receives with `dist.batch_isend_irecv` on the 'sp' group
(`exchange_z_planes`), staged through the host under gloo
(parallel/mesh.host_staged).

`halo_jacobi_solve` is plain PyTorch, as the JAX function is plain jnp:
every sweep is solvers/cuda_jacobi.jacobi_update, the combine of K3's plain
version, on neighbour planes that come from the exchange at the slab ends.
The masks JAX builds on the global array before sharding come from one
exchange of a flags plane: the neighbour-obstacle masks from the extended
slab, the zero mask from the global z index (`global_border_mask`). So a
sharded solve adds the same numbers in the same order as jacobi_plain on
the whole grid, and equals it to the bit.

`slab_jacobi_solve` is the same solve on K3, in rounds of ghost zones: the
slab grown by h = min(n, zl) planes of each neighbour (one-sided at the
global ends), K3 for at most h sweeps on it from the p the rounds before
reached, the own planes kept. K3 zeroes the grown slab's end planes as
border; what that spoils moves one plane a sweep, so after h sweeps it
has not reached the own planes, which equal jacobi_plain on the whole grid
to the bit. Exchanges a solve: 1 + (rounds - 1), against n + 1 here.

`exchange_ghost` is the one-sided form the whole sharded step uses
(parallel/simulate_sharded.py): a slab grows by g planes on each side and
by nothing past the domain ends, so every extended slab is a contiguous
range of the whole grid. `exchange_z_planes` fills zeros past the ends,
as JAX's ppermute halos do (parallel/advect_sharded.py). Both reach past
the next rank when g exceeds a slab's zl planes: the planes come from
the ranks 1, 2, ... places away, each rank's whole slab but the
farthest's (`_hops`), in the same one batch of sends and receives.

Both are differentiable, as JAX's ppermute is: under autograd the
backward runs the exchange's adjoint (`planes_adjoint`), which sends the
cotangent of each received plane back to the rank that owns it, where it
adds into that rank's own planes; nothing crosses the grid's ends. The
backward is a collective too: every rank of the group must run it, and
the ranks post their sends and receives in the forward's order.

Both run in the span parallel.exchange (utils/profiler.span), and every
send adds its bytes to utils/profiler.exchange_bytes["sent"].
"""

import torch
import torch.distributed as dist

from fluidnet_tpu_torch.core.celltype import is_obstacle
from fluidnet_tpu_torch.ops import stencil as st
from fluidnet_tpu_torch.parallel.mesh import host_staged
from fluidnet_tpu_torch.solvers.cuda_jacobi import (jacobi_cuda,
                                                    jacobi_plain,
                                                    jacobi_update)
from fluidnet_tpu_torch.utils import profiler


def _hops(h: int, zl: int):
    """[(k, m)]: the h planes just beyond a slab of zl planes, as the m
    planes that come from the rank k places away, k = 1, 2, ...: zl from
    every rank but the farthest, which gives the rest."""
    return [(k, min(zl, h - (k - 1) * zl))
            for k in range(1, -(-h // zl) + 1)]


def _swap(sends, group):
    """For each (k, down, up) of `sends` ((b, c, m, y, x) tensors): (from_
    below, from_above), what the rank k places before this one on `group`
    sent up and what the rank k places after it sent down, None past the
    mesh ends (nothing is sent there); on the host when the collective
    stages through it. One batch of sends and receives for all.

    Matching: gloo pairs a send with a receive by tag, NCCL ignores tags
    and pairs the i-th send from rank a to rank b with the i-th receive
    on b from a, in posting order. Both hold here: two ranks k places
    apart exchange only through the entries of hop k, and every rank of
    the group walks the same `sends` list (the same hops, and pieces of
    the same shapes and dtypes: slabs of one zl), so a's i-th send to b
    is b's i-th receive from a (tests/test_torch_parallel_order.py
    delivers NCCL's way). Every rank of a group of two or more has a
    neighbour and posts; a group of one posts nothing, so no rank skips
    a batch the others post (NCCL's first batch on a group needs them
    all)."""
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    out, ops = [], []
    for tag, (k, *pair_send) in enumerate(sends):
        pair = []
        for peer, send in zip((idx - k, idx + k), pair_send):
            recv = None
            if 0 <= peer < n:
                dev = torch.device("cpu") if host_staged(send, group) \
                    else send.device
                recv = torch.empty(send.shape, dtype=send.dtype, device=dev)
                rank = dist.get_global_rank(group, peer)
                send = send.to(dev).contiguous()
                profiler.exchange_bytes["sent"] += \
                    send.numel() * send.element_size()
                ops += [dist.P2POp(dist.isend, send, rank, group, tag),
                        dist.P2POp(dist.irecv, recv, rank, group, tag)]
            pair.append(recv)
        out.append(pair)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _joined(pieces, ms, like):
    """One side's received pieces (None: no rank there), of ms planes
    each, joined along z on like's device, zeros for the missing ones;
    None when no rank lies on that side."""
    if all(t is None for t in pieces):
        return None
    return torch.cat([
        torch.zeros(like.shape[:2] + (m,) + like.shape[3:], dtype=like.dtype,
                    device=like.device) if t is None else t.to(like.device)
        for t, m in zip(pieces, ms)], dim=2)


def _swap_planes(xs, h: int, group):
    """For each (b, c, zl, y, x) tensor of `xs`: (lo, hi), the h z-planes
    just below this rank's slab on `group` and just above it, from as many
    ranks on each side as h needs (`_hops`: a rank's whole slab from each
    but the farthest), zeros where they would lie past the mesh ends, None
    when no rank lies on that side; on x's device. One batch of sends and
    receives for all."""
    hops = [_hops(h, x.shape[2]) for x in xs]
    got = iter(_swap([(k, x[:, :, :m], x[:, :, x.shape[2] - m:])
                      for x, hs in zip(xs, hops) for k, m in hs], group))
    out = []
    for x, hs in zip(xs, hops):
        pairs = [next(got) for _ in hs]
        ms = [m for _, m in hs]
        # Below, the farthest rank's planes come first.
        out.append([_joined([d for d, _ in pairs][::-1], ms[::-1], x),
                    _joined([u for _, u in pairs], ms, x)])
    return out


def planes_adjoint(shapes, grads, h: int, group, like):
    """The adjoint of exchange_z_planes on slabs of `shapes`: grads[i]
    holds the cotangents (g_lo, g_hi) of the h planes slab i received
    from below and from above (None past the mesh ends). Each rank's
    piece goes back to it (`_hops`), and it adds what it gets into its own
    bottom or top planes. One batch of sends and receives for all.
    Returns [each slab's cotangent], of like's dtype and device."""
    sends = []
    for shape, (g_lo, g_hi) in zip(shapes, grads):
        zl = shape[2]
        for k, m in _hops(h, zl):
            end, start = h - (k - 1) * zl, (k - 1) * zl
            sends.append((k, None if g_lo is None else g_lo[:, :, end - m:end],
                          None if g_hi is None else
                          g_hi[:, :, start:start + m]))
    got = iter(_swap(sends, group))
    out = []
    for shape in shapes:
        g = torch.zeros(shape, dtype=like.dtype, device=like.device)
        for _, m in _hops(h, shape[2]):
            down, up = next(got)
            if down is not None:
                g[:, :, :m] += down.to(like.device)
            if up is not None:
                g[:, :, shape[2] - m:] += up.to(like.device)
        out.append(g)
    return out


def _filled(xs, h: int, group):
    """[lo, hi] of each slab of `xs` (_swap_planes), zeros past the mesh
    ends, in one flat list."""
    out = []
    for x, pair in zip(xs, _swap_planes(xs, h, group)):
        shape = x.shape[:2] + (h,) + x.shape[3:]
        out += [torch.zeros(shape, dtype=x.dtype, device=x.device)
                if t is None else t for t in pair]
    return out


class _Exchange(torch.autograd.Function):
    """exchange_z_planes under autograd. The backward posts a send and a
    receive to each rank the forward exchanged with, for every slab on
    every rank, in the forward's order, whatever reached the cotangents (a
    cotangent that autograd leaves out arrives as zeros): the ranks' lists
    of sends and receives must pair."""

    @staticmethod
    def forward(ctx, h, group, *xs):
        ctx.h, ctx.group = h, group
        ctx.shapes = [x.shape for x in xs]
        return tuple(_filled(xs, h, group))

    @staticmethod
    def backward(ctx, *gs):
        idx = dist.get_rank(ctx.group)
        n = dist.get_world_size(ctx.group)
        grads = [(gs[2 * i] if idx > 0 else None,
                  gs[2 * i + 1] if idx < n - 1 else None)
                 for i in range(len(ctx.shapes))]
        return (None, None) + tuple(planes_adjoint(ctx.shapes, grads, ctx.h,
                                                   ctx.group, gs[0]))


def exchange_z_planes(xs, h: int, group):
    """For each (b, c, zl, y, x) tensor of `xs`: (lo, hi), the h z-planes
    just below this rank's slab (the top planes of the ranks before it on
    `group`) and just above (the bottom planes of the ranks after it),
    from as many ranks as h needs (h > zl reaches past the next one);
    zeros past the mesh ends. One batch of sends and receives for all.
    Differentiable: under autograd the cotangents of (lo, hi) go back to
    the ranks that own those planes, one batch of sends and receives in
    the backward (every rank must then run the backward)."""
    with profiler.span("parallel.exchange"):
        return _z_planes(xs, h, group)


def _z_planes(xs, h: int, group):
    """exchange_z_planes outside its span."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        out = _Exchange.apply(h, group, *xs)
    else:
        out = _filled(xs, h, group)
    return [tuple(out[2 * i:2 * i + 2]) for i in range(len(xs))]


def exchange_ghost(xs, g: int, group):
    """Each (b, c, zl, y, x) slab of `xs` (every rank's of the same zl)
    extended by the g z-planes beyond each of its ends on `group`, from as
    many ranks as g needs, and by nothing past the global domain ends: a
    rank near an end grows by min(g, the planes beyond it) there, so every
    extended slab is a contiguous range of the whole grid and a positional
    border test on it falls where it falls on the whole grid. One batch of
    sends and receives for all; differentiable as exchange_z_planes (the
    adjoint adds the ghost planes' cotangents into their owners' own
    planes; the grid's ends stay one-sided). Returns [the extended
    slabs]."""
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    out = []
    with profiler.span("parallel.exchange"):
        for x, (lo, hi) in zip(xs, _z_planes(xs, g, group)):
            zl = x.shape[2]
            below, above = min(g, idx * zl), min(g, (n - 1 - idx) * zl)
            out.append(torch.cat([lo[:, :, g - below:], x,
                                  hi[:, :, :above]], dim=2))
    return out


def global_border_mask(shape, z_len_global: int, z0_global: int,
                       device=None) -> torch.Tensor:
    """Width-1 domain border of a local 3-D slab of `shape` (b, c, zl, y,
    x) whose first plane is global plane z0_global: the x/y edges are
    local (unsharded axes); the z edge is where the GLOBAL index is 0 or
    z_len_global - 1 (a slab's own ends are halo or neighbours, not
    border). Bool (1, 1, zl, y, x)."""
    Zl, Y, X = (int(v) for v in shape[2:])
    xi = torch.arange(X, device=device).view(1, 1, 1, 1, X)
    yi = torch.arange(Y, device=device).view(1, 1, 1, Y, 1)
    zg = torch.arange(Zl, device=device).view(1, 1, Zl, 1, 1) + \
        int(z0_global)
    border = (xi == 0) | (xi == X - 1) | (yi == 0) | (yi == Y - 1) | \
        (zg == 0) | (zg == z_len_global - 1)
    return border.expand(1, 1, Zl, Y, X)


def halo_jacobi_solve(flags_l, div_l, mesh, n_iter: int = 100):
    """Jacobi pressure solve on this rank's z-slab of a grid z-sharded
    over the mesh's 'sp' dim: n_iter sweeps from p = 0, one plane
    exchanged with each neighbour a sweep. flags_l (b, 1, zl, y, x) int32
    and div_l (b, 1, zl, y, x) float32 are this rank's slabs (what
    shard_batch or local_part gives; they raise when Z does not divide over
    sp). 3-D only. Returns this rank's slab of p."""
    sp = mesh["sp"]
    group, n, idx = sp.get_group(), sp.size(), sp.get_local_rank()
    zl = div_l.shape[2]
    Z = zl * n
    if div_l.dim() != 5 or Z <= 1:
        raise ValueError("halo_jacobi_solve is for 3-D grids (b, 1, z, y, "
                         "x) with z > 1")
    if flags_l.shape != div_l.shape:
        raise ValueError(f"halo_jacobi_solve: flags {tuple(flags_l.shape)} "
                         f"do not match div {tuple(div_l.shape)}")
    (f_lo, f_hi), = exchange_z_planes([flags_l], 1, group)
    ob_ext = is_obstacle(torch.cat([f_lo, flags_l, f_hi], dim=2))
    ob = ob_ext[:, :, 1:-1]
    zero = global_border_mask(div_l.shape, Z, idx * zl, div_l.device) | ob
    obs_nb = [st.xm(ob, False), st.xp(ob, False), st.ym(ob, False),
              st.yp(ob, False), ob_ext[:, :, :-2], ob_ext[:, :, 2:]]
    masks = (zero, obs_nb, torch.tensor(6.0, device=div_l.device))
    p = torch.zeros_like(div_l)
    for _ in range(n_iter):
        (lo, hi), = exchange_z_planes([p], 1, group)
        shifted = [st.xm(p), st.xp(p), st.ym(p), st.yp(p),
                   torch.cat([lo, p[:, :, :-1]], dim=2),
                   torch.cat([p[:, :, 1:], hi], dim=2)]
        p = jacobi_update(p, div_l, shifted, masks)
    return p


def slab_jacobi_solve(flags_l, div_l, mesh, n_iter: int,
                      use_kernels: bool = True, flags_ext=None):
    """The Jacobi solve of halo_jacobi_solve (n_iter sweeps from p = 0 on
    this rank's z-slab of a grid z-sharded over the mesh's 'sp' dim) in
    rounds on K3: one exchange grows div (and the flags, unless
    `flags_ext` holds them grown so) by h = min(n_iter, zl) planes of
    each neighbour, one-sided at the global z ends; then each round runs
    K3 for min(h, the sweeps left) sweeps on the grown slab from the p so
    far (0 in round 1, then this rank's p grown by one exchange of h
    planes) and keeps the own planes. Every sweep a round runs moves the
    grown slab's fake border one plane further in, and h planes lie
    between it and the own planes: they equal jacobi_plain on the whole
    grid to the bit. `use_kernels=False` runs jacobi_plain in each round,
    with the same bits. Returns this rank's slab of p."""
    sp = mesh["sp"]
    group, n, idx = sp.get_group(), sp.size(), sp.get_local_rank()
    zl = div_l.shape[2]
    if div_l.dim() != 5 or zl * n <= 1:
        raise ValueError("slab_jacobi_solve is for 3-D grids (b, 1, z, y, "
                         "x) with z > 1")
    if flags_l.shape != div_l.shape:
        raise ValueError(f"slab_jacobi_solve: flags {tuple(flags_l.shape)} "
                         f"do not match div {tuple(div_l.shape)}")
    if n_iter <= 0:
        return torch.zeros_like(div_l)
    h = min(n_iter, zl)
    lo = h * (idx > 0)
    grown = zl + h * ((idx > 0) + (idx < n - 1))
    if flags_ext is None:
        de, fe = exchange_ghost([div_l, flags_l], h, group)
    else:
        if flags_ext.shape[2] != grown:
            raise ValueError(f"slab_jacobi_solve: flags_ext has "
                             f"{flags_ext.shape[2]} z-planes, expected "
                             f"{grown} (the slab grown by {h})")
        de, = exchange_ghost([div_l], h, group)
        fe = flags_ext.contiguous()
    solve = jacobi_cuda if use_kernels else jacobi_plain
    p, left = None, n_iter
    while left:
        p0 = None if p is None else exchange_ghost([p], h, group)[0]
        sweeps = min(h, left)
        p = solve(fe, de, sweeps, p0)[:, :, lo:lo + zl].contiguous()
        left -= sweeps
    return p
