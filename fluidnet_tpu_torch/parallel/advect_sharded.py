"""Z-sharded windowed advection: halo exchange around the advection
kernels.

Port of fluidnet_tpu.parallel.advect_sharded, the scale-out path for grids
past one card's memory (SURVEY.md §7 stage 7 / §2.3): the grid's z axis is
split over the mesh's 'sp' dim, each rank exchanges H z-planes with its
neighbours (`_exchange_z_halo`, parallel/halo.exchange_z_planes), runs the
windowed advection of ops/advect_fast on its halo-extended slab and crops.
On the card that is K1's unfused velocity sweeps (mac_vel_sweep, two
launches) and K5 (warp_group, the density's two sweeps) on every rank.

Halo width: H = 2W + 2 covers the worst case (the MacCormack backward
sweep reads the forward field within +-W, the forward sweep reads u within
+-(W + 1) through the MAC interpolation, and the 'Ours' free space reads
flags within +-(W + 1)). Displacements are clamped to +-(W - 1e-3), so
no interpolation or clamp lookup of a cell away from the domain border
reads past its slab; border cells take the global border mask
(halo.global_border_mask; the positional `border_mask` would mark the
slab's own ends).

Two limits of that argument, both the JAX function's as well (the port
computes what it computes):
  - positions are absolute (cell index + displacement), and a slab's
    indices are not the global ones, so a weight p - floor(p) rounds at
    the slab's magnitude, not the grid's (it moves by up to ulp(Z) / 2),
    and where a displacement lies within an ulp of a whole cell the
    support's corners shift by one, which can move the MacCormack clamp's
    bounds: shards agree with the unsharded result to that rounding, not
    to the bit (2e-6 of the field's largest value on a random 16^3 grid,
    7.5e-5 on chip_smoke.py's 256^3 plume). A slab equals the same
    halo-extended slab advected in one process to the bit. (The whole
    sharded step, parallel/simulate_sharded.py, passes each slab's z
    origin to the advection and equals the whole grid to the bit.)
  - at the global z ends the halo holds zeros where the unsharded warp
    clamps its corner: a method without the 'Ours' free-space clamp
    (maccormack, euler) at W >= 2 reaches them from non-border cells and
    differs within 2W - 1 planes of the ends. The 'Ours' methods, and W =
    1, never do.
"""

import torch

from fluidnet_tpu_torch.ops.advect_fast import (advect_scalar_fast,
                                                advect_vel_fast,
                                                chebyshev_free_space)
from fluidnet_tpu_torch.parallel.halo import (exchange_z_planes,
                                              global_border_mask)


def _exchange_z_halo(xs, h: int, group):
    """Each (b, c, zl, y, x) tensor of `xs` extended with h z-planes from
    each neighbour on `group` (zeros past the global domain ends); one
    exchange for all."""
    return [torch.cat([lo, x, hi], dim=2)
            for x, (lo, hi) in zip(xs, exchange_z_planes(xs, h, group))]


def advect_step_z_sharded(dt, u_l, density_l, flags_l, mesh, method,
                          maccormack_strength, window,
                          sample_outside_fluid=False):
    """One advection block (scalars then velocity, simulate.lua:183-199)
    on this rank's z-slab of a grid z-sharded over the mesh's 'sp' dim.

    u_l (b, 3, zl, y, x), density_l (b, c, zl, y, x) or None, flags_l
    (b, 1, zl, y, x): this rank's slabs (what shard_batch or local_part
    gives; they raise when Z does not divide over sp). Each density
    channel advects on its own, as JAX's does. Raises ValueError when a
    slab is shorter than the halo H = 2W + 2 (the exchange reaches only
    the immediate neighbours). Returns this rank's (u', density'), density'
    None without a density."""
    W = int(window)
    H = 2 * W + 2
    if u_l.dim() != 5 or u_l.shape[1] != 3:
        raise ValueError(f"advect_step_z_sharded: u must be 3-D (b, 3, z, "
                         f"y, x), got {tuple(u_l.shape)}")
    sp = mesh["sp"]
    group, idx = sp.get_group(), sp.get_local_rank()
    zl = u_l.shape[2]
    Z = zl * sp.size()
    if zl < H:
        raise ValueError(f"shard z-length {zl} < halo {H}: the exchange "
                         f"only reaches immediate neighbours (use fewer "
                         f"sp shards)")
    ue, fe, *de = _exchange_z_halo(
        [u_l, flags_l] + ([density_l] if density_l is not None else []), H,
        group)
    return advect_slab(dt, ue, de[0] if de else None, fe, Z, idx * zl - H,
                       method, maccormack_strength, W, sample_outside_fluid)


def advect_slab(dt, ue, de, fe, z_len_global, z0_global, method,
                maccormack_strength, window, sample_outside_fluid=False,
                plain=False):
    """The advection block on one halo-extended slab: ue (b, 3, zl + 2H,
    y, x), de (b, c, zl + 2H, y, x) or None, fe (b, 1, zl + 2H, y, x),
    whose first plane is global plane z0_global of a grid of z_len_global
    planes (H = 2W + 2). Each density channel advects on its own; the
    border is the global one, the 'Ours' free space comes from the
    extended flags. `plain=True` runs the kernels' plain versions.
    Returns (u', density' or None), cropped to the zl planes inside the
    halos."""
    W = int(window)
    H = 2 * W + 2
    zl = fe.shape[2] - 2 * H
    border = global_border_mask(fe.shape, z_len_global, z0_global,
                                fe.device)
    free = chebyshev_free_space(fe, W + 1) if method.endswith("Ours") \
        else None
    d_out = None
    if de is not None:
        chans = [advect_scalar_fast(dt, de[:, c:c + 1], ue, fe, method,
                                    sample_outside_fluid,
                                    maccormack_strength, W, free=free,
                                    border=border, plain=plain)
                 for c in range(de.shape[1])]
        d_out = torch.cat(chans, dim=1)[:, :, H:H + zl].contiguous()
    u_out = advect_vel_fast(dt, ue, fe, method, maccormack_strength, W,
                            free=free, border=border, plain=plain)
    return u_out[:, :, H:H + zl].contiguous(), d_out
