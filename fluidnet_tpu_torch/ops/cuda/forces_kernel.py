"""K2: the fused projection prologue and the fused forces block; K4:
vorticity confinement alone.

Replaces fluidnet_tpu/ops/pallas/forces_kernel.py::_fb_kernel in both its
forms, and ::_vc_kernel, with one CUDA kernel template (csrc/prologue.cu):

  - prologue_cuda: the prologue form (epi=True, has_ubc), as launched by
    _pro_pallas_impl: one launch per ConvNet step. Slab BC -> buoyancy ->
    gravity -> vorticity confinement -> slab BC -> setWallBcs ->
    divergence. Counted in _build.launches["prologue"].
  - forces_block_cuda: the forces-block form (epi=False), as launched by
    _fb_pallas_impl: one launch per jacobi or PCG step. Buoyancy ->
    gravity -> vorticity confinement only. Counted in
    _build.launches["forces_block"].
  - vorticity_cuda: K4 (_vc_pallas_impl), the template without density and
    without the buoyancy/gravity stage: vorticity confinement of a 3-D
    velocity with a scalar strength. Counted in
    _build.launches["vorticity"].

The source note of csrc/prologue.cu gives what bounds it on the H100
(bytes: 32 / 36 / 28 B per cell compulsory for the forces block, the
prologue and K4) and the design: a block marches in z over a 32 x TY xy
tile and a range of planes, one thread per column of the tile grown by
the halo of 4, each input plane read once, the six stages pipelined over
the planes with z-neighbours in registers and xy-neighbours in shared
memory, inputs staged three planes ahead by cp.async, one barrier a
plane. That removes the 8x reloads of the 8^3-tile design it replaced (a
(Zc + 8) / Zc share in z and the xy halo remain), its 3.3x stage work and
five of its six barriers. `prologue_tiling` is the tiling table: from the
shape and the card's SM count, the tile height (8 or 16) and z-ranges that
minimise waves x steps x threads (one block an SM): one wave at 128^3 and
6x64^3.

ops.prologue.projection_prologue and ops.forces.forces_block take the
plain PyTorch versions (prologue_plain, ops.forces.forces_block_xla) for
CPU tensors and launch the kernel for CUDA tensors; nothing else chooses.
"""

from typing import NamedTuple

import torch

from fluidnet_tpu_torch.core.grids import get_dx
from fluidnet_tpu_torch.ops.boundary import set_wall_bcs
from fluidnet_tpu_torch.ops.cuda import _build
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.ops.forces import forces_block_xla


def slab(field, bc, inv):
    """The frozen slab BC of sim.simulate.apply_boundaries: value * inv +
    bc on the leading bc.shape[3] y-rows, the rest untouched."""
    yb = bc.shape[3]
    if yb == field.shape[3]:
        return field * inv + bc
    return torch.cat([field[:, :, :, :yb] * inv + bc, field[:, :, :, yb:]],
                     dim=3)


def prologue_plain(u, flags, density, buoy_g, grav_g, amp, dt, u_bc=None,
                   u_inv=None, dx=None):
    """Plain PyTorch version of K2 (runs on any device): the unfused
    composition the kernel replaces, in simulate()'s order; `dx` as
    ops.forces'. Returns (u'', div)."""
    if u_bc is not None:
        u = slab(u, u_bc, u_inv)
    u = forces_block_xla(u, flags, density, buoy_g, grav_g, amp, dt, dx)
    if u_bc is not None:
        u = slab(u, u_bc, u_inv)
    u = set_wall_bcs(u, flags)
    return u, velocity_divergence(u, flags)


def scal7(buoy_g, grav_g, amp, dt, flags, dx=None):
    """The kernel's 7 scalars [bx, by, bz, gx, gy, gz, amp]: add_buoyancy's
    per-face strength -buoy_g * dt / dx, add_gravity's force
    grav_g * dt / dx, and the confinement strength (prologue.py:62-68).
    dx None: from the flags' shape (a slab of a larger grid passes the
    grid's)."""
    if dx is None:
        dx = get_dx(flags)
    f32 = torch.float32
    buoy_g = torch.as_tensor(buoy_g, dtype=f32).cpu().expand(3)
    grav_g = torch.as_tensor(grav_g, dtype=f32).cpu().expand(3)
    amp = torch.as_tensor(amp, dtype=f32).cpu().reshape(1)
    return torch.cat([-buoy_g * (dt / dx), grav_g * (dt / dx), amp]).tolist()


TILE_X, HALO = 32, 4      # csrc/prologue.cu kTX, kH
TILE_YS = (8, 16)         # the tile heights csrc/prologue.cu instantiates
MIN_PLANES = 4            # a range recomputes 2 * HALO planes beside these


class Tiling(NamedTuple):
    """K2's and K4's grid for one shape: the xy tile's height (its width is
    TILE_X), output planes a block (the last range of a batch item may
    hold fewer), blocks, threads a block (one a column of the tile grown
    by HALO), steps a block (planes + 9 for the prologue, + 8 for the
    forces block and K4) and dynamic shared-memory bytes a block."""
    tile_y: int
    planes: int
    blocks: int
    threads: int
    steps: int
    smem: int


def smem_bytes(tile_y, epi=True):
    """csrc/prologue.cu's Smem<TY, EPI>: 168 bytes a plane cell of the
    grown tile, and for the prologue eight planes of the slab masks (6
    floats) on its first 8 rows."""
    cells = (TILE_X + 2 * HALO) * (tile_y + 2 * HALO)
    slab = (TILE_X + 2 * HALO) * 2 * HALO if epi else 1
    return 168 * cells + 8 * 6 * 4 * slab


def prologue_tiling(shape, n_sm: int, tile_y: int = None,
                    epi: bool = True) -> Tiling:
    """The tiling of u/flags of `shape` (b, c, z, y, x) for the prologue
    (`epi`) or the forces block and K4, on a card with `n_sm` SMs: tiles
    of TILE_X x tile_y, z cut into ranges of at least MIN_PLANES planes
    (or one range). The kernel's registers leave one block an SM and its
    steps are bound by issue, so a launch takes about ceil(blocks / n_sm)
    waves x steps a block x threads a block; the table takes the ranges,
    and with tile_y None the tile height, that minimise it (fewer ranges,
    then the lower tile, on a tie). One wave of fewer blocks than SMs
    beats two of more: at 1x64^3 128 blocks of 8 planes ran 1.5x faster
    than 256 of 4, at 128^3 128 blocks 9-16% faster than 256
    (scripts/torch_ab_step.py --kernels)."""
    heights = TILE_YS
    if tile_y is not None:
        if tile_y not in TILE_YS:
            raise ValueError(f"prologue: tile height {tile_y} not in "
                             f"{TILE_YS}")
        heights = (tile_y,)
    B, Z, Y, X = (int(shape[i]) for i in (0, 2, 3, 4))
    extra = 2 * HALO + (1 if epi else 0)
    options = []
    for ty in heights:
        tiles = B * -(-Y // ty) * -(-X // TILE_X)
        threads = (TILE_X + 2 * HALO) * (ty + 2 * HALO)
        for ranges in range(1, max(1, Z // MIN_PLANES) + 1):
            planes = -(-Z // ranges)
            blocks = tiles * -(-Z // planes)
            cost = -(-blocks // n_sm) * (planes + extra) * threads
            options.append((cost, ranges, ty, planes, blocks, threads))
    ty, planes, blocks, threads = min(options)[2:]
    return Tiling(ty, planes, blocks, threads, planes + extra,
                  smem_bytes(ty, epi))


def _tiling(u, tile_y, epi):
    return prologue_tiling(u.shape, _build.sm_count(u.device.index), tile_y,
                           epi)


def _check_args(name, u, flags, density):
    if u.dim() != 5 or u.shape[1] != 3:
        raise ValueError(f"{name}: u must be (b, 3, z, y, x), got "
                         f"{tuple(u.shape)}")
    B, _, Z, Y, X = u.shape
    if tuple(flags.shape) != (B, 1, Z, Y, X) or \
            tuple(density.shape) != (B, 1, Z, Y, X):
        raise ValueError(f"{name}: flags/density must be (b, 1, z, y, x)")
    if min(Z, Y, X) < 2 or B * 4 * Z * Y * X >= 2 ** 31:
        raise ValueError(f"{name}: unsupported shape {tuple(u.shape)}")
    return B, Z, Y, X


def _launch(u, flags, density, u_bc, u_inv, out, YB, epi, sc, tile_y):
    B, _, Z, Y, X = u.shape
    dev = u.device
    tiling = _tiling(u, tile_y, epi)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fluidnet_prologue(
            u.data_ptr(), flags.data_ptr(), density.data_ptr(),
            u_bc.data_ptr() if u_bc is not None else None,
            u_inv.data_ptr() if u_inv is not None else None, out.data_ptr(),
            B, Z, Y, X, YB, int(epi), *sc, tiling.tile_y, tiling.planes,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fluidnet_prologue")


def prologue_cuda(u, flags, density, buoy_g, grav_g, amp, dt, u_bc=None,
                  u_inv=None, tile_y=None, dx=None):
    """Launches K2's prologue form on CUDA tensors: same arguments and
    result as prologue_plain. u (b,3,Z,Y,X) f32, flags (b,1,Z,Y,X) int32,
    density (b,1,Z,Y,X) f32; u_bc/u_inv: frozen slab masks (b,3,Z,YB,X)
    or None; tile_y: the tiling's tile height (TILE_YS; None: the
    table's)."""
    B, Z, Y, X = _check_args("prologue", u, flags, density)
    f32 = torch.float32
    has_ubc = u_bc is not None
    args = [u, flags, density] + ([u_bc, u_inv] if has_ubc else [])
    dev = _build.require_cuda("prologue", *args,
                              dtypes=[f32, torch.int32, f32, f32, f32])
    YB = u_bc.shape[3] if has_ubc else 0
    if has_ubc and (tuple(u_bc.shape) != (B, 3, Z, YB, X) or
                    u_inv.shape != u_bc.shape or YB > Y):
        raise ValueError(f"prologue: slab masks of shape "
                         f"{tuple(u_bc.shape)} do not fit u {tuple(u.shape)}")
    sc = scal7(buoy_g, grav_g, amp, dt, flags, dx)
    out = torch.empty((B, 4, Z, Y, X), device=dev, dtype=f32)
    _launch(u, flags, density, u_bc, u_inv, out, YB, True, sc, tile_y)
    _build.launches["prologue"] += 1
    return out[:, 0:3], out[:, 3:4]


def forces_block_cuda(u, flags, density, buoy_g, grav_g, amp, dt,
                      tile_y=None, dx=None):
    """Launches K2's forces-block form on CUDA tensors: same arguments and
    result as ops.forces.forces_block_xla with (3,) gravity vectors and a
    scalar amp. u (b,3,Z,Y,X) f32, flags (b,1,Z,Y,X) int32, density
    (b,1,Z,Y,X) f32; tile_y as prologue_cuda's. Returns u'
    (b,3,Z,Y,X)."""
    B, Z, Y, X = _check_args("forces_block", u, flags, density)
    f32 = torch.float32
    dev = _build.require_cuda("forces_block", u, flags, density,
                              dtypes=[f32, torch.int32, f32])
    sc = scal7(buoy_g, grav_g, amp, dt, flags, dx)
    out = torch.empty((B, 3, Z, Y, X), device=dev, dtype=f32)
    _launch(u, flags, density, None, None, out, 0, False, sc, tile_y)
    _build.launches["forces_block"] += 1
    return out


def vorticity_cuda(u, flags, amp, tile_y=None):
    """Launches K4 on CUDA tensors: same arguments and result as
    ops.forces.vorticity_confinement_xla with a scalar strength. u
    (b,3,Z,Y,X) f32, flags (b,1,Z,Y,X) int32; tile_y as prologue_cuda's.
    Returns u' (b,3,Z,Y,X)."""
    if u.dim() != 5 or u.shape[1] != 3:
        raise ValueError(f"vorticity: u must be (b, 3, z, y, x), got "
                         f"{tuple(u.shape)}")
    B, _, Z, Y, X = u.shape
    if tuple(flags.shape) != (B, 1, Z, Y, X):
        raise ValueError("vorticity: flags must be (b, 1, z, y, x)")
    if min(Z, Y, X) < 2 or B * 3 * Z * Y * X >= 2 ** 31:
        raise ValueError(f"vorticity: unsupported shape {tuple(u.shape)}")
    dev = _build.require_cuda("vorticity", u, flags,
                              dtypes=[torch.float32, torch.int32])
    amp = float(torch.as_tensor(amp, dtype=torch.float32))
    out = torch.empty_like(u)
    tiling = _tiling(u, tile_y, False)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fluidnet_vorticity(
            u.data_ptr(), flags.data_ptr(), out.data_ptr(), B, Z, Y, X, amp,
            tiling.tile_y, tiling.planes, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fluidnet_vorticity")
    _build.launches["vorticity"] += 1
    return out
