"""K1: the fused MacCormack advection sweep, in both its forms.

Replaces fluidnet_tpu/ops/pallas/mac_sweep.py::_sweep_kernel as reached
through
  - advect_sweep_fused_ep (fuse_ep=True): two launches per simulation step,
    forward (dcoef = -dt) and backward (dcoef = +dt), counted in
    _build.launches["mac_sweep_fwd"] / ["mac_sweep_bwd"];
  - advect_sweep and mac_vel_sweep (fuse_ep=False), the unfused forms that
    emit the raw channels (9 to 14) and carry the JAX VJP, whose adjoint
    runs on K6 (ops/cuda/warp_transpose.py): counted in
    ["mac_sweep_unfused_fwd"] / ["mac_sweep_unfused_bwd"].
The CUDA kernel is csrc/mac_sweep.cu; its source note gives the per-cell
work, what bounds it on the H100 (72 to 84 B/cell of compulsory traffic
against ~90 reads and ~1000 compiled instructions a cell: issue) and the
design. Two
routes (sweep_route): windows 1 and 2 take the tiled route, a z-march
over 32 x TY shared-memory tiles grown by the window, inputs staged ahead
by cp.async, with the grid from sweep_tiling (the counts above); wider
windows, and extents above MAX_TILED_EXTENT, take the global route, one
thread a cell gathering from global memory, counted in
["mac_sweep_global"] whatever the form.

CPU tensors take the plain PyTorch versions below (sweep_fused_ep_plain,
sweep_plain), CUDA tensors launch the kernel; the unfused forms also take
plain=True. Positions are index-offset: a cell center is its integer index.

Every form takes a z origin `z0` (default 0): the global index of the
array's first z plane, for a slab of a z-sharded grid. Positions are then
global, (z0 + k) + clip(d) in z, so a weight p - floor(p) rounds as the
whole grid's does; a corner's index into the array is floor(p) - z0, and
BUILD_INDEX clamps at the array's ends, z0 and z0 + Z - 1.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from fluidnet_tpu_torch.core.grids import border_mask
from fluidnet_tpu_torch.ops import stencil as st
from fluidnet_tpu_torch.ops.cuda import _build
from fluidnet_tpu_torch.ops.cuda.warp_transpose import warp_transpose
from fluidnet_tpu_torch.ops.forces import get_centered
from fluidnet_tpu_torch.ops.interp import (cell_center_positions,
                                           get_at_mac_x, get_at_mac_y,
                                           get_at_mac_z)
from fluidnet_tpu_torch.ops.replay import needs_grad

_EPS = 1e-3
_BIG = 1e30


def _build_index(p, n, lo=0):
    """BUILD_INDEX corner + weights along one axis (warp.py:84-94) of an
    array whose first cell is global index `lo`: p < lo -> corner lo,
    weight 1; base corner >= lo + n - 1 -> corners {lo + n - 2, lo + n - 1}
    with weights {0, 1}. Returns the base corner's index into the array
    (the global one less lo)."""
    i = torch.floor(p)
    w1 = p - i
    w0 = 1.0 - w1
    neg = p < lo
    i = torch.where(neg, float(lo), i)
    w0 = torch.where(neg, 1.0, w0)
    w1 = torch.where(neg, 0.0, w1)
    hi = i >= lo + n - 1
    i = torch.where(hi, float(lo + n - 2), i)
    w0 = torch.where(hi, 0.0, w0)
    w1 = torch.where(hi, 1.0, w1)
    return (i - lo).long(), w0, w1


def _corners(px, py, pz, Z, Y, X, z0=0):
    """The 8 support corners of each position as (flat index (b, N),
    weight), in the order the kernels accumulate (z, then y, then x
    corner, each ascending); weight = (wz * wy) * wx. pz is global, the
    array's first plane z0."""
    b = px.shape[0]
    ix, wx0, wx1 = _build_index(px, X)
    iy, wy0, wy1 = _build_index(py, Y)
    iz, wz0, wz1 = _build_index(pz, Z, z0)
    out = []
    for dz, wz in ((0, wz0), (1, wz1)):
        for dy, wy in ((0, wy0), (1, wy1)):
            wzy = wz * wy
            row = ((iz + dz) * Y + (iy + dy)) * X
            for dx, wx in ((0, wx0), (1, wx1)):
                out.append(((row + ix + dx).reshape(b, -1), wzy * wx))
    return out


def _gather(field, idx):
    """field (b, Z, Y, X) at flat indices idx (b, N) -> (b, Z, Y, X)."""
    b = field.shape[0]
    return torch.gather(field.reshape(b, -1), 1, idx).view(field.shape)


def _allowed(free, ours):
    """The 'Ours' trace length each cell allows (free space less half a
    cell and the margin), or None."""
    return (free[:, 0] - 0.5 - _EPS).clamp_min(0.0) if ours else None


def _backtrace(vel, base, dcoef, window, allowed, own=None):
    """Backtrace positions base + clip(dcoef * vel, +-(window - eps)) per
    axis: vel (b, 3, Z, Y, X), base the (x, y, z) grids. With `allowed`
    the displacement first shrinks to that Chebyshev length; with `own` (a
    bool mask) cells outside it keep their own centre. The kernel's base is
    the cell index i, the JAX VJP's the centre i + 0.5: the two round
    differently, so each caller passes its own."""
    d = [dcoef * vel[:, a] for a in range(3)]
    if allowed is not None:
        mag = torch.maximum(torch.maximum(d[0].abs(), d[1].abs()),
                            d[2].abs())
        scale = (allowed / mag.clamp_min(1e-12)).clamp(max=1.0)
        d = [x * scale for x in d]
    lim = float(window) - _EPS
    p = [b + x.clamp(-lim, lim) for b, x in zip(base, d)]
    if own is not None:
        p = [torch.where(own, q, b) for q, b in zip(p, base)]
    return p


def _sweep_raw(u, s, m, fwd_u, fwd_s, free, dcoef, window, ours,
               with_scalar, renorm, z0=0):
    """The raw channels of the sweep (mac_sweep.py:545-558): u_w, u_mn,
    u_mx and, with the scalar, s_plain [, s_num, s_den] and on the forward
    sweep s_mn, s_mx; each (b, c, Z, Y, X). z0: the z origin."""
    is_bwd = fwd_u is not None
    b, _, Z, Y, X = u.shape
    dev, f32 = u.device, torch.float32
    base = (torch.arange(X, device=dev, dtype=f32).view(1, 1, 1, X),
            torch.arange(Y, device=dev, dtype=f32).view(1, 1, Y, 1),
            torch.arange(z0, z0 + Z, device=dev, dtype=f32).view(1, Z, 1, 1))
    allowed = _allowed(free, ours)

    def positions(vel, own_center_off_fluid):
        # Non-fluid cells warp their own centers (tfluids.cc:157-160).
        own = m[:, 0] > 0.5 if own_center_off_fluid else None
        return _corners(*_backtrace(vel, base, dcoef, window, allowed, own),
                        Z, Y, X, z0)

    wu = fwd_u if is_bwd else u
    u_w, u_mn, u_mx = [], [], []
    macs = (get_at_mac_x(u, True), get_at_mac_y(u, True),
            get_at_mac_z(u, True))
    for c in range(3):
        acc = mn = mx = None
        for idx, w in positions(macs[c], False):
            v = _gather(wu[:, c], idx)
            bv = _gather(u[:, c], idx) if is_bwd else v
            acc = v * w if acc is None else acc + v * w
            mn = bv if mn is None else torch.minimum(mn, bv)
            mx = bv if mx is None else torch.maximum(mx, bv)
        u_w.append(acc)
        u_mn.append(mn)
        u_mx.append(mx)
    res = {"u_w": torch.stack(u_w, 1), "u_mn": torch.stack(u_mn, 1),
           "u_mx": torch.stack(u_mx, 1)}
    if not with_scalar:
        return res

    ws = (fwd_s if is_bwd else s)[:, 0]
    mc = m[:, 0]
    plain = num = den = s_mn = s_mx = None
    for idx, w in positions(get_centered(u, True), ours and not is_bwd):
        sv = _gather(ws, idx)
        plain = sv * w if plain is None else plain + sv * w
        if renorm:
            mv = _gather(mc, idx)
            num = (sv * mv) * w if num is None else num + (sv * mv) * w
            den = mv * w if den is None else den + mv * w
            lo = torch.where(mv > 0.5, sv, _BIG)
            hi = torch.where(mv > 0.5, sv, -_BIG)
        else:
            lo = hi = sv
        if not is_bwd:
            s_mn = lo if s_mn is None else torch.minimum(s_mn, lo)
            s_mx = hi if s_mx is None else torch.maximum(s_mx, hi)
    res["s_plain"] = plain[:, None]
    if renorm:
        res["s_num"] = num[:, None]
        res["s_den"] = den[:, None]
    if not is_bwd:
        res["s_mn"] = s_mn[:, None]
        res["s_mx"] = s_mx[:, None]
    return res


def sweep_plain(u, s, m, fwd_u, fwd_s, free, dcoef, window, ours,
                with_scalar, renorm, z0=0):
    """Plain PyTorch version of K1's unfused forms (runs on any device):
    the arguments of advect_sweep, the raw channels as one (b, C, Z, Y, X)
    tensor in the kernel's layout (RAW_KEYS)."""
    res = _sweep_raw(u, s, m, fwd_u, fwd_s, free, dcoef, window, ours,
                     with_scalar, renorm, z0)
    keys = raw_keys(fwd_u is not None, with_scalar, renorm)
    return torch.cat([res[k] for k in keys], dim=1)


def raw_keys(is_bwd, with_scalar, renorm):
    """The raw output channels in order: (name, width) pairs flattened to
    names, 9 to 14 channels (u_w, u_mn, u_mx 3 wide, the rest 1)."""
    keys = ["u_w", "u_mn", "u_mx"]
    if with_scalar:
        keys += ["s_plain"] + (["s_num", "s_den"] if renorm else [])
        if not is_bwd:
            keys += ["s_mn", "s_mx"]
    return keys


def _split_raw(out, keys):
    res, c = {}, 0
    for k in keys:
        n = 3 if k.startswith("u_") else 1
        res[k] = out[:, c:c + n]
        c += n
    return res


def sweep_fused_ep_plain(u, s, m, fwd_u, fwd_s, free, dcoef, strength,
                         window, ours, renorm, z0=0):
    """Plain PyTorch version of K1 (runs on any device). Same arguments
    and result as advect_sweep_fused_ep."""
    is_bwd = fwd_u is not None
    raw = _sweep_raw(u, s, m, fwd_u, fwd_s, free, dcoef, window, ours,
                     True, renorm, z0)
    u_w = [raw["u_w"][:, c] for c in range(3)]
    fl = m[:, 0] > 0.5
    if renorm:
        num, den = raw["s_num"][:, 0], raw["s_den"][:, 0]
        safe = den > 1e-6
        val = torch.where(safe, num / torch.where(safe, den, 1.0),
                          raw["s_plain"][:, 0])
    else:
        val = raw["s_plain"][:, 0]

    border = border_mask(u.shape, True, 1, u.device)[:, 0]

    def border0(v):
        return torch.where(border, 0.0, v)

    res = {}
    if not is_bwd:
        for c in range(3):
            v = torch.where(fl, u_w[c], u[:, c]) if ours else u_w[c]
            u_w[c] = border0(v)
        if ours:
            val = torch.where(fl, val, s[:, 0])
        res["s_val"] = border0(val)[:, None]
        res["s_mn"] = raw["s_mn"]
        res["s_mx"] = raw["s_mx"]
    else:
        # MacCormack correction with per-component fluid skips
        # (tfluids.cc:660-699): the -axis neighbour must be fluid too; it
        # counts as fluid at the low edge.
        skips = (st.xm(fl, True), st.ym(fl, True), st.zm(fl, True))
        for c in range(3):
            fwd_c = fwd_u[:, c]
            bwd_c = torch.where(fl, u_w[c], fwd_c) if ours else u_w[c]
            bwd_c = border0(bwd_c)
            corr = fwd_c + strength * 0.5 * (u[:, c] - bwd_c)
            u_w[c] = torch.where(fl & skips[c], corr, fwd_c)
        fwd_sc = fwd_s[:, 0]
        if ours:
            val = torch.where(fl, val, fwd_sc)
        bwd_s = border0(val)
        res["s_val"] = (fwd_sc + torch.where(
            fl, strength * 0.5 * (s[:, 0] - bwd_s), 0.0))[:, None]
    res["u_w"] = torch.stack(u_w, 1)
    res["u_mn"] = raw["u_mn"]
    res["u_mx"] = raw["u_mx"]
    return res


TILE_X = 32               # csrc/mac_sweep.cu kTX
TILE_YS = (8, 16)         # the tile heights the tiled route instantiates
AHEAD = 1                 # kAhead: input planes in flight
TILED_WINDOWS = (1, 2)    # the windows the tiled route takes
MIN_PLANES = 4            # a range reloads 2W planes beside these
L1_SMEM = 200704          # H100: above 196 KB shared memory an SM, 28 KB L1
MAX_TILED_EXTENT = 2 ** 15


def sweep_route(window, shape, z0=0):
    """"tiled" for the windows the tiled route instantiates
    (TILED_WINDOWS) on u of `shape` (b, 3, z, y, x) at z origin z0 with no
    global index above MAX_TILED_EXTENT (z0 + z, y, x), else "global". The
    tile holds the corners in [i - W, i + W] only while the float32
    position i + (W - 1e-3) rounds below i + W: from 2^15 up its ulp is
    2^-8, the sum rounds to i + W and the upper corner to i + W + 1."""
    z, y, x = (int(n) for n in shape[-3:])
    tiled = int(window) in TILED_WINDOWS and \
        max(int(z0) + z, y, x) <= MAX_TILED_EXTENT
    return "tiled" if tiled else "global"


class Tiling(NamedTuple):
    """The tiled route's grid for one shape: the xy tile's height (its
    width is TILE_X), output planes a block (the last range of a batch item
    may hold fewer), blocks, threads a block (one a column of the tile),
    input planes a block loads (planes + 2W) and dynamic shared-memory
    bytes a block."""
    tile_y: int
    planes: int
    blocks: int
    threads: int
    loads: int
    smem: int


def smem_bytes(window, tile_y, is_bwd, scalar):
    """csrc/mac_sweep.cu's Ring: 2W + 1 + AHEAD planes of the tile grown by
    W, each of the form's staged channels (u, [fwd_u,] [the warped scalar,
    m])."""
    plane = (TILE_X + 2 * window) * (tile_y + 2 * window)
    channels = 3 + (3 if is_bwd else 0) + (2 if scalar else 0)
    return 4 * (2 * window + 1 + AHEAD) * channels * plane


def sweep_tiling(shape, window, n_sm, resident, is_bwd, scalar,
                 tile_y=None) -> Tiling:
    """The tiled route's grid for u of `shape` (b, 3, z, y, x) on a card
    with `n_sm` SMs, of which each holds resident[tile_y] blocks of the
    form at once. For each tile height (or `tile_y`), z is cut into as many
    ranges as fill one wave of the resident blocks (ranges of at least
    MIN_PLANES planes, or one). The kernel is
    bound by issue, so a launch takes about the work of the SM with the
    most blocks (blocks x rows x planes loaded): the height with the least
    is taken. On a tie, first the height whose blocks leave an SM more
    than 28 KB of L1 (shared memory of at most L1_SMEM bytes an SM:
    above it the carveout leaves 28 KB; 32 x 8 forward at W = 2 ran 10%
    slower so), then the one with two or more blocks an SM (one block
    stalls its SM at every barrier: 32 x 16 backward at W = 2, 5%), then
    the lower (up to 5% faster at W = 1); scripts/torch_ab_step.py
    --kernels times both heights."""
    heights = TILE_YS
    if tile_y is not None:
        if tile_y not in TILE_YS:
            raise ValueError(f"mac_sweep: tile height {tile_y} not in "
                             f"{TILE_YS}")
        heights = (tile_y,)
    B, Z, Y, X = (int(shape[i]) for i in (0, 2, 3, 4))
    W = int(window)
    smem = {ty: smem_bytes(W, ty, is_bwd, scalar) for ty in heights}
    options = []
    for ty in heights:
        tiles = B * -(-Y // ty) * -(-X // TILE_X)
        ranges = max(1, min(n_sm * resident[ty] // tiles, Z // MIN_PLANES))
        zc = -(-Z // ranges)
        blocks = tiles * -(-Z // zc)
        per_sm = -(-blocks // n_sm)
        options.append((per_sm * ty * (zc + 2 * W),
                        per_sm * (smem[ty] + 1024) > L1_SMEM, per_sm < 2,
                        ty, zc, blocks))
    *_, ty, zc, blocks = min(options)
    return Tiling(ty, zc, blocks, TILE_X * ty, zc + 2 * W, smem[ty])


@functools.lru_cache(maxsize=None)
def resident_blocks(index, form, window, tile_y):
    """Blocks of the tiled route's kernel for `form` (is_bwd, ours, renorm,
    scalar, fuse) that one SM of CUDA device `index` holds at once."""
    lib = _build.library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.fluidnet_mac_sweep_occupancy(*form, int(window), tile_y,
                                               ctypes.byref(blocks))
    _build.check(err, "fluidnet_mac_sweep_occupancy")
    return blocks.value


def launch_tiling(u, window, form, tile_y=None):
    """sweep_tiling for a launch of `form` on u's card."""
    return _device_tiling(u.device.index, tuple(u.shape), int(window), form,
                          tile_y)


@functools.lru_cache(maxsize=None)
def _device_tiling(index, shape, window, form, tile_y):
    resident = {ty: resident_blocks(index, form, window, ty)
                for ty in TILE_YS}
    return sweep_tiling(shape, window, _build.sm_count(index), resident,
                        form[0], form[3], tile_y)


def _launch(u, s, m, fwd_u, fwd_s, free, dcoef, strength, window, ours,
            renorm, with_scalar, fuse, c_out, tile_y, z0):
    """Launches K1 on its route; returns (out, the route's launch key
    suffix: "" tiled, "global")."""
    is_bwd = fwd_u is not None
    if u.dim() != 5 or u.shape[1] != 3:
        raise ValueError(f"mac_sweep: u must be (b, 3, z, y, x), got "
                         f"{tuple(u.shape)}")
    B, _, Z, Y, X = u.shape
    f32 = torch.float32
    s_in = s if (fuse or (with_scalar and not is_bwd)) else None
    m_in = m if with_scalar else None
    fs_in = fwd_s if (with_scalar and is_bwd) else None
    args = [t for t in (u, s_in, m_in, fwd_u, fs_in, free if ours else None)
            if t is not None]
    dev = _build.require_cuda("mac_sweep", *args, dtypes=[f32] * len(args))
    for name, t, c in (("s", s_in, 1), ("m", m_in, 1), ("fwd_u", fwd_u, 3),
                       ("fwd_s", fs_in, 1),
                       ("free", free if ours else None, 1)):
        if t is not None and tuple(t.shape) != (B, c, Z, Y, X):
            raise ValueError(f"mac_sweep: {name} has shape "
                             f"{tuple(t.shape)}, expected {(B, c, Z, Y, X)}")
    if min(Z, Y, X) < 2 or B * c_out * Z * Y * X >= 2 ** 31 or \
            not 0 <= z0 < 2 ** 24 - Z:
        raise ValueError(f"mac_sweep: unsupported shape {tuple(u.shape)} "
                         f"or z origin {z0}")
    out = torch.empty((B, c_out, Z, Y, X), device=dev, dtype=f32)
    form = (int(is_bwd), int(ours), int(renorm), int(with_scalar), int(fuse))
    if sweep_route(window, u.shape, z0) == "tiled":
        tiling = launch_tiling(u, window, form, tile_y)
        ty, zc = tiling.tile_y, tiling.planes
    elif tile_y is not None:
        raise ValueError(f"mac_sweep: window {window} at shape "
                         f"{tuple(u.shape)} takes the global route, which "
                         "has no tiling")
    else:
        ty, zc = 0, 0

    def ptr(t):
        return t.data_ptr() if t is not None else None
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fluidnet_mac_sweep(
            ptr(u), ptr(s_in), ptr(m_in), ptr(fwd_u), ptr(fs_in),
            ptr(free) if ours else None, out.data_ptr(),
            B, Z, Y, X, int(z0), float(dcoef), float(strength),
            float(window) - _EPS,
            *form, int(window), ty, zc,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fluidnet_mac_sweep")
    return out, "" if ty else "global"


def _sweep_cuda(u, s, m, fwd_u, fwd_s, free, dcoef, strength, window,
                ours, renorm, tile_y=None, z0=0):
    is_bwd = fwd_u is not None
    out, route = _launch(u, s, m, fwd_u, fwd_s, free, dcoef, strength,
                         window, ours, renorm, True, True,
                         10 if is_bwd else 12, tile_y, z0)
    _build.launches[f"mac_sweep_{route or ('bwd' if is_bwd else 'fwd')}"] \
        += 1
    res = {"u_w": out[:, 0:3], "u_mn": out[:, 3:6], "u_mx": out[:, 6:9],
           "s_val": out[:, 9:10]}
    if not is_bwd:
        res["s_mn"] = out[:, 10:11]
        res["s_mx"] = out[:, 11:12]
    return res


def sweep_cuda(u, s, m, fwd_u, fwd_s, free, dcoef, window, ours,
               with_scalar, renorm, z0=0, tile_y=None):
    """Launches K1's unfused form: same arguments and result as
    sweep_plain (the raw channels as one tensor); tile_y forces the tiled
    route's tile height (sweep_tiling)."""
    is_bwd = fwd_u is not None
    renorm = renorm and with_scalar
    c_out = sum(3 if k.startswith("u_") else 1
                for k in raw_keys(is_bwd, with_scalar, renorm))
    out, route = _launch(u, s, m, fwd_u, fwd_s, free, dcoef, 0.0, window,
                         ours, renorm, with_scalar, False, c_out, tile_y, z0)
    _build.launches["mac_sweep_" + (
        route or "unfused_" + ("bwd" if is_bwd else "fwd"))] += 1
    return out


def advect_sweep_fused_ep(u, s, m, fwd_u, fwd_s, free, dcoef, strength,
                          window, ours, renorm, z0=0, tile_y=None):
    """Fused-epilogue sweep. u (b,3,Z,Y,X); s, m (fluid mask), free
    (Chebyshev free space, read when `ours`) (b,1,Z,Y,X); fwd_u=None =>
    forward sweep: returns masked {u_w, s_val, u_mn/mx, s_mn/mx}. Else
    backward sweep (fwd_u, fwd_s from the forward sweep): returns the
    MacCormack-corrected {u_w, s_val} (unclamped) and {u_mn/mx}. z0: the
    global index of the first z plane (the module's note).

    CPU tensors run the plain version; CUDA tensors launch K1 (tile_y
    forces the tiled route's tile height, sweep_tiling)."""
    if int(window) < 1:
        raise ValueError(f"mac_sweep: window must be >= 1, got {window}")
    if u.device.type == "cpu":
        return sweep_fused_ep_plain(u, s, m, fwd_u, fwd_s, free, dcoef,
                                    strength, window, ours, renorm, z0)
    return _sweep_cuda(u, s, m, fwd_u, fwd_s, free, dcoef, strength,
                       window, ours, renorm, tile_y, z0)


# --- the unfused forms and their gradient ----------------------------------


def positions_for_vjp(u, free, dcoef, window, ours, center=False, m=None,
                      z0=0):
    """The backtrace positions of the sweep as the JAX VJP recomputes them
    (mac_sweep.py:575-614, cell centres at i + 0.5, global in z from the
    origin z0): the three MAC components (b, 3, Z, Y, X) each, or with
    `center` the scalar's (b, 1, Z, Y, X), where `m` (if given) keeps
    non-fluid cells at their own centres."""
    base = cell_center_positions(u.shape, u.dtype, u.device, z0)
    allowed = _allowed(free, ours)
    vels = [get_centered(u, True)] if center else \
        [get_at_mac_x(u, True), get_at_mac_y(u, True), get_at_mac_z(u, True)]
    own = m[:, 0] > 0.5 if center and m is not None else None
    per = [_backtrace(vel, base, dcoef, window, allowed, own) for vel in vels]
    return tuple(torch.stack(axis, 1).contiguous() for axis in zip(*per))


def _sweep_forward(opts, u, s, m, fwd_u, fwd_s, free):
    dcoef, window, ours, with_scalar, renorm, plain, z0 = opts
    fn = sweep_plain if plain or u.device.type == "cpu" else sweep_cuda
    return fn(u, s, m, fwd_u, fwd_s, free, dcoef, window, ours, with_scalar,
              renorm, z0)


class _Sweep(torch.autograd.Function):
    """K1's unfused sweep with the JAX VJP (_sweep_bwd_rule,
    mac_sweep.py:617-657): the gradient is the transposed warp (K6) at the
    positions recomputed from a detached u; positions, the mask, the free
    space and dcoef get no gradient, and the cotangents of the bounds
    (u_mn, u_mx, s_mn, s_mx) and of s_den are dropped. The backward sweep
    gives u no gradient at all (its bounds are the only use of u)."""

    @staticmethod
    def forward(ctx, opts, u, s, m, fwd_u, fwd_s, free):
        ctx.opts = opts
        ctx.is_bwd = fwd_u is not None
        ctx.save_for_backward(u, m, free)
        return _sweep_forward(opts, u, s, m, fwd_u, fwd_s, free)

    @staticmethod
    def backward(ctx, g):
        dcoef, window, ours, with_scalar, renorm, plain, z0 = ctx.opts
        u, m, free = ctx.saved_tensors
        is_bwd = ctx.is_bwd
        keys = raw_keys(is_bwd, with_scalar, renorm)
        cots = _split_raw(g, keys)
        u_c = u.detach()
        px, py, pz = positions_for_vjp(u_c, free, dcoef, window, ours, z0=z0)
        grad_uw = warp_transpose(cots["u_w"][:, :, None].contiguous(), px,
                                 py, pz, window, False, plain=plain,
                                 z0=z0)[:, :, 0]
        grad_sval = None
        if with_scalar:
            mask = m if (not is_bwd and ours) else None
            cpx, cpy, cpz = positions_for_vjp(u_c, free, dcoef, window, ours,
                                              center=True, m=mask, z0=z0)
            if renorm:
                g_sc = torch.stack([cots["s_plain"], cots["s_num"]], 1)
                gt = warp_transpose(g_sc.contiguous(), cpx.repeat(1, 2, 1, 1, 1),
                                    cpy.repeat(1, 2, 1, 1, 1),
                                    cpz.repeat(1, 2, 1, 1, 1), window, False,
                                    plain=plain, z0=z0)
                grad_sval = gt[:, 0] + m * gt[:, 1]
            else:
                grad_sval = warp_transpose(
                    cots["s_plain"][:, :, None].contiguous(), cpx, cpy, cpz,
                    window, False, plain=plain, z0=z0)[:, :, 0]
        if is_bwd:
            return None, None, None, None, grad_uw, grad_sval, None
        return None, grad_uw, grad_sval, None, None, None, None


def advect_sweep(u, s, m, fwd_u, fwd_s, free, dcoef, window, ours,
                 with_scalar, renorm, *, plain=False, z0=0):
    """K1's unfused sweep (JAX mac_sweep.advect_sweep). fwd_u=None =>
    forward sweep (warps u [and s]), else backward sweep (warps fwd_u [and
    fwd_s], bounds from u). u (b,3,Z,Y,X); s, m (fluid mask), fwd_s, free
    (read when `ours`) (b,1,Z,Y,X) or None. Returns the dict of raw
    channels: u_w, u_mn, u_mx [, s_plain [, s_num, s_den] [, s_mn, s_mx]].

    CUDA tensors launch K1 (unfused form), CPU tensors or plain=True run
    sweep_plain; either way the gradient is the JAX VJP on K6 (or its
    plain version), at the same z origin z0."""
    if int(window) < 1:
        raise ValueError(f"mac_sweep: window must be >= 1, got {window}")
    renorm = bool(renorm and with_scalar)
    opts = (dcoef, int(window), bool(ours), bool(with_scalar), renorm,
            bool(plain), int(z0))
    cont = [t.contiguous() if t is not None else None
            for t in (u, s, m, fwd_u, fwd_s, free)]
    if needs_grad(*cont):
        out = _Sweep.apply(opts, *cont)
    else:
        out = _sweep_forward(opts, *cont)
    return _split_raw(out, raw_keys(fwd_u is not None, with_scalar, renorm))


def mac_vel_sweep(u, fwd, free, dcoef, window, ours, *, plain=False, z0=0):
    """Velocity-only unfused sweep: returns (warped, mn, mx)."""
    out = advect_sweep(u, None, None, fwd, None, free, dcoef, window, ours,
                       False, False, plain=plain, z0=z0)
    return out["u_w"], out["u_mn"], out["u_mx"]
