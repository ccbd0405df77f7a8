"""Windowed advection: the production path of the JAX package.

Port of fluidnet_tpu.ops.advect_fast, in two parts:

  - `advect_scalar_fast` and `advect_vel_fast`: in 2-D every
    interpolation is a windowed warp (ops/warp.py, kernel K5) at positions
    computed here in PyTorch; the 3-D velocity runs K1's unfused velocity
    sweep. Methods maccormackOurs, maccormack, euler and eulerOurs;
    rk2Ours / rk3Ours reduce to them as in JAX.
  - `advect_vel_scalar_fast` (3-D): the density and all three MAC velocity
    components with one K1 launch per sweep (ops/cuda/mac_sweep.py), in
    the fused-epilogue form (only the final two-direction MacCormack clamp,
    which combines both sweeps' bounds, stays in PyTorch) or the unfused
    form. The fused form's gradient replays the unfused one, whose
    gradient is the transposed warp (K6).

`chebyshev_free_space` is the 'Ours' trace clamp of both. Same documented
deviations from the exact reference as the JAX fast path: displacements
clamped to +-(window - 1e-3) cells, the 'Ours' trace clamped at the
Chebyshev free-space radius, and mask-renormalized fluid-aware
interpolation. `plain=True` runs K5's plain version on any device.
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_fluid, is_obstacle
from fluidnet_tpu_torch.core.grids import border_mask, check_shapes
from fluidnet_tpu_torch.ops import stencil as st
from fluidnet_tpu_torch.ops.cuda.mac_sweep import (advect_sweep_fused_ep,
                                                   sweep_fused_ep_plain)
from fluidnet_tpu_torch.ops.forces import get_centered
from fluidnet_tpu_torch.ops.interp import (cell_center_positions,
                                           get_at_mac_x, get_at_mac_y)
from fluidnet_tpu_torch.ops.warp import (clamp_displacement, gather_cells,
                                         warp_fluid, warp_group,
                                         warp_trilinear,
                                         warp_trilinear_shared)

_EPS = 1e-3
_BIG = 1e30
_FUSED_METHODS = ("maccormackOurs", "euler", "eulerOurs")


def chebyshev_free_space(flags, max_d: int):
    """Chebyshev distance (in cells, capped at max_d) from each cell to the
    nearest non-fluid cell, via iterated 3^d max-filter dilation of the
    blocked mask. Returns (b, 1, z, y, x) f32."""
    is_3d = flags.shape[2] > 1
    blocked = (~is_fluid(flags)).to(torch.float32)
    axes = [st.AX_Z, st.AX_Y, st.AX_X] if is_3d else [st.AX_Y, st.AX_X]

    def dilate(m):
        for ax in axes:
            m = torch.maximum(m, torch.maximum(st.shift(m, -1, ax, 1.0),
                                               st.shift(m, 1, ax, 1.0)))
        return m

    d = torch.where(blocked > 0.5, 0.0, float(max_d))
    m = blocked
    for k in range(1, max_d):
        m = dilate(m)
        d = torch.minimum(d, torch.where(m > 0.5, float(k), float(max_d)))
    return d


def _positions(shape, b, dtype, device):
    """Cell-centre positions (px, py, pz), each (b, z, y, x)."""
    return tuple(p.expand(b, -1, -1, -1)
                 for p in cell_center_positions(shape, dtype, device))


def _trace_clamp(flags, dx, dy, dz, window, free=None):
    """The fast 'line trace': scales the displacement so its endpoint stays
    in free space (replaces calcLineTrace for the Ours variants)."""
    if free is None:
        free = chebyshev_free_space(flags, window + 1)
    allowed = (free[:, 0] - 0.5 - _EPS).clamp_min(0.0)
    mag = torch.maximum(torch.maximum(dx.abs(), dy.abs()), dz.abs())
    scale = (allowed / mag.clamp_min(1e-12)).clamp(max=1.0)
    return dx * scale, dy * scale, dz * scale


# --- scalar advection --------------------------------------------------------

def _euler_pos_scalar(s, u, flags, dt, is_3d, W, ours, free=None):
    cent = get_centered(u, is_3d)
    dx, dy, dz = -dt * cent[:, 0], -dt * cent[:, 1], -dt * cent[:, 2]
    if ours:
        dx, dy, dz = _trace_clamp(flags, dx, dy, dz, W, free)
    dx, dy, dz = clamp_displacement(dx, dy, dz, W)
    px, py, pz = _positions(s.shape, s.shape[0], s.dtype, s.device)
    return px + dx, py + dy, pz + dz


def _sample_scalar_fast(s, flags, px, py, pz, sample_outside_fluid, W,
                        plain):
    if sample_outside_fluid:
        return warp_trilinear_shared(s, px, py, pz, W, plain=plain)
    return warp_fluid(s, flags, px, py, pz, W, plain=plain)


def _corner_minmax_fields(src, is_3d):
    """Pairwise corner min/max: mn2(c) = min over src[c + {0,1}^d] (the
    corner set doClampComponent scans, tfluids.cc:263-287)."""
    inf = float("inf")
    mn = torch.minimum(src, st.xp(src, inf))
    mx = torch.maximum(src, st.xp(src, -inf))
    mn = torch.minimum(mn, st.yp(mn, inf))
    mx = torch.maximum(mx, st.yp(mx, -inf))
    if is_3d:
        mn = torch.minimum(mn, st.zp(mn, inf))
        mx = torch.maximum(mx, st.zp(mx, -inf))
    return mn, mx


def _iota(n, axis, dtype, device):
    """arange(n) shaped to broadcast along `axis` of (1, z, y, x)."""
    shape = [1, 1, 1, 1]
    shape[axis] = n
    return torch.arange(n, dtype=dtype, device=device).view(shape)


def _clamp_lookup_cells(vel_x, vel_y, vel_z, sign, shape, is_3d, W):
    """Integer base-corner cells of the clamp lookups: clamp(trunc(i +
    sign * vel), 0, n - 2), additionally window-limited."""
    Z, Y, X = shape[2:]
    dev = vel_x.device

    def one(n, axis, v):
        iidx = _iota(n, axis, torch.int32, dev)
        c = torch.trunc(iidx.to(v.dtype) + sign * v).to(torch.int32)
        c = torch.minimum(torch.maximum(c, iidx - W), iidx + W)
        return c.clamp(0, n - 2)
    cx = one(X, 3, vel_x)
    cy = one(Y, 2, vel_y)
    cz = one(Z, 1, vel_z) if is_3d else torch.zeros_like(cx)
    return cx, cy, cz


def _lookup_bad(vel_x, vel_y, vel_z, flags, is_3d, W, plain):
    """Out-of-grid / into-obstacle test of the Manta clamp reverts
    (tfluids.cc:304-322), both lookup directions."""
    Z, Y, X = flags.shape[2:]
    dev = flags.device
    f32 = torch.float32
    ii, jj, kk = (_iota(X, 3, f32, dev), _iota(Y, 2, f32, dev),
                  _iota(Z, 1, f32, dev))
    ob = is_obstacle(flags).to(f32)
    bad = None
    for sign in (-1.0, 1.0):
        px = torch.trunc(ii + 0.5 + sign * vel_x).to(torch.int32)
        py = torch.trunc(jj + 0.5 + sign * vel_y).to(torch.int32)
        pz = torch.trunc(kk + 0.5 + sign * vel_z).to(torch.int32)
        oob = (px < 0) | (py < 0) | (px > X - 1) | (py > Y - 1)
        if is_3d:
            oob = oob | (pz < 0) | (pz > Z - 1)

        def win(p, iota):
            i = iota.to(torch.int32)
            return torch.minimum(torch.maximum(p, i - W), i + W)
        cx = win(px, ii).clamp(0, X - 1)
        cy = win(py, jj).clamp(0, Y - 1)
        cz = win(pz, kk).clamp(0, Z - 1) if is_3d else torch.zeros_like(cx)
        obs = gather_cells(ob, cx, cy, cz, W, plain=plain)[:, 0] > 0.5
        this = oob | (~oob & obs)
        bad = this if bad is None else (bad | this)
    return bad


def advect_scalar_fast(dt, s, u, flags, method, sample_outside_fluid,
                       maccormack_strength, window, free=None, border=None,
                       plain=False):
    """Windowed scalar advection (advect_fast.py:176-278): s (b, 1, z, y,
    x) by the MAC velocity u; every interpolation through K5. Returns the
    advected s."""
    is_3d = check_shapes(u, flags, s)
    W = int(window)
    if W < 1:
        raise ValueError(f"advect: window must be >= 1, got {window}")
    s = s.contiguous()   # a channel slice of a batched density is not
    dev = s.device
    if border is None:
        border = border_mask(flags.shape, is_3d, 1, dev)
    fl = is_fluid(flags)

    def apply_border(x):
        return torch.where(border, 0.0, x)

    ours = method.endswith("Ours")
    if ours and free is None:
        free = chebyshev_free_space(flags, W + 1)

    if method in ("euler", "eulerOurs", "rk2Ours", "rk3Ours"):
        # rk2/rk3 reduce to the clamped Euler backtrace (advect_fast.py:192).
        px, py, pz = _euler_pos_scalar(s, u, flags, dt, is_3d, W, ours, free)
        val = _sample_scalar_fast(s, flags, px, py, pz,
                                  sample_outside_fluid or not ours, W, plain)
        if ours:
            val = torch.where(fl, val, s)
        return apply_border(val)
    if method not in ("maccormack", "maccormackOurs"):
        raise ValueError(f"bad advection method {method!r}")

    px, py, pz = _euler_pos_scalar(s, u, flags, dt, is_3d, W, ours, free)
    if ours:
        # Fused forward sweep: the clamp bounds ride the interpolation as
        # support min/max; non-fluid cells warp their own centres
        # (tfluids.cc:157-160), so one position set serves values and
        # bounds.
        cpx, cpy, cpz = _positions(s.shape, s.shape[0], s.dtype, dev)
        flm = fl[:, 0]
        px = torch.where(flm, px, cpx)
        py = torch.where(flm, py, cpy)
        pz = torch.where(flm, pz, cpz)
        if sample_outside_fluid:
            o1 = warp_group(s[:, None], px[:, None], py[:, None],
                            pz[:, None], W, minmax=True, plain=plain)[:, 0]
            fwd_full, mn, mx = o1[:, 0:1], o1[:, 1:2], o1[:, 2:3]
            have = None
        else:
            m = fl.to(s.dtype)
            bmin = torch.where(fl, s, _BIG)
            bmax = torch.where(fl, s, -_BIG)
            srcs = tuple(a[:, None] for a in (bmin, bmax, s, s * m, m))
            o1 = warp_group(srcs, px[:, None], py[:, None], pz[:, None], W,
                            minmax=(0, 1), plain=plain)[:, 0]
            plain_v, num, den = o1[:, 2:3], o1[:, 3:4], o1[:, 4:5]
            safe = den > 1e-6
            fwd_full = torch.where(safe, num / torch.where(safe, den, 1.0),
                                   plain_v)
            mn, mx = o1[:, 5:6], o1[:, 6:7]
            have = mn < _BIG * 0.5
        fwd_full = torch.where(fl, fwd_full, s)
    else:
        fwd_full = _sample_scalar_fast(s, flags, px, py, pz, True, W, plain)
    fwd = apply_border(fwd_full)
    bx, by, bz = _euler_pos_scalar(fwd, u, flags, -dt, is_3d, W, ours, free)
    bwd_full = _sample_scalar_fast(fwd, flags, bx, by, bz,
                                   sample_outside_fluid or not ours, W, plain)
    if ours:
        bwd_full = torch.where(fl, bwd_full, fwd)
    bwd = apply_border(bwd_full)
    dst = fwd + torch.where(fl, maccormack_strength * 0.5 * (s - bwd), 0.0)

    if method == "maccormack":
        # Manta clamp: corner min/max around both lookups + revert tests.
        cent = get_centered(u, is_3d)
        vx, vy, vz = cent[:, 0] * dt, cent[:, 1] * dt, cent[:, 2] * dt
        mn2, mx2 = _corner_minmax_fields(s, is_3d)
        packed = torch.cat([mn2, mx2], dim=1)
        mn = mx = None
        for sign in (-1.0, 1.0):
            cx, cy, cz = _clamp_lookup_cells(vx, vy, vz, sign, flags.shape,
                                             is_3d, W)
            g = gather_cells(packed, cx, cy, cz, W, plain=plain)
            mn = g[:, 0:1] if mn is None else torch.minimum(mn, g[:, 0:1])
            mx = g[:, 1:2] if mx is None else torch.maximum(mx, g[:, 1:2])
        clamped = torch.minimum(torch.maximum(dst, mn), mx)
        bad = _lookup_bad(vx, vy, vz, flags, is_3d, W, plain)[:, None]
        clamped = torch.where(bad, fwd, clamped)
        return torch.where(border, dst, clamped)

    # maccormackOurs: no fluid corner in the support -> revert to fwd (the
    # cnt == 0 rule of getClampBounds, tfluids.cc:124-166).
    clamped = torch.minimum(torch.maximum(dst, mn), mx)
    if have is not None:
        clamped = torch.where(have, clamped, fwd)
    return torch.where(border, dst, clamped)


# --- MAC velocity self-advection ---------------------------------------------

def _mac_positions(u, flags, dt, is_3d, W, ours, free=None):
    """Per-component backtrace positions, each (b, c, z, y, x) (2-D; the
    3-D sweep computes its positions in-kernel)."""
    macs = [get_at_mac_x(u, is_3d), get_at_mac_y(u, is_3d)]
    px, py, pz = _positions(u.shape, u.shape[0], u.dtype, u.device)
    pxs, pys, pzs = [], [], []
    for mac in macs:
        dx, dy, dz = -dt * mac[:, 0], -dt * mac[:, 1], -dt * mac[:, 2]
        if ours:
            dx, dy, dz = _trace_clamp(flags, dx, dy, dz, W, free)
        dx, dy, dz = clamp_displacement(dx, dy, dz, W)
        pxs.append(px + dx)
        pys.append(py + dy)
        pzs.append(pz + dz)
    return (torch.stack(pxs, 1), torch.stack(pys, 1), torch.stack(pzs, 1))


def advect_vel_fast(dt, u, flags, method, maccormack_strength, window,
                    free=None, border=None, plain=False):
    """Windowed MAC velocity self-advection (advect_fast.py:304-391). 3-D
    runs K1's unfused velocity sweep (mac_vel_sweep), one launch per sweep
    with the positions in-kernel; 2-D one K5 launch per sweep with
    per-component positions (G = 2). MacCormack sweeps carry the clamp
    bounds of u as support min/max. Returns the advected u."""
    from fluidnet_tpu_torch.ops.advect import _maccormack_correct_mac
    from fluidnet_tpu_torch.ops.cuda.mac_sweep import mac_vel_sweep

    is_3d = check_shapes(u, flags)
    W = int(window)
    if W < 1:
        raise ValueError(f"advect: window must be >= 1, got {window}")
    u = u.contiguous()
    if method in ("rk2Ours", "rk3Ours"):
        method = "maccormackOurs"  # tfluids.cc:799-802
    if method not in ("euler", "eulerOurs", "maccormack", "maccormackOurs"):
        raise ValueError(f"bad advection method {method!r}")
    if border is None:
        border = border_mask(flags.shape, is_3d, 1, u.device)
    fl = is_fluid(flags)
    ours = method.endswith("Ours")
    if ours and free is None:
        free = chebyshev_free_space(flags, W + 1)
    free_in = free if ours else None

    def apply_border(x):
        return torch.where(border, 0.0, x)

    def positions(dt_):
        return _mac_positions(u, flags, dt_, is_3d, W, ours, free)

    if method in ("euler", "eulerOurs"):
        if is_3d:
            out = mac_vel_sweep(u, None, free_in, -dt, W, ours,
                                plain=plain)[0]
        else:
            out = warp_trilinear(u, *positions(dt), W, plain=plain)
        if ours:
            out = torch.where(fl, out, u)
        return apply_border(out)

    # MacCormack: the forward (-dt) and backward (+dt) sweeps visit the
    # clamp-lookup cells of MacCormackClampMAC's two directions, so each
    # emits min/max of u over its corner support.
    if is_3d:
        w1, mn_f, mx_f = mac_vel_sweep(u, None, free_in, -dt, W, ours,
                                       plain=plain)
    else:
        o1 = warp_group(u[:, :, None], *positions(dt), W, minmax=True,
                        plain=plain)
        w1, mn_f, mx_f = o1[:, :, 0], o1[:, :, 1], o1[:, :, 2]
    fwd = torch.where(fl, w1, u) if ours else w1
    fwd = apply_border(fwd)
    if is_3d:
        w2, mn_b, mx_b = mac_vel_sweep(u, fwd.contiguous(), free_in, dt, W,
                                       ours, plain=plain)
    else:
        # Channel 0 stays u (the bounds' source), channel 1 is the forward
        # field; two sources, no stacked copy.
        o2 = warp_group((u[:, :, None], fwd[:, :, None]), *positions(-dt),
                        W, minmax=True, plain=plain)
        w2, mn_b, mx_b = o2[:, :, 1], o2[:, :, 2], o2[:, :, 3]
    bwd = torch.where(fl, w2, fwd) if ours else w2
    bwd = apply_border(bwd)

    dst = _maccormack_correct_mac(u, fwd, bwd, flags, maccormack_strength,
                                  is_3d)
    mn = torch.minimum(mn_f, mn_b)
    mx = torch.maximum(mx_f, mx_b)
    # jnp.clip's gradient (ties split), not torch.clamp's.
    clamped = torch.minimum(torch.maximum(dst, mn), mx)
    return torch.where(border, dst, clamped)


def _fused_impl(dt, s, u, flags, free, method, maccormack_strength, W,
                ours, renorm, plain):
    """The fused-epilogue primal (advect_fast.py:406-444): one K1 launch
    per sweep, the final two-direction clamp in PyTorch."""
    sweep = sweep_fused_ep_plain if plain or u.device.type == "cpu" \
        else advect_sweep_fused_ep
    m = is_fluid(flags).to(s.dtype)
    o1 = sweep(u, s, m, None, None, free if ours else None, -dt,
               maccormack_strength, W, ours, renorm)
    fwd_u, fwd_s = o1["u_w"], o1["s_val"]
    if method != "maccormackOurs":
        return fwd_s, fwd_u

    o2 = sweep(u, s, m, fwd_u.contiguous(), fwd_s.contiguous(), free, dt,
               maccormack_strength, W, ours, renorm)
    dst_u, dst_s = o2["u_w"], o2["s_val"]
    border = border_mask(flags.shape, True, 1, u.device)
    mn = torch.minimum(o1["u_mn"], o2["u_mn"])
    mx = torch.maximum(o1["u_mx"], o2["u_mx"])
    u_new = torch.where(border, dst_u, torch.minimum(
        torch.maximum(dst_u, mn), mx))
    clamped = torch.minimum(torch.maximum(dst_s, o1["s_mn"]), o1["s_mx"])
    if renorm:
        # No fluid corner in the support -> revert to the forward value
        # (the cnt == 0 rule of getClampBounds, tfluids.cc:124-166).
        clamped = torch.where(o1["s_mn"] < 1e29, clamped, fwd_s)
    s_new = torch.where(border, dst_s, clamped)
    return s_new, u_new


def _unfused_impl(dt, s, u, flags, free, method, maccormack_strength, W,
                  ours, renorm, plain):
    """The unfused composition (advect_fast.py:506-583) on K1's unfused
    sweeps: the raw channels, with the masks, the renorm combine and the
    MacCormack correction in PyTorch. Every clamp is
    minimum(maximum(.)), whose gradient splits ties as jnp.clip's does."""
    from fluidnet_tpu_torch.ops.advect import _maccormack_correct_mac
    from fluidnet_tpu_torch.ops.cuda.mac_sweep import advect_sweep

    border = border_mask(flags.shape, True, 1, u.device)
    fl = is_fluid(flags)
    free_in = free if ours else None
    m = fl.to(s.dtype)
    vel_mac = method in ("maccormack", "maccormackOurs", "rk2Ours",
                         "rk3Ours")
    scal_mac = method == "maccormackOurs"

    def apply_border(x):
        return torch.where(border, 0.0, x)

    def s_value(o):
        if not renorm:
            return o["s_plain"]
        den = o["s_den"]
        safe = den > 1e-6
        return torch.where(safe, o["s_num"] / torch.where(safe, den, 1.0),
                           o["s_plain"])

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    o1 = advect_sweep(u, s, m, None, None, free_in, -dt, W, ours, True,
                      renorm, plain=plain)
    fwd_u = torch.where(fl, o1["u_w"], u) if ours else o1["u_w"]
    fwd_u = apply_border(fwd_u)
    fwd_s_full = s_value(o1)
    if ours:
        fwd_s_full = torch.where(fl, fwd_s_full, s)
    fwd_s = apply_border(fwd_s_full)
    if not vel_mac:                       # euler / eulerOurs
        return fwd_s, fwd_u

    o2 = advect_sweep(u, None, m if scal_mac else None, fwd_u,
                      fwd_s if scal_mac else None, free_in, dt, W, ours,
                      scal_mac, renorm, plain=plain)
    bwd_u = torch.where(fl, o2["u_w"], fwd_u) if ours else o2["u_w"]
    bwd_u = apply_border(bwd_u)
    dst_u = _maccormack_correct_mac(u, fwd_u, bwd_u, flags,
                                    maccormack_strength, True)
    mn = torch.minimum(o1["u_mn"], o2["u_mn"])
    mx = torch.maximum(o1["u_mx"], o2["u_mx"])
    u_new = torch.where(border, dst_u, clip(dst_u, mn, mx))
    if not scal_mac:                      # rk2Ours/rk3Ours scalar = euler
        return fwd_s, u_new
    bwd_s_full = s_value(o2)
    if ours:
        bwd_s_full = torch.where(fl, bwd_s_full, fwd_s)
    bwd_s = apply_border(bwd_s_full)
    dst_s = fwd_s + torch.where(fl, maccormack_strength * 0.5 *
                                (s - bwd_s), 0.0)
    clamped = clip(dst_s, o1["s_mn"], o1["s_mx"])
    if renorm:
        clamped = torch.where(o1["s_mn"] < 1e29, clamped, fwd_s)
    return torch.where(border, dst_s, clamped), u_new


def advect_vel_scalar_fast(dt, s, u, flags, method, sample_outside_fluid,
                           maccormack_strength, window, free=None,
                           fused_epilogue=True, plain=False):
    """Combined scalar + MAC-velocity advection (3-D), JAX
    advect_fast.py:483-583. With `fused_epilogue` (the JAX default) the
    methods maccormackOurs, euler and eulerOurs run one fused K1 launch
    per sweep, and their gradient with respect to (s, u) replays the
    unfused composition, as the JAX custom VJP does (_fused_step_bwd); dt
    gets none. Otherwise, and for rk2Ours / rk3Ours, the unfused
    composition runs on K1's unfused sweeps, whose gradient is K6. `free`:
    the Chebyshev free space for 'Ours' methods (computed here if None;
    constant while the flags are). `plain=True` runs the plain versions of
    the kernels on any device. Returns (s_new, u_new)."""
    from fluidnet_tpu_torch.ops.replay import replay

    if not check_shapes(u, flags, s):
        raise NotImplementedError("the fused combined advection is 3-D "
                                  "only; 2-D runs advect_scalar_fast and "
                                  "advect_vel_fast")
    if method == "maccormack" or method not in (
            "euler", "eulerOurs", "maccormackOurs", "rk2Ours", "rk3Ours"):
        raise ValueError(f"advection method {method!r}: the Manta scalar "
                         f"clamp is not fused; use advect_scalar_fast and "
                         f"advect_vel_fast")
    W = int(window)
    if W < 1:
        raise NotImplementedError("the exact gather path (window 0) is not "
                                  "ported yet (ROADMAP queue 1, ops off "
                                  "the main path)")
    ours = method.endswith("Ours")
    if ours and free is None:
        free = chebyshev_free_space(flags, W + 1)
    renorm = ours and not sample_outside_fluid
    s, u = s.contiguous(), u.contiguous()
    args = (flags, free, method, maccormack_strength, W, ours, renorm,
            plain)

    def unfused(s_, u_):
        return _unfused_impl(dt, s_, u_, *args)
    if fused_epilogue and method in _FUSED_METHODS:
        return replay(lambda s_, u_: _fused_impl(dt, s_, u_, *args),
                      unfused, s, u)
    return unfused(s, u)
