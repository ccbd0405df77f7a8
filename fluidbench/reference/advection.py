"""Frozen copy of the plain PyTorch ops of fluidnet_tpu_torch at commit
a3725f6 (ops/replay.py, ops/cuda/warp_transpose.py,
ops/cuda/mac_sweep.py, ops/advect.py, ops/advect_fast.py), kept here so
that the benchmark's reference does not move with the program. Edits:
the kernel dispatch is gone (every op runs its plain version, on any
device), and the grid masks are built on the device they are asked for.
"""

import torch

from fluidbench.reference import grid as st
from fluidbench.reference.grid import border_mask, check_shapes, is_fluid
from fluidbench.reference.physics import (cell_center_positions,
                                          get_at_mac_x, get_at_mac_y,
                                          get_at_mac_z, get_centered)


class _Replay(torch.autograd.Function):

    @staticmethod
    def forward(ctx, kernel, ref, *xs):
        ctx.ref = ref
        ctx.save_for_backward(*xs)
        return kernel(*xs)

    @staticmethod
    def backward(ctx, *grads):
        xs = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inp = [x.detach().requires_grad_(n) for x, n in zip(xs, need)]
            outs = ctx.ref(*inp)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x, n in zip(inp, need) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wrt, [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and wrt else [None] * len(wrt))
        return (None, None) + tuple(next(got) if n else None for n in need)


def needs_grad(*xs):
    """Whether autograd records a function of the tensors xs (None allowed).
    The kernels' autograd.Functions are skipped otherwise: their host cost
    per call counts on the host-bound inference steps."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def replay(kernel, ref, *xs):
    """kernel(*xs), whose gradient with respect to the tensors xs is that of
    ref(*xs). Both return a tensor or a tuple of tensors of the same
    shapes."""
    if not needs_grad(*xs):
        return kernel(*xs)
    return _Replay.apply(kernel, ref, *xs)


def _taps(pos, n, iota, W, nearest, keep_low, lo=0):
    """Per source cell, the weight its corner along one axis gives the
    target at offset o = t - s, for o = -W..W (the kernel's `tap`); the
    axis's first cell is global index lo, and pos and iota (the sources'
    cells) are global."""
    p = pos - 0.5
    i = torch.floor(p)
    if nearest:
        i = i.clamp(lo, lo + n - 1)
        return [(i == iota + o).to(p.dtype) for o in range(-W, W + 1)]
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
    out = []
    for o in range(-W, W + 1):
        ind0 = (i == iota + o).to(p.dtype)
        ind1 = ((i + 1.0 == iota + o) & (keep_low or o > -W)).to(p.dtype)
        out.append(w0 * ind0 + w1 * ind1)
    return out


def warp_transpose_plain(g, px, py, pz, window, nearest=False, z0=0):
    """Plain PyTorch version of K6 (runs on any device): g (b, G, F, Z, Y,
    X), positions (b, G, Z, Y, X), pz global from the z origin z0
    (ops/warp.py). Returns the gradient of the warped fields, shaped like
    g."""
    b, G, F, Z, Y, X = g.shape
    W = int(window)
    dev, f32 = g.device, torch.float32
    ii = torch.arange(X, device=dev, dtype=f32).view(1, 1, 1, 1, X)
    jj = torch.arange(Y, device=dev, dtype=f32).view(1, 1, 1, Y, 1)
    kk = torch.arange(z0, z0 + Z, device=dev, dtype=f32).view(1, 1, Z, 1, 1)
    wx = _taps(px, X, ii, W, nearest, False)
    wy = _taps(py, Y, jj, W, nearest, False)
    wz = _taps(pz, Z, kk, W, nearest, True, z0) if Z > 1 else None
    grad = torch.zeros_like(g)
    for ozi, oz in enumerate(range(-W, W + 1) if Z > 1 else [0]):
        for oyi, oy in enumerate(range(-W, W + 1)):
            for oxi, ox in enumerate(range(-W, W + 1)):
                v = g if wz is None else g * wz[ozi][:, :, None]
                t = (v * wy[oyi][:, :, None]) * wx[oxi][:, :, None]
                # grad(s + o) += t(s).
                t = st.shift(st.shift(st.shift(t, -oz, -3), -oy, -2), -ox,
                             -1)
                grad = grad + t
    return grad


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
    return sweep_plain(u, s, m, fwd_u, fwd_s, free, dcoef, window, ours,
                       with_scalar, renorm, z0)


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
        grad_uw = warp_transpose_plain(
            cots["u_w"][:, :, None].contiguous(), px, py, pz, window, False,
            z0=z0)[:, :, 0]
        grad_sval = None
        if with_scalar:
            mask = m if (not is_bwd and ours) else None
            cpx, cpy, cpz = positions_for_vjp(u_c, free, dcoef, window, ours,
                                              center=True, m=mask, z0=z0)
            if renorm:
                g_sc = torch.stack([cots["s_plain"], cots["s_num"]], 1)
                gt = warp_transpose_plain(
                    g_sc.contiguous(), cpx.repeat(1, 2, 1, 1, 1),
                    cpy.repeat(1, 2, 1, 1, 1), cpz.repeat(1, 2, 1, 1, 1),
                    window, False, z0=z0)
                grad_sval = gt[:, 0] + m * gt[:, 1]
            else:
                grad_sval = warp_transpose_plain(
                    cots["s_plain"][:, :, None].contiguous(), cpx, cpy, cpz,
                    window, False, z0=z0)[:, :, 0]
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


def _maccormack_correct_mac(old, fwd, bwd, flags, strength, is_3d):
    """MacCormackCorrectMAC (tfluids.cc:660-699): per component, skip where
    the cell or its -axis neighbour is non-fluid; the neighbour counts as
    fluid at the low edge (the reference tests it only for i > 0)."""
    fl = is_fluid(flags)[:, 0]
    skip_all = ~fl
    skips = [skip_all | ~st.xm(fl, True), skip_all | ~st.ym(fl, True)]
    if is_3d:
        skips.append(skip_all | ~st.zm(fl, True))
    comps = []
    for c, skip in enumerate(skips):
        corr = fwd[:, c] + strength * 0.5 * (old[:, c] - bwd[:, c])
        comps.append(torch.where(skip, fwd[:, c], corr))
    return torch.stack(comps, dim=1)


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


def _fused_impl(dt, s, u, flags, free, method, maccormack_strength, W,
                ours, renorm, plain, z0):
    """The fused-epilogue primal (advect_fast.py:406-444): one K1 launch
    per sweep, the final two-direction clamp in PyTorch."""
    sweep = sweep_fused_ep_plain
    m = is_fluid(flags).to(s.dtype)
    o1 = sweep(u, s, m, None, None, free if ours else None, -dt,
               maccormack_strength, W, ours, renorm, z0)
    fwd_u, fwd_s = o1["u_w"], o1["s_val"]
    if method != "maccormackOurs":
        return fwd_s, fwd_u

    o2 = sweep(u, s, m, fwd_u.contiguous(), fwd_s.contiguous(), free, dt,
               maccormack_strength, W, ours, renorm, z0)
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
                  ours, renorm, plain, z0):
    """The unfused composition (advect_fast.py:506-583) on K1's unfused
    sweeps: the raw channels, with the masks, the renorm combine and the
    MacCormack correction in PyTorch. Every clamp is
    minimum(maximum(.)), whose gradient splits ties as jnp.clip's does."""
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
                      renorm, plain=plain, z0=z0)
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
                      scal_mac, renorm, plain=plain, z0=z0)
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
                           fused_epilogue=True, plain=False, z0=0):
    """Combined scalar + MAC-velocity advection (3-D), JAX
    advect_fast.py:483-583. With `fused_epilogue` (the JAX default) the
    methods maccormackOurs, euler and eulerOurs run one fused K1 launch
    per sweep, and their gradient with respect to (s, u) replays the
    unfused composition, as the JAX custom VJP does (_fused_step_bwd); dt
    gets none. Otherwise, and for rk2Ours / rk3Ours, the unfused
    composition runs on K1's unfused sweeps, whose gradient is K6. `free`:
    the Chebyshev free space for 'Ours' methods (computed here if None;
    constant while the flags are). `plain=True` runs the plain versions of
    the kernels on any device. z0: the z origin of a slab (the module's
    note), which the gradient's replay and K6 take too. Returns (s_new,
    u_new)."""
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
        raise NotImplementedError("the combined advection is windowed (W "
                                  ">= 1); window 0 is the exact path of "
                                  "ops.advect (advect_scalar, advect_vel)")
    ours = method.endswith("Ours")
    if ours and free is None:
        free = chebyshev_free_space(flags, W + 1)
    renorm = ours and not sample_outside_fluid
    s, u = s.contiguous(), u.contiguous()
    args = (flags, free, method, maccormack_strength, W, ours, renorm,
            plain, int(z0))

    def unfused(s_, u_):
        return _unfused_impl(dt, s_, u_, *args)
    if fused_epilogue and method in _FUSED_METHODS:
        return replay(lambda s_, u_: _fused_impl(dt, s_, u_, *args),
                      unfused, s, u)
    return unfused(s, u)
