"""The windowed warp: semi-Lagrangian interpolation of grouped fields.

Port of fluidnet_tpu.ops.pallas.warp's public API (warp_group,
warp_trilinear, warp_trilinear_shared, warp_fluid, gather_cells,
clamp_displacement), with the JAX signatures. Every call reaches
`warp_group`, which launches kernel K5 (ops/cuda/warp.py, csrc/warp.cu) on
CUDA tensors and runs the plain PyTorch version `warp_group_plain` below on
CPU tensors; `plain=True` runs the plain version on any device (the
reference the kernel is checked against). Its gradient with respect to the
fields is the transposed warp, kernel K6 (ops/cuda/warp_transpose.py), or
K6's plain version with `plain`; the positions get none, as in JAX.

Semantics (warp.py:75-111, 159-282): per axis p = pos - 0.5 and the
BUILD_INDEX corners i = floor(p), i + 1 with weights 1 - (p - i), p - i;
p < 0 takes corner 0 with weight 1, i >= n - 1 corners {n-2, n-1} with
weights {0, 1}. A corner more than `window` cells from the output cell
contributes nothing, nor does corner i + 1 when corner i is that far (the
TPU kernel's tap window). Nearest mode reads the one cell clip(floor(p), 0,
n - 1). 2-D grids (z == 1) ignore pz. Channels accumulate over the corners
z, y, x ascending as acc + v * ((wz * wy) * wx); min/max run over the
support corners, zero-weight ones included.

Every entry takes a z origin `z0` (default 0), the global index of the
array's first z plane (a slab of a z-sharded grid): pz is then global, the
clamps sit at z0 and z0 + z - 1, the window test compares with the global
cell z0 + k, and a corner's plane in the array is its global index less
z0, so a slab warps its planes as the whole grid does, to the bit.
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.ops.cuda.warp import warp_group_cuda
from fluidnet_tpu_torch.ops.cuda.warp_transpose import warp_transpose
from fluidnet_tpu_torch.ops.replay import needs_grad

DEFAULT_WINDOW = 2


def _axis_corners(pos, n, iota, W, nearest, lo=0):
    """[(index along the axis, weight, in window)] for the 1 (nearest) or
    2 corners of one axis of n cells whose first is global index lo (pos
    and iota, the output cells, global)."""
    p = pos - 0.5
    i = torch.floor(p)
    if nearest:
        i = i.clamp(lo, lo + n - 1)
        cands = [(i, None)]
    else:
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
        cands = [(i, w0), (i + 1.0, w1)]
    out, ok = [], True
    for c, w in cands:
        # The upper corner counts only while the base corner does.
        ok = ok & ((c - iota).abs() <= W) & (c >= lo) & (c <= lo + n - 1)
        out.append((torch.where(ok, c - lo, 0.0).long(), w, ok))
    return out


def warp_group_plain(fields, px, py, pz, window, nearest=False,
                     minmax=False, z0=0):
    """Plain PyTorch version of K5 (runs on any device): the arguments and
    result of warp_group."""
    fs = list(fields) if isinstance(fields, tuple) else [fields]
    b, G, _, Z, Y, X = fs[0].shape
    src = torch.cat(fs, dim=2) if len(fs) > 1 else fs[0]
    F = src.shape[2]
    W = int(window)
    if nearest and minmax:
        raise ValueError("warp: nearest mode takes no min/max")
    dev, f32 = src.device, torch.float32
    ii = torch.arange(X, device=dev, dtype=f32).view(1, 1, 1, 1, X)
    jj = torch.arange(Y, device=dev, dtype=f32).view(1, 1, 1, Y, 1)
    kk = torch.arange(z0, z0 + Z, device=dev, dtype=f32).view(1, 1, Z, 1, 1)
    xs = _axis_corners(px, X, ii, W, nearest)
    ys = _axis_corners(py, Y, jj, W, nearest)
    if Z > 1:
        zs = _axis_corners(pz, Z, kk, W, nearest, z0)
    else:
        zs = [(torch.zeros((), dtype=torch.long, device=dev), None,
               torch.ones((), dtype=torch.bool, device=dev))]

    pair = isinstance(minmax, tuple)
    cmin, cmax = (minmax if pair else (0, 0)) if minmax else (None, None)
    skip = {cmin, cmax} if pair else set()
    flat = src.reshape(b, G, F, Z * Y * X)
    acc = torch.zeros((b, G, F, Z, Y, X), dtype=f32, device=dev)
    mn = torch.full((b, G, Z, Y, X), float("inf"), dtype=f32, device=dev)
    mx = torch.full((b, G, Z, Y, X), float("-inf"), dtype=f32, device=dev)
    keep = torch.tensor([f not in skip for f in range(F)], device=dev)
    keep = keep.view(1, 1, F, 1, 1, 1)
    for kz, wz, okz in zs:
        for ky, wy, oky in ys:
            # 2-D: wz is 1, and 1 * wy == wy.
            wzy = wy if wz is None else wz * wy
            for kx, wx, okx in xs:
                idx = ((kz * Y + ky) * X + kx).expand(b, G, Z, Y, X)
                v = torch.gather(flat, 3, idx.reshape(b, G, 1, -1).expand(
                    b, G, F, Z * Y * X)).view(b, G, F, Z, Y, X)
                ok = (okz & oky & okx).expand(b, G, Z, Y, X)
                # Nearest mode: the one corner has weight 1.
                term = v if nearest else v * (wzy * wx)[:, :, None]
                acc = torch.where(ok[:, :, None] & keep, acc + term, acc)
                if minmax:
                    mn = torch.where(ok, torch.minimum(mn, v[:, :, cmin]), mn)
                    mx = torch.where(ok, torch.maximum(mx, v[:, :, cmax]), mx)
    if minmax:
        return torch.cat([acc, mn[:, :, None], mx[:, :, None]], dim=2)
    return acc


def _warp_forward(fs, px, py, pz, window, nearest, minmax, plain, z0):
    fields = tuple(fs) if len(fs) > 1 else fs[0]
    if plain or fs[0].device.type == "cpu":
        return warp_group_plain(fields, px, py, pz, window, nearest, minmax,
                                z0)
    return warp_group_cuda(fields, px, py, pz, window, nearest, minmax, z0)


class _WarpGroup(torch.autograd.Function):
    """The warp with the JAX VJP (_warp_group_bwd, warp.py:565-578): the
    fields' gradient is the transposed warp (K6, or its plain version with
    `plain`), the positions get none."""

    @staticmethod
    def forward(ctx, opts, px, py, pz, *fs):
        ctx.opts = opts
        ctx.Fs = [f.shape[2] for f in fs]
        ctx.save_for_backward(px, py, pz)
        return _warp_forward(fs, px, py, pz, *opts)

    @staticmethod
    def backward(ctx, g):
        window, nearest, _, plain, z0 = ctx.opts
        px, py, pz = ctx.saved_tensors
        grad = warp_transpose(g[:, :, :sum(ctx.Fs)].contiguous(), px, py, pz,
                              window, nearest, plain=plain, z0=z0)
        return (None, None, None, None) + tuple(torch.split(grad, ctx.Fs, 2))


def warp_group(fields, px, py, pz, window: int = DEFAULT_WINDOW,
               nearest: bool = False, minmax=False, *, plain: bool = False,
               z0: int = 0):
    """Raw grouped interface: fields (b, G, F, z, y, x), or a tuple of such
    sources whose channels concatenate; positions (b, G, z, y, x) shared by
    the channels of a group. minmax=True appends min and max of channel 0
    over the corner support; a (cmin, cmax) pair appends min of channel
    cmin and max of channel cmax, which are then bound sources (+-1e30
    sentinels), not accumulated and returned as zeros. Returns
    (b, G, F [+2], z, y, x). CUDA tensors launch K5, CPU tensors (or
    plain=True) run warp_group_plain; the gradient with respect to the
    fields is the transposed warp (K6 or its plain version). z0: the z
    origin (the module's note)."""
    fs = tuple(fields) if isinstance(fields, tuple) else (fields,)
    opts = (int(window), bool(nearest), minmax, plain, int(z0))
    if needs_grad(*fs):
        return _WarpGroup.apply(opts, px, py, pz, *fs)
    return _warp_forward(fs, px, py, pz, *opts)


def warp_trilinear(fields, px, py, pz, window: int = DEFAULT_WINDOW, *,
                   plain: bool = False, z0: int = 0):
    """Per-channel positions: fields (b, c, z, y, x), px/py/pz
    (b, c, z, y, x). Returns (b, c, z, y, x)."""
    return warp_group(fields[:, :, None], px, py, pz, window,
                      plain=plain, z0=z0)[:, :, 0]


def warp_trilinear_shared(fields, px, py, pz, window: int = DEFAULT_WINDOW,
                          *, plain: bool = False, z0: int = 0):
    """Shared positions for every channel: px/py/pz are (b, z, y, x)."""
    return warp_group(fields[:, None], px[:, None], py[:, None],
                      pz[:, None], window, plain=plain, z0=z0)[:, 0]


def warp_fluid(src, flags, px, py, pz, window: int = DEFAULT_WINDOW, *,
               plain: bool = False, z0: int = 0):
    """Fluid-aware interpolation, mask-renormalized (warp.py:695-717):
    sum(w m v) / sum(w m) where the fluid weight exceeds 1e-6, else plain
    trilinear. src (b, 1, z, y, x). The three sources go to one launch."""
    m = is_fluid(flags).to(src.dtype)
    out = warp_group((src[:, None], (src * m)[:, None], m[:, None]),
                     px[:, None], py[:, None], pz[:, None], window,
                     plain=plain, z0=z0)[:, 0]
    plain_v, num, den = out[:, 0:1], out[:, 1:2], out[:, 2:3]
    safe = den > 1e-6
    return torch.where(safe, num / torch.where(safe, den, 1.0), plain_v)


def gather_cells(fields, xi, yi, zi, window: int = DEFAULT_WINDOW, *,
                 plain: bool = False, z0: int = 0):
    """Windowed integer-cell gather fields[..., zi - z0, yi, xi] (nearest
    mode; zi global from the z origin z0); a cell more than `window` from
    the output cell reads 0. fields (b, c, z, y, x); xi/yi/zi (b, z, y, x)
    integers."""
    px = xi.to(torch.float32) + 0.5
    py = yi.to(torch.float32) + 0.5
    pz = zi.to(torch.float32) + 0.5
    return warp_group(fields[:, None], px[:, None], py[:, None],
                      pz[:, None], window, True, plain=plain, z0=z0)[:, 0]


def clamp_displacement(dx, dy, dz, window: int, margin: float = 1e-3):
    """Clamps per-axis displacements to +-(window - margin) cells, so every
    interpolation corner stays in the window (the kernel's contract)."""
    lim = window - margin
    return (dx.clamp(-lim, lim), dy.clamp(-lim, lim), dz.clamp(-lim, lim))
