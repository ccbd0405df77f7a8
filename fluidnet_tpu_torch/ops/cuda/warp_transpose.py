"""K6: the adjoint of the windowed warp, launched on the card.

Replaces fluidnet_tpu/ops/pallas/warp.py::_warp_transpose_kernel
(_warp_transpose_pallas). The CUDA kernel is csrc/warp_transpose.cu; its
source note gives the per-cell work (a sum over the (2W+1)^d source
offsets in a fixed order, no atomics), what bounds it on the H100 (memory
traffic, 20 B/cell per field group) and the design (a 32 x 8 tile of
targets plus the window's halo of sources staged in shared memory; each
source pushes its terms into per-(target, offset) slots).

`warp_transpose` is the backward of ops/warp.py::warp_group (K5) and of K1's
unfused sweeps (ops/cuda/mac_sweep.py): CUDA tensors launch the kernel,
CPU tensors (or plain=True) run `warp_transpose_plain`. One call is one
launch, counted in _build.launches["warp_transpose"].
"""

import ctypes

import torch

from fluidnet_tpu_torch.ops import stencil as st
from fluidnet_tpu_torch.ops.cuda import _build

MAX_CHANNELS = 8   # csrc/warp_transpose.cu kMaxF


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


def warp_transpose_cuda(g, px, py, pz, window, nearest=False, z0=0):
    """Launches K6: same arguments and result as warp_transpose_plain."""
    if g.dim() != 6:
        raise ValueError("warp_transpose: g must be (b, G, F, Z, Y, X)")
    b, G, F, Z, Y, X = g.shape
    f32 = torch.float32
    dev = _build.require_cuda("warp_transpose", g, px, py, pz,
                              dtypes=[f32] * 4)
    for name, p in (("px", px), ("py", py), ("pz", pz)):
        if tuple(p.shape) != (b, G, Z, Y, X):
            raise ValueError(f"warp_transpose: {name} has shape "
                             f"{tuple(p.shape)}, expected {(b, G, Z, Y, X)}")
    W = int(window)
    if not 1 <= F <= MAX_CHANNELS or W < 1 or min(Y, X) < 2 or \
            g.numel() >= 2 ** 31 or not 0 <= z0 < 2 ** 24 - Z:
        raise ValueError(f"warp_transpose: unsupported window {W}, shape "
                         f"{tuple(g.shape)} or z origin {z0}")
    out = torch.empty_like(g)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fluidnet_warp_transpose(
            g.data_ptr(), px.data_ptr(), py.data_ptr(), pz.data_ptr(),
            out.data_ptr(), b, G, F, Z, Y, X, int(z0), W, int(nearest),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fluidnet_warp_transpose")
    _build.launches["warp_transpose"] += 1
    return out


def warp_transpose(g, px, py, pz, window, nearest=False, *, plain=False,
                   z0=0):
    """The adjoint of the windowed warp at z origin z0: CUDA tensors
    launch K6, CPU tensors (or plain=True) run warp_transpose_plain."""
    if plain or g.device.type == "cpu":
        return warp_transpose_plain(g, px, py, pz, window, nearest, z0)
    return warp_transpose_cuda(g.contiguous(), px.contiguous(),
                               py.contiguous(), pz.contiguous(), window,
                               nearest, z0)
