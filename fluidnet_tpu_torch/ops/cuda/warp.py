"""K5: the windowed warp, launched on the card.

Replaces fluidnet_tpu/ops/pallas/warp.py::_warp_group_kernel
(_warp_group_impl). The CUDA kernel is csrc/warp.cu; its source note gives
the per-cell work, what bounds it on the H100 (memory traffic: the
positions, the source channels and the outputs once each) and the design
(one thread per output cell and group, each corner read once per channel
and all before the first is used, one pointer per source).

`warp_group_cuda` is what ops/warp.py::warp_group calls for CUDA tensors;
CPU tensors take the plain version there. One call is one launch, counted
in _build.launches["warp"].
"""

import ctypes

import torch

from fluidnet_tpu_torch.ops.cuda import _build

MAX_CHANNELS = 8   # csrc/warp.cu kMaxF


def warp_group_cuda(fields, px, py, pz, window, nearest=False, minmax=False):
    """Launches K5. fields: (b, G, F, Z, Y, X) or a tuple of such sources
    sharing (b, G, Z, Y, X), whose channels concatenate (at most 8 in all);
    positions (b, G, Z, Y, X), pz read only when Z > 1. minmax: False,
    True (min/max of channel 0) or a (cmin, cmax) pair of bound sources.
    Returns (b, G, F [+2], Z, Y, X) float32."""
    fs = list(fields) if isinstance(fields, tuple) else [fields]
    if not fs or fs[0].dim() != 6:
        raise ValueError("warp: fields must be (b, G, F, Z, Y, X)")
    b, G, _, Z, Y, X = fs[0].shape
    f32 = torch.float32
    dev = _build.require_cuda("warp", *fs, px, py, pz,
                              dtypes=[f32] * (len(fs) + 3))
    for i, f in enumerate(fs):
        if f.dim() != 6 or (f.shape[:2], f.shape[3:]) != ((b, G),
                                                         (Z, Y, X)):
            raise ValueError(f"warp: source {i} has shape {tuple(f.shape)}, "
                             f"expected (b, G, *, Z, Y, X) = "
                             f"({b}, {G}, *, {Z}, {Y}, {X})")
    for name, p in (("px", px), ("py", py), ("pz", pz)):
        if tuple(p.shape) != (b, G, Z, Y, X):
            raise ValueError(f"warp: {name} has shape {tuple(p.shape)}, "
                             f"expected {(b, G, Z, Y, X)}")
    Fs = [f.shape[2] for f in fs]
    F = sum(Fs)
    if F < 1 or F > MAX_CHANNELS:
        raise ValueError(f"warp: {F} channels, the kernel takes 1 to "
                         f"{MAX_CHANNELS}")
    if nearest and minmax:
        raise ValueError("warp: nearest mode takes no min/max")
    pair = isinstance(minmax, tuple)
    cmin, cmax = (minmax if pair else (0, 0)) if minmax else (0, 0)
    if not (0 <= cmin < F and 0 <= cmax < F):
        raise ValueError(f"warp: min/max channels {minmax} out of range")
    W = int(window)
    Fo = F + (2 if minmax else 0)
    if W < 1 or min(Y, X) < 2 or b * G * Fo * Z * Y * X >= 2 ** 31:
        raise ValueError(f"warp: unsupported window {W} or shape "
                         f"{tuple(fs[0].shape)}")
    out = torch.empty((b, G, Fo, Z, Y, X), device=dev, dtype=f32)
    srcs = (ctypes.c_void_p * len(fs))(*[f.data_ptr() for f in fs])
    counts = (ctypes.c_int * len(fs))(*Fs)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fluidnet_warp(
            srcs, counts, len(fs), px.data_ptr(), py.data_ptr(),
            pz.data_ptr(), out.data_ptr(), b, G, Z, Y, X, W, int(nearest),
            int(bool(minmax)), cmin, cmax, int(pair),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fluidnet_warp")
    _build.launches["warp"] += 1
    return out
