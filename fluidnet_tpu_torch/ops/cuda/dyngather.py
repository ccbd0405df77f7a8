"""K7: take_along_axis on a 2-D block (the counterpart of the Mosaic probe).

Replaces scripts/test_dyngather.py::k_lane and ::k_sublane, the TPU probe
of a lane-dim and a sublane-dim `take_along_axis` on a (128, 128) float32
block. The CUDA kernel is csrc/dyngather.cu; its source note gives the
bound (bytes: src and idx read once, out written once) and the design (one
thread per output element; the lane form stages its row in shared memory).

`take_along_axis` launches the kernel for CUDA tensors (counted in
_build.launches["dyngather"]) and takes the plain version
`take_along_axis_plain` for CPU tensors; nothing else chooses. Indices
must lie in [0, n) along `axis`: neither version wraps a negative one.
"""

import torch

from fluidnet_tpu_torch.ops.cuda import _build


def _check(src, idx, axis):
    if src.dim() != 2 or src.dtype != torch.float32:
        raise ValueError(f"dyngather: src must be a 2-D float32 tensor, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if idx.shape != src.shape or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"dyngather: idx must be int32 or int64 of src's "
                         f"shape {tuple(src.shape)}, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if axis not in (0, 1):
        raise ValueError(f"dyngather: axis must be 0 or 1, got {axis}")


def take_along_axis_plain(src, idx, axis):
    """Plain PyTorch version: the flat index row * C + idx (axis 1) or
    idx * C + col (axis 0) into the flattened src. index_select refuses an
    index out of range instead of wrapping it."""
    _check(src, idx, axis)
    R, C = src.shape
    idx = idx.to(torch.int64)
    if axis == 1:
        flat = torch.arange(R, device=src.device).view(R, 1) * C + idx
    else:
        flat = idx * C + torch.arange(C, device=src.device).view(1, C)
    return src.reshape(-1).index_select(0, flat.reshape(-1)).view(R, C)


def _launch(src, idx, axis):
    dev = _build.require_cuda("dyngather", src, idx,
                              dtypes=[torch.float32, idx.dtype])
    R, C = src.shape
    if R * C >= 2 ** 31:
        raise ValueError(f"dyngather: unsupported shape {tuple(src.shape)}")
    out = torch.empty_like(src)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fluidnet_dyngather(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), R, C, int(axis),
            int(idx.dtype == torch.int64),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fluidnet_dyngather")
    _build.launches["dyngather"] += 1
    return out


def take_along_axis(src, idx, axis):
    """out[r, c] = src[r, idx[r, c]] (axis 1) or src[idx[r, c], c] (axis
    0), as np.take_along_axis: src (R, C) float32, idx int32 or int64 of
    the same shape. CPU tensors run take_along_axis_plain, CUDA tensors
    launch K7."""
    _check(src, idx, axis)
    if src.device.type == "cpu":
        return take_along_axis_plain(src, idx, axis)
    return _launch(src, idx, axis)
