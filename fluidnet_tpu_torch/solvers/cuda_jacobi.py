"""K3: the fixed-sweep Jacobi pressure solve.

Replaces fluidnet_tpu/solvers/pallas_jacobi.py::_kernel (jacobi_pallas):
n sweeps from p = 0 with obstacle neighbours reflecting the centre value
and p forced to 0 on the 1-cell border and on obstacles. The CUDA kernel
is csrc/jacobi.cu (one launch per sweep, two p buffers in ping-pong, all
from one C call); its source note gives the bound and the design.

`jacobi_cuda` launches the kernel on CUDA tensors and takes the plain
PyTorch version `jacobi_plain` on CPU tensors; nothing else chooses.
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_obstacle
from fluidnet_tpu_torch.core.grids import border_mask
from fluidnet_tpu_torch.ops import stencil as st
from fluidnet_tpu_torch.ops.cuda import _build


def jacobi_masks(flags, is_3d):
    """(zero mask, obstacle-neighbour masks in sweep order, denominator):
    what every sweep of one solve reuses. The denominator is a 0-d tensor
    on the flags' device: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds differently from the true
    division of the kernel and of the TPU kernel."""
    ob = is_obstacle(flags)
    zero = border_mask(flags.shape, is_3d, 1, flags.device) | ob
    shifts = (st.xm, st.xp, st.ym, st.yp) + ((st.zm, st.zp) if is_3d
                                             else ())
    denom = torch.tensor(6.0 if is_3d else 4.0, device=flags.device)
    return zero, [sh(ob, False) for sh in shifts], denom


def jacobi_sweep(p, div, masks, is_3d):
    """One sweep (kernel_jacobiIteration): neighbours summed x-, x+, y-,
    y+, z-, z+, an obstacle neighbour replaced by the centre value, then
    (sum + div) / (6 | 4), zero where the mask says so."""
    zero, obs_nb, denom = masks
    shifts = (st.xm, st.xp, st.ym, st.yp) + ((st.zm, st.zp) if is_3d
                                             else ())
    nbs = [torch.where(o, p, sh(p)) for sh, o in zip(shifts, obs_nb)]
    tot = nbs[0] + nbs[1]
    for nb in nbs[2:]:
        tot = tot + nb
    return torch.where(zero, 0.0, (tot + div) / denom)


def jacobi_plain(flags, div, n_sweeps: int):
    """Plain PyTorch version of K3 (runs on any device): `n_sweeps`
    sweeps from p = 0. flags (b,1,z,y,x) int32, div (b,1,z,y,x) f32;
    3-D when z > 1. Returns p (b,1,z,y,x)."""
    is_3d = div.shape[2] > 1
    masks = jacobi_masks(flags, is_3d)
    p = torch.zeros_like(div)
    for _ in range(n_sweeps):
        p = jacobi_sweep(p, div, masks, is_3d)
    return p


def _jacobi_launch(flags, div, n_sweeps):
    if div.dim() != 5 or div.shape[1] != 1:
        raise ValueError(f"jacobi: div must be (b, 1, z, y, x), got "
                         f"{tuple(div.shape)}")
    if flags.shape != div.shape:
        raise ValueError(f"jacobi: flags {tuple(flags.shape)} do not match "
                         f"div {tuple(div.shape)}")
    dev = _build.require_cuda("jacobi", div, flags,
                              dtypes=[torch.float32, torch.int32])
    B, _, Z, Y, X = div.shape
    if B * Z * Y * X >= 2 ** 31:
        raise ValueError(f"jacobi: unsupported shape {tuple(div.shape)}")
    p0 = torch.zeros_like(div)
    p1 = torch.empty_like(div)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.fluidnet_jacobi(
            div.data_ptr(), flags.data_ptr(), p0.data_ptr(), p1.data_ptr(),
            B, Z, Y, X, int(n_sweeps),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fluidnet_jacobi")
    _build.launches["jacobi"] += 1
    return p1 if n_sweeps % 2 else p0


def jacobi_cuda(flags, div, n_sweeps: int):
    """Fixed-sweep Jacobi solve: the same arguments and result as
    jacobi_plain. CPU tensors run jacobi_plain; CUDA tensors launch K3
    (counted once per solve in _build.launches["jacobi"])."""
    if n_sweeps < 0:
        raise ValueError(f"jacobi: n_sweeps must be >= 0, got {n_sweeps}")
    if div.device.type == "cpu":
        return jacobi_plain(flags, div, n_sweeps)
    return _jacobi_launch(flags, div, n_sweeps)
