"""Jacobi pressure solver.

Port of fluidnet_tpu.solvers.jacobi (solveLinearSystemJacobi,
generic/tfluids.cu:1764-1926): ping-pong Jacobi iteration

    p <- (p(i-1) + p(i+1) + p(j-1) + p(j+1) [+ p(k-1) + p(k+1)] + div) / (4|6)

with obstacle neighbours reflecting the centre value, zero pressure on the
1-cell border and in obstacle cells, termination on max-over-batch
||p - p_prev||_2 < p_tol or max_iter.
"""

import torch

from fluidnet_tpu_torch.solvers.cuda_jacobi import (jacobi_cuda,
                                                    jacobi_masks,
                                                    jacobi_sweep)


def solve_jacobi(flags, div, p_tol: float = 1e-5, max_iter: int = 1000,
                 allow_pallas: bool = True):
    """Solves the pressure Poisson system from p = 0. Returns (p,
    residual), the residual a 0-d tensor.

    A fixed-iteration solve (p_tol == 0, `allow_pallas`) runs K3
    (solvers/cuda_jacobi.py) and returns residual 0, as the JAX package
    does on its Pallas route (jacobi.py:50-54). The JAX route also needs
    `fits_vmem` (X % 128 == 0, Y % 8 == 0), a VMEM rule of the TPU that
    the port does not carry over: at other shapes JAX runs its loop and
    returns the last delta where the port returns 0. Callers ignore that
    value (simulate.py:272, 282).

    Otherwise the JAX `while_loop` runs as a Python loop with a host check
    per sweep: it continues while it < max_iter and (res >= p_tol or
    it < 1), res being the max over the batch of ||p_new - p||_2.
    """
    if p_tol == 0.0 and allow_pallas:
        return (jacobi_cuda(flags, div, max_iter),
                torch.zeros((), dtype=div.dtype, device=div.device))
    is_3d = div.shape[2] > 1
    masks = jacobi_masks(flags, is_3d)
    b = div.shape[0]
    p = torch.zeros_like(div)
    res = torch.tensor(torch.finfo(div.dtype).max, dtype=div.dtype,
                       device=div.device)
    it = 0
    while it < max_iter and (it < 1 or res.item() >= p_tol):
        p_new = jacobi_sweep(p, div, masks, is_3d)
        delta = (p_new - p).reshape(b, -1)
        res = torch.sqrt((delta * delta).sum(dim=1)).max()
        p = p_new
        it += 1
    return p, res
