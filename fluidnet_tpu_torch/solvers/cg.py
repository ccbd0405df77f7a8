"""Matrix-free preconditioned conjugate-gradient pressure solver.

Port of fluidnet_tpu.solvers.cg in plain PyTorch (the JAX package leaves
it to XLA too). The system matches setupLaplacian
(generic/tfluids.cu:909-1095): for fluid cells, diag = number of
non-obstacle neighbours (out of the domain counts as obstacle), -1 off the
diagonal for fluid neighbours; empty neighbours add to the diagonal only
(Dirichlet p = 0). The reference's ic0 preconditioner is replaced by a
Jacobi (inverse-diagonal) one, as in the JAX package.

DC null space: enclosed components make A singular, so the right-hand side
of each singular component is projected against its constant vector before
the solve and every component's mean is removed after it.
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_fluid, is_obstacle
from fluidnet_tpu_torch.ops import stencil as st
from fluidnet_tpu_torch.solvers.components import (component_mean,
                                                   connected_components)


def _laplacian_masks(flags, is_3d):
    """(fluid mask, diag, fluid-neighbour masks, shifts) in the order
    x-, x+, y-, y+[, z-, z+]."""
    fl = is_fluid(flags)
    ob = is_obstacle(flags)
    shifts = [st.xm, st.xp, st.ym, st.yp] + ([st.zm, st.zp] if is_3d
                                             else [])
    diag = torch.zeros(flags.shape, dtype=torch.float32, device=flags.device)
    nbr_fluid = []
    for sh in shifts:
        # Out-of-domain neighbours count as obstacle (fill=True).
        diag = diag + (~sh(ob, True)).to(torch.float32)
        nbr_fluid.append(sh(fl, False))
    return fl, diag, nbr_fluid, shifts


def make_apply_A(flags, is_3d):
    """Returns (apply_A, diag, fluid_mask) for the masked 7/5-point
    system."""
    fl, diag, nbr_fluid, shifts = _laplacian_masks(flags, is_3d)

    def apply_A(p):
        off = torch.zeros_like(p)
        for sh, nf in zip(shifts, nbr_fluid):
            off = off + torch.where(nf, sh(p), 0.0)
        return torch.where(fl, diag * p - off, 0.0)

    return apply_A, diag, fl


def _bdot(a, b):
    """Per-batch dot product over all cells: (b,1,z,y,x) x2 -> (b,)."""
    return (a * b).reshape(a.shape[0], -1).sum(dim=1)


def solve_pcg(flags, div, tol: float = 1e-4, max_iter: int = 100,
              precond: str = "jacobi", remove_null_space: bool = True,
              labels=None):
    """Solves A p = div over fluid cells. Returns (p, residual), the
    residual (0-d tensor) the max over the batch of the best iterate's
    ||r||_2 (tfluids.solveLinearSystemPCG, init.lua:645-677).

    The JAX `while_loop` runs as a Python loop whose condition,
    it < max_iter and max(best_res) > tol, is checked on the host after
    every iteration; each batch keeps its best iterate. `labels`: the
    connected_components of `flags`, which the caller may compute once for
    constant flags (sim.simulate.rollout does); None computes them here.
    """
    if precond not in ("jacobi", "none"):
        raise ValueError(f"bad precond {precond!r}")
    is_3d = div.shape[2] > 1
    apply_A, diag, fl = make_apply_A(flags, is_3d)

    rhs = torch.where(fl, div, 0.0)
    if remove_null_space:
        if labels is None:
            labels = connected_components(flags)
        # Project the RHS of singular components (no cell with an empty
        # neighbour, i.e. diag == #fluid neighbours everywhere) against
        # the constant null vector; components with a Dirichlet link are
        # non-singular and keep their RHS.
        _, diag_n, nbr_fluid, _ = _laplacian_masks(flags, is_3d)
        n_fluid_nbrs = sum(nf.to(torch.float32) for nf in nbr_fluid)
        nonsing_cell = fl & (diag_n > n_fluid_nbrs)
        has_dirichlet = component_mean(nonsing_cell.to(torch.float32),
                                       labels, fl) > 0.0
        mean_rhs = component_mean(rhs, labels, fl)
        rhs = torch.where(fl & ~has_dirichlet, rhs - mean_rhs, rhs)

    if precond == "jacobi":
        inv_diag = torch.where(fl & (diag > 0),
                               1.0 / torch.clamp_min(diag, 1.0), 0.0)

        def M(r):
            return inv_diag * r
    else:
        def M(r):
            return torch.where(fl, r, 0.0)

    b = div.shape[0]
    bshape = (b, 1, 1, 1, 1)
    p = torch.zeros_like(div)
    r = rhs
    z = M(r)
    d = z
    rz = _bdot(r, z)
    best_p = p
    best_res = torch.sqrt(_bdot(r, r))
    it = 0
    while it < max_iter and best_res.max().item() > tol:
        Ad = apply_A(d)
        dAd = _bdot(d, Ad)
        alpha = torch.where(dAd > 0, rz / torch.where(dAd > 0, dAd, 1.0),
                            0.0)
        al = alpha.reshape(bshape)
        p = p + al * d
        r = r - al * Ad
        z = M(r)
        rz_new = _bdot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                           0.0)
        d = z + beta.reshape(bshape) * d
        rz = rz_new
        # fp32 CG can bounce after reaching its attainable accuracy: keep
        # the best iterate per batch.
        res = torch.sqrt(_bdot(r, r))
        best_p = torch.where((res < best_res).reshape(bshape), p, best_p)
        best_res = torch.minimum(res, best_res)
        it += 1
    p = best_p

    if remove_null_space:
        p = torch.where(fl, p - component_mean(p, labels, fl), p)
    return p, best_res.max()
