"""Connected fluid components and per-component pressure mean removal.

Port of fluidnet_tpu.solvers.components in plain PyTorch (the JAX package
leaves this to XLA too). The reference flood-fills on the CPU
(generic/find_connected_fluid_components.cc:17-82); here:

  - connected_components: min-label propagation (a 4/6-neighbour min
    filter) to a fixpoint, capped at Z+Y+X sweeps, one host check a sweep;
  - component_mean / normalize_pressure_mean: per-component sums with
    index_add_ over n+1 segments per batch (the JAX segment_sum), scattered
    back to the cells (generic/tfluids.cc:845-921).
"""

import torch

from fluidnet_tpu_torch.core.celltype import is_fluid
from fluidnet_tpu_torch.ops import stencil as st


def connected_components(flags, max_iter: int = 0):
    """Labels connected fluid components (4/6-connectivity).

    Returns int32 labels (b, 1, z, y, x): a fluid cell gets the smallest
    linear index of its component, a non-fluid cell n = z*y*x (one past the
    last label, the dropped segment). max_iter == 0 caps the sweeps at
    Z+Y+X; the loop ends earlier at the fixpoint.
    """
    b, _, Z, Y, X = flags.shape
    n = Z * Y * X
    is_3d = Z > 1
    if max_iter <= 0:
        max_iter = Z + Y + X
    fl = is_fluid(flags)
    lin = torch.arange(n, dtype=torch.int32, device=flags.device).reshape(
        1, 1, Z, Y, X).expand(flags.shape)
    shifts = (st.xm, st.xp, st.ym, st.yp) + ((st.zm, st.zp) if is_3d
                                             else ())

    def sweep(lab):
        m = lab
        for sh in shifts:
            m = torch.minimum(m, sh(lab, n))
        return torch.where(fl, m, n)

    prev = torch.where(fl, lin, n)
    lab = sweep(prev)
    it = 1
    while it < max_iter and bool((lab != prev).any()):
        prev, lab = lab, sweep(lab)
        it += 1
    return lab


def component_mean(x, labels, fluid_mask):
    """Per-component mean of x over fluid cells, scattered back to the
    cells. labels from connected_components; non-fluid cells get 0.

    Sums run through index_add_, in another order than XLA's segment_sum
    (and, on the GPU, with atomics in no fixed order)."""
    b, _, Z, Y, X = x.shape
    n = Z * Y * X
    seg = (labels.reshape(b, n).long() +
           torch.arange(b, device=x.device).reshape(b, 1) * (n + 1)
           ).reshape(-1)
    fm = fluid_mask.reshape(-1)
    xf = torch.where(fm, x.reshape(-1), 0.0)
    sums = torch.zeros(b * (n + 1), dtype=x.dtype, device=x.device)
    sums.index_add_(0, seg, xf)
    cnts = torch.zeros_like(sums).index_add_(0, seg, fm.to(x.dtype))
    means = sums / cnts.clamp_min(1.0)
    return means[seg].reshape(x.shape)


def normalize_pressure_mean(p, flags, labels=None):
    """Subtracts the mean pressure of each connected fluid component
    (tfluids.normalizePressureMean, init.lua:747-766). Returns new p."""
    if labels is None:
        labels = connected_components(flags)
    fl = is_fluid(flags)
    return torch.where(fl, p - component_mean(p, labels, fl), p)
