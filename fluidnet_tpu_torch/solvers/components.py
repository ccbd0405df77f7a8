"""Connected fluid components and per-component pressure mean removal.

Port of fluidnet_tpu.solvers.components in plain PyTorch (the JAX package
leaves this to XLA too). The reference flood-fills on the CPU
(generic/find_connected_fluid_components.cc:17-82); here:

  - connected_components: min-label propagation (a 4/6-neighbour min
    filter) to a fixpoint, capped at Z+Y+X sweeps, one host check a sweep;
  - component_mean / normalize_pressure_mean: per-component sums (the JAX
    segment_sum) in a fixed order, scattered back to the cells
    (generic/tfluids.cc:845-921). The cells are sorted by component once
    per set of labels (component_segments; a rollout keeps it in
    sim.simulate.FlagConsts) and each component is summed by
    torch.segment_reduce, so the sums repeat to the bit from run to run
    (index_add_ adds with atomics on the GPU, in no fixed order).
"""

from typing import NamedTuple, Optional

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


class Segments(NamedTuple):
    """Labels laid out for fixed-order per-component sums: the cells of
    every batch's components, one segment per (batch, label), sorted by
    segment."""
    inverse: torch.Tensor   # (b*n,) each cell's segment
    order: torch.Tensor     # (b*n,) the cells sorted by segment, stably
    lengths: torch.Tensor   # (segments,) cells per segment


def component_segments(labels):
    """The Segments of labels from connected_components (one host sync:
    the number of segments), what the component sums take: computed once,
    they sum the same components again without sorting."""
    b = labels.shape[0]
    n = labels[0].numel()
    seg = (labels.reshape(b, n).long() +
           torch.arange(b, device=labels.device).reshape(b, 1) * (n + 1))
    _, inverse, lengths = torch.unique(seg.reshape(-1), sorted=True,
                                       return_inverse=True,
                                       return_counts=True)
    return Segments(inverse, torch.argsort(inverse, stable=True), lengths)


def _segment_sum(v, segs):
    return torch.segment_reduce(v[segs.order], "sum", lengths=segs.lengths,
                                unsafe=True)


def component_mean(x, segs: Segments, fluid_mask):
    """Per-component mean of x over fluid cells, scattered back to the
    cells; non-fluid cells get 0. segs: the component_segments of the
    labels.

    The order of each component's sum is fixed by the segment layout, so
    it repeats run after run on either device; it is not XLA's
    segment_sum order, so against JAX the means agree to rounding."""
    fm = fluid_mask.reshape(-1)
    sums = _segment_sum(torch.where(fm, x.reshape(-1), 0.0), segs)
    cnts = _segment_sum(fm.to(x.dtype), segs)
    means = sums / cnts.clamp_min(1.0)
    return means[segs.inverse].reshape(x.shape)


def normalize_pressure_mean(p, flags, segs: Optional[Segments] = None):
    """Subtracts the mean pressure of each connected fluid component
    (tfluids.normalizePressureMean, init.lua:747-766). segs: the
    component_segments of the flags' components, None computes them.
    Returns new p."""
    if segs is None:
        segs = component_segments(connected_components(flags))
    fl = is_fluid(flags)
    return torch.where(fl, p - component_mean(p, segs, fl), p)
