"""K2, the projection prologue and the forces block (csrc/prologue.cu,
its template with density; K4 is its form without).

The prologue's work in one ConvNet step, counted whatever implements
it: the velocity, flags and density read once (12 + 4 + 4 B a cell), the
velocity and its divergence written once (12 + 4), 36 B a cell, plus the
inflow's slab (its bc and mask, 2 x 3 channels of float32 on the leading
rows); 81 float32 operations a cell (chip_smoke.FLOPS_PER_CELL)."""

BYTES_PER_CELL = 12 + 4 + 4 + 12 + 4
FLOPS_PER_CELL = 81


def matches(name):
    if "prologue_kernel" not in name:
        return False
    return not ("prologue_kernel<false, false," in name or
                "prologue_kernelILb0ELb0E" in name)


def step_cost(cells, slab_cells=0):
    """(bytes, float32 operations) of one step's prologue on `cells`
    cells, with an inflow slab of `slab_cells` cells."""
    return (BYTES_PER_CELL * cells + 2 * 3 * 4 * slab_cells,
            FLOPS_PER_CELL * cells)
