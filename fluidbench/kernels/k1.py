"""K1, the MacCormack advection sweep (csrc/mac_sweep.cu), every form.

The work of one 3-D step's advection, counted whatever implements it:
the inputs read once (the MAC velocity, 12 B a cell; the density, 4; the
fluid mask and the Chebyshev free space that K1's interface takes, 4
each) and the outputs written once (velocity and density, 16), 40 B a
cell; and the arithmetic of its two sweeps, 378 float32 operations a cell
each (chip_smoke.FLOPS_PER_CELL). The intermediate between the sweeps is
not counted, so a design that fuses them keeps the same count."""

STEP_BYTES_PER_CELL = 12 + 4 + 4 + 4 + 12 + 4
STEP_FLOPS_PER_CELL = 2 * 378


def matches(name):
    return "mac_sweep" in name


def step_cost(cells):
    """(bytes, float32 operations) of one step's advection of `cells`
    cells (batch included)."""
    return STEP_BYTES_PER_CELL * cells, STEP_FLOPS_PER_CELL * cells
