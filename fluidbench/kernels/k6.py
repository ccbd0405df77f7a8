"""K6, the adjoint of the windowed warp (csrc/warp_transpose.cu), which
is the gradient of K1's sweeps in training.

A launch on a field group of G groups of F channels reads the cotangent
(4F B a cell a group) and the group's three position fields (12 B) and
writes the gradient (4F B): 20 B a cell a group at F = 1, the count of
the kernel's source note. A differentiated 3-D step's advection takes
two sweeps, each with one launch for the three velocity components (G =
3) and one for the density's plain and fluid-weighted sums (G = 2): 10
groups of one channel. A train step at horizon n differentiates the
advections of unroll steps 2 .. n: the first step's inputs are the
batch's, which take no gradient."""

GROUPS_PER_STEP = 3 + 2 + 3 + 2
BYTES_PER_CELL_GROUP = 4 + 12 + 4


def matches(name):
    return "warp_transpose" in name


def train_step_bytes(n_future, cells):
    """Bytes of K6's work in one train step at horizon n_future on
    `cells` cells (batch included)."""
    return (n_future - 1) * GROUPS_PER_STEP * BYTES_PER_CELL_GROUP * cells
