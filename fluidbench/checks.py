"""The comparisons that decide `correct`: the numbers read from what the
timed path produced against the reference, each held to its limit.

Rollout cells: for each compared frame (the first frame, from the
benchmark's own first state, and frames of the window drawn from the
seed, each from the program's own state at its start), the reference
steps the frame again; `u` and `p` are ||program - reference||_2 /
||reference||_2, `density_l1` the density's relative L1 gap (its L2 gap,
`density`, swings on single frames where a bf16-sized change of u moves
a backtrace across a cell of the discontinuous MacCormack clamp); the
frame's density copied to host memory must equal the device's (`copy`,
limit 0). Training
cells: the reference follows the first steps from the same weights,
batches, draws and horizons; `loss` is the worst step's |L - L_ref| /
|L_ref|; `grad` the worst leaf's gap between the norms of the first
gradient as the optimizer got it (Adam's first moment after its first
accepted update, over 1 - beta1; the recipe's guard drops an update
whose loss reaches its threshold, and a run whose compared steps were
all dropped has no such gradient and fails) and the reference's;
`change` the median leaf's gap between the norms of the parameters'
change over those steps, and `change_worst` the worst leaf's (it swings
more from seed to seed, by a one-element head bias whose summed gradient
Adam's sign-like step amplifies); each gap over the reference leaf's
norm or the median leaf's, the larger. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of the
change (they move by round-off alone under Adam).
"""

import math

import torch


def rel_l2(a, b):
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b))


def rel_l1(a, b):
    """||a - b||_1 / ||b||_1 in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().sum() / b.abs().sum())


def frame_gaps(prog, ref):
    """{field: relative L2 gap} of one frame, and the density's relative
    L1 gap (density_l1); prog and ref (u, p, density)."""
    out = {k: rel_l2(a, b) for k, a, b in
           zip(("u", "p", "density"), prog, ref)}
    out["density_l1"] = rel_l1(prog[2], ref[2])
    return out


def worst(readings):
    """The worst of each number over a list of reading dicts (a NaN
    counts as worst)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            cur = out.get(k)
            if cur is None or (not math.isnan(cur) and not v <= cur):
                out[k] = v
    return out


def largest(values):
    """The largest of the values (0 for none); NaN if any is NaN."""
    values = list(values)
    if any(math.isnan(v) for v in values):
        return float("nan")
    return max(values, default=0.0)


def leaf_table(prog_norms, ref_norms, keep=None):
    """{leaf: |norm - ref norm| over max(ref norm, median ref norm)} over
    the leaves in `keep` (all when None). Where both norms are 0 (an
    update both sides dropped) the gap is 0."""
    names = [k for k in ref_norms if keep is None or k in keep]
    med = float(torch.tensor([ref_norms[k] for k in ref_norms]).median())
    out = {}
    for k in names:
        num, den = abs(prog_norms[k] - ref_norms[k]), max(ref_norms[k], med)
        out[k] = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return out


def leaf_gaps(prog_norms, ref_norms, keep=None):
    """The worst leaf's gap (leaf_table)."""
    return largest(leaf_table(prog_norms, ref_norms, keep).values())


def norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def moved_leaves(ref_grad_norms, share=1e-3):
    """The leaves whose reference gradient is at least `share` of the
    median leaf's."""
    med = float(torch.tensor(list(ref_grad_norms.values())).median())
    return {k for k, v in ref_grad_norms.items() if v >= share * med}


def train_readings(prog, ref, leaves=None):
    """prog and ref: {"losses": [...], "grad1": {leaf: tensor}, "p0":
    {leaf: tensor}, "p_end": {leaf: tensor}}. Returns {loss, grad,
    change}; `leaves`, a dict, gets each leaf's gaps."""
    loss = largest([abs(a - b) / abs(b)
                    for a, b in zip(prog["losses"], ref["losses"])])
    change = {k: prog["p_end"][k] - prog["p0"][k] for k in prog["p0"]}
    change_ref = {k: ref["p_end"][k] - ref["p0"][k] for k in ref["p0"]}
    if prog["grad1"] is None or ref["grad1"] is None:
        nan = float("nan")
        return {"loss": loss, "grad": nan, "change": nan,
                "change_worst": nan}
    g_ref = norms(ref["grad1"])
    grad = leaf_table(norms(prog["grad1"]), g_ref)
    moved = leaf_table(norms(change), norms(change_ref), moved_leaves(g_ref))
    if leaves is not None:
        leaves.update(grad=grad, change=moved, grad_ref=g_ref,
                      change_ref=norms(change_ref))
    return {"loss": loss, "grad": largest(grad.values()),
            "change": median(moved.values()),
            "change_worst": largest(moved.values())}


def median(values):
    """The median of the values; NaN if any is NaN (0 for none)."""
    values = list(values)
    if any(math.isnan(v) for v in values):
        return float("nan")
    return float(torch.tensor(values).median()) if values else 0.0


def judge(readings, limits):
    """(correct, [(name, value, limit)]) over the numbers that have a
    limit: each at or under it (a NaN or a missing reading fails); no
    limit at all fails."""
    rows = [(k, readings.get(k, float("nan")), limits[k])
            for k in sorted(limits)]
    ok = bool(rows) and all(v <= lim for _, v, lim in rows)
    return ok, rows
