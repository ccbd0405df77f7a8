"""Long-horizon divergence stability statistics.

Port of fluidnet_tpu.utils.stats (torch.calcStats, torch/lib/
calc_stats.lua:23-124): restart the simulation from a ground-truth frame,
step it n times with a chosen projection (convnet / jacobi / pcg), and
record ||div(U)||_2 after each step, per sample: the paper's stability
metric (plotted by PrettyPlotNormDiv.m).
"""

import numpy as np
import torch

from fluidnet_tpu_torch.core.grids import FluidState, resolve_device
from fluidnet_tpu_torch.ops.divergence import velocity_divergence
from fluidnet_tpu_torch.sim.simulate import FlagConsts, simulate


def calc_stats(batches, mconf, model=None, n_steps=128, out_path=None,
               device=None):
    """batches: an iterable of batch dicts of numpy arrays (p_target,
    u_target, flags, density; FluidDataset.get_batch). Each sample
    restarts from its target (projected) state, as the reference does
    (calc_stats.lua:99-118), on resolve_device(device); `model` is the
    ConvNet for sim_method "convnet". Returns the (n_samples, n_steps)
    array of ||div||_2, written as a TSV to `out_path` if given."""
    dev = resolve_device(device)

    def on_dev(a):
        return None if a is None else torch.as_tensor(np.asarray(a),
                                                      device=dev)
    div_norms = []
    for batch in batches:
        state = FluidState(u=on_dev(batch["u_target"]),
                           p=on_dev(batch["p_target"]),
                           flags=on_dev(batch["flags"]),
                           density=on_dev(batch.get("density")))
        b = state.u.shape[0]
        consts = FlagConsts()
        per_step = []
        for _ in range(n_steps):
            state = simulate(state, mconf, model, consts=consts)
            div = velocity_divergence(state.u, state.flags)
            per_step.append(torch.sqrt(torch.sum(div.reshape(b, -1) ** 2,
                                                 dim=1)))
        # One device-to-host copy per batch.
        div_norms.append(torch.stack(per_step, dim=1).cpu().numpy())
    out = np.concatenate(div_norms, axis=0)
    if out_path:
        np.savetxt(out_path, out, delimiter="\t")
    return out
