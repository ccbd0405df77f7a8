"""graph_steps_share.rollout (%): the share of the process's rollout
steps so far that replayed a CUDA graph chain: the program's count of
steps replayed over the steps replayed and run op by op
(fluidnet_tpu_torch/utils/profiler.rollout_steps; set-up's, the
window's and the traced run's passes together). None where the program
keeps no such count. Layer: the step loop (sim/simulate.rollout,
sim/chain.py). Moves steps_per_s."""


def read(s):
    if s.kind != "rollout":
        return None
    try:
        from fluidnet_tpu_torch.utils import profiler
    except ImportError:
        return None
    counts = getattr(profiler, "rollout_steps", None)
    if counts is None:
        return None
    total = counts["replayed"] + counts["eager"]
    return None if total == 0 else 100.0 * counts["replayed"] / total
