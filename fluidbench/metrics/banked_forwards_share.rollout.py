"""banked_forwards_share.rollout (%): the share of the process's model
forwards so far that took the banked stage path: the program's count of
trunk forwards by path (fluidnet_tpu_torch/utils/profiler.trunk_forwards:
"fast", "stages", "banked"; a step replayed from a CUDA graph chain
counts the forwards its capture ran), set-up's, the window's and the
traced run's together. None where the program keeps no such count.
Layer: the banks. Moves steps_per_s."""


def read(s):
    if s.kind != "rollout":
        return None
    try:
        from fluidnet_tpu_torch.utils import profiler
    except ImportError:
        return None
    counts = getattr(profiler, "trunk_forwards", None)
    if counts is None:
        return None
    total = sum(counts.values())
    return None if total == 0 else 100.0 * counts["banked"] / total
