"""frame_copy_ms (ms): device time of the frame's copy of the density to
host memory, a frame. Layer: the frame loop (cli/sim3d's chunks; the
density copy). Moves frame_ms_p95."""


def read(s):
    if s.kind != "rollout" or not s.frames:
        return None
    t = sum(d for n, d in s.copies if "DtoH" in n)
    return None if t <= 0 else 1e3 * t / s.frames
