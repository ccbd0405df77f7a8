"""host_ms_per_step.rollout (ms): the process's CPU time a rollout step
(time.process_time over the traced run's unprofiled stretch, over its
steps; the main thread's, nearly all of it). Layer: the step loop (sim/simulate.rollout, _step). Moves
steps_per_s."""


def read(s):
    if s.kind != "rollout" or not s.steps:
        return None
    return 1e3 * s.host_cpu_s / s.steps
