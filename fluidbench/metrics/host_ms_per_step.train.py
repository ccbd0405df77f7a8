"""host_ms_per_step.train (ms): the process's CPU time a train step
(time.process_time over the traced run's unprofiled stretch: the main
thread's forward and the autograd engine's device thread, which runs the
backward while the main thread waits). Layer: the trainer
(train/train.train_step). Moves train_samples_per_s."""


def read(s):
    if s.kind != "train" or not s.steps:
        return None
    return 1e3 * s.host_cpu_s / s.steps
