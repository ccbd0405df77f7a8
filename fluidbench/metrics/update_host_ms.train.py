"""update_host_ms.train (ms): the host-clock self time a train step of the
span train.update on the main thread (its duration minus the layer spans
nested in it), over pass A of fluidbench/layers.py (unprofiled, the
recorder on); train.update covers the mean over ranks, the optimizer,
the global norm, the reject guard and the copies. Layer: the trainer.
Moves train_samples_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "host_ms", "train.update")
