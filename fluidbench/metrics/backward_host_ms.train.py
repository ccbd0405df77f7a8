"""backward_host_ms.train (ms): the host-clock self time a train step of
the span train.backward on the main thread (its duration minus the layer
spans nested in it), over pass A of fluidbench/layers.py (unprofiled,
the recorder on); train.backward covers torch.autograd.grad of the loss.
Layer: autograd. Moves train_samples_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "host_ms", "train.backward")
