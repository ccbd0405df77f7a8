"""backward_idle_ms.train (ms): idle device time a train step in gaps whose
middle falls while train.backward was the innermost layer span open on
the main thread, over pass B of fluidbench/layers.py (traced);
train.backward covers torch.autograd.grad of the loss. Layer: autograd.
Moves train_samples_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "idle_ms", "train.backward")
