"""backward_device_ms.train (ms): device time a train step of the kernels,
copies and fills launched while train.backward was the innermost layer
span open on the main thread, over pass B of fluidbench/layers.py
(traced); train.backward covers torch.autograd.grad of the loss. Layer:
autograd. Moves train_samples_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "device_ms", "train.backward")
