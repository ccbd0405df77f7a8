"""loss_device_ms.train (ms): device time a train step of the kernels,
copies and fills launched while train.loss was the innermost layer span
open on the main thread, over pass B of fluidbench/layers.py (traced);
train.loss covers train/train._loss: the forward, the unroll and its
sim.* spans. Layer: the trainer. Moves train_samples_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "device_ms", "train.loss")
