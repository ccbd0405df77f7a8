"""update_device_ms.train (ms): device time a train step of the kernels,
copies and fills launched while train.update was the innermost layer
span open on the main thread, over pass B of fluidbench/layers.py
(traced); train.update covers the mean over ranks, the optimizer, the
global norm, the reject guard and the copies. Layer: the trainer. Moves
train_samples_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "device_ms", "train.update")
