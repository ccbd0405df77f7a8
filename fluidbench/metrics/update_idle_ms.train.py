"""update_idle_ms.train (ms): idle device time a train step in gaps whose
middle falls while train.update was the innermost layer span open on the
main thread, over pass B of fluidbench/layers.py (traced); train.update
covers the mean over ranks, the optimizer, the global norm, the reject
guard and the copies. Layer: the trainer. Moves train_samples_per_s."""

from fluidbench import layers


def read(s):
    return layers.read(s, "idle_ms", "train.update")
