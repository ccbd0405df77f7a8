"""Tab-separated metrics logger with named columns and append-on-resume.

Port of torch.Logger (torch/lib/logger.lua:8-100): one row per epoch, a
header naming each column, append mode so resumed runs keep the history.
A copy of fluidnet_tpu.utils.logger (backend-free, but the port imports
nothing of the JAX package).
"""

import os


class Logger:
    def __init__(self, path, names=None):
        self.path = path
        self.names = list(names) if names else None
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        if exists:
            with open(path) as f:
                header = f.readline().rstrip("\n").split("\t")
            if self.names is None:
                self.names = header
            elif header != self.names:
                raise ValueError(f"log column mismatch: {header} vs "
                                 f"{self.names}")
            self.f = open(path, "a")
        else:
            if not self.names:
                raise ValueError("names required for a new log")
            self.f = open(path, "w")
            self.f.write("\t".join(self.names) + "\n")
            self.f.flush()

    def add(self, values):
        """values: dict (keyed by column name) or sequence."""
        if isinstance(values, dict):
            row = [values[n] for n in self.names]
        else:
            row = list(values)
            if len(row) != len(self.names):
                raise ValueError(f"{len(row)} values for {len(self.names)} "
                                 f"columns")
        self.f.write("\t".join(f"{float(v):.8e}" for v in row) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


def read_log(path):
    """Returns (names, rows) from a logger file."""
    with open(path) as f:
        names = f.readline().rstrip("\n").split("\t")
        rows = [[float(x) for x in line.split("\t")] for line in f
                if line.strip()]
    return names, rows
