""".vbox volume export for the Blender rendering pipeline.

Format (blender/test_tensor_to_voxel.lua:24-32 and the writer in
torch/fluid_net_3d_sim.lua:164-186, 286-290):

  int32 w, h, d, n_frames
  then per frame: float32 voxels of the (z, y, x) grid permuted to
  (x, y, z) C-order (i.e. x-major flat layout).
"""

import struct

import numpy as np


class VboxWriter:
    def __init__(self, path, w, h, d, n_frames):
        self.f = open(path, "wb")
        self.f.write(struct.pack("<4i", w, h, d, n_frames))
        self.shape = (d, h, w)
        self.frames_written = 0

    def write_frame(self, vol_zyx):
        """vol_zyx: (z, y, x) float array."""
        v = np.asarray(vol_zyx, np.float32)
        assert v.shape == self.shape, (v.shape, self.shape)
        self.f.write(np.ascontiguousarray(v.transpose(2, 1, 0)).tobytes())
        self.frames_written += 1

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_vbox(path):
    """Returns (frames, (w, h, d)) with frames (n, z, y, x)."""
    with open(path, "rb") as f:
        w, h, d, n = struct.unpack("<4i", f.read(16))
        out = []
        for _ in range(n):
            v = np.frombuffer(f.read(4 * w * h * d), np.float32)
            out.append(v.reshape(w, h, d).transpose(2, 1, 0))
    return np.stack(out), (w, h, d)
