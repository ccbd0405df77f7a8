"""Binary frame format reader/writer (mantaflow-compatible).

Port of torch.loadMantaFile (torch/lib/load_manta_file.lua:15-60). The frame
layout is:

  int32   transpose (legacy, unused)
  int32   nx, ny, nz
  int32   is3D (0/1)
  float32 Ux[numel], Uy[numel], (Uz[numel] if 3D)
  float32 p[numel]
  int32   flags[numel]
  float32 density[numel]

with numel = nx*ny*nz, arrays flat in (z, y, x) C order. Outputs are 5-D
(1, c, nz, ny, nx) like everything else. The writer emits the identical
layout so self-generated datasets are interchangeable with manta ones.

A copy of fluidnet_tpu.data.manta_io (backend-free, but the port imports
nothing of the JAX package). Frames parse here in NumPy, FluidDataset's
batches too: the native threaded reader
(fluidnet_tpu_torch.native.read_manta_frames_native) parses the same
layout but read a 64^3 batch no faster on the card's host, so nothing
routes through it (ROADMAP, "Not needed").
"""

import os
import struct

import numpy as np


def load_manta_file(path):
    """Returns dict(p, U, flags, density, is_3d) of numpy arrays."""
    with open(path, "rb") as f:
        raw = f.read()
    return parse_manta_bytes(raw)


def parse_manta_bytes(raw):
    _, nx, ny, nz, is3d = struct.unpack("<5i", raw[:20])
    is3d = bool(is3d)
    numel = nx * ny * nz
    off = 20

    def take(dtype, n):
        nonlocal off
        a = np.frombuffer(raw, dtype, count=n, offset=off)
        off += n * a.itemsize
        return a

    ux = take(np.float32, numel)
    uy = take(np.float32, numel)
    uz = take(np.float32, numel) if is3d else None
    p = take(np.float32, numel)
    flags = take(np.int32, numel)
    density = take(np.float32, numel)

    def grid(a):
        return np.ascontiguousarray(a.reshape(1, 1, nz, ny, nx))

    comps = [grid(ux), grid(uy)] + ([grid(uz)] if is3d else [])
    return {
        "p": grid(p),
        "U": np.concatenate(comps, axis=1),
        "flags": grid(flags.astype(np.int32)),
        "density": grid(density),
        "is_3d": is3d,
    }


def save_manta_file(path, p, u, flags, density):
    """Writes one frame; all inputs (1, c, nz, ny, nx)."""
    if p.ndim != 5 or u.ndim != 5:
        raise ValueError("save_manta_file: fields must be (1, c, z, y, x)")
    _, cu, nz, ny, nx = u.shape
    is3d = cu == 3
    with open(path, "wb") as f:
        f.write(struct.pack("<5i", 0, nx, ny, nz, int(is3d)))
        for c in range(cu):
            f.write(np.asarray(u[0, c], np.float32).tobytes())
        f.write(np.asarray(p[0, 0], np.float32).tobytes())
        f.write(np.asarray(flags[0, 0], np.int32).tobytes())
        f.write(np.asarray(density[0, 0], np.float32).tobytes())


def frame_name(frame_idx, divergent):
    """DataBinary's file naming: NNNNNN.bin / NNNNNN_divergent.bin
    (torch/lib/data_binary.lua:51-52)."""
    base = "%06d" % frame_idx
    return base + ("_divergent.bin" if divergent else ".bin")
