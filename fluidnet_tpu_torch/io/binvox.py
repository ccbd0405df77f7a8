""".binvox voxel model importer.

Port of tfluids.loadVoxelData (torch/lib/obstacles_import_binvox.lua:52-120),
itself following Patrick Min's reference reader: ASCII header (dim /
translate / scale lines), then RLE byte pairs (value, count). binvox stores
voxels in [x][z][y] nesting; like the reference we permute to (x, y, z).

A copy of fluidnet_tpu.io.binvox: the RLE pairs expand in the native C++
decoder (fluidnet_tpu_torch.native), or in NumPy when the library could not
be built.
"""

import numpy as np

from fluidnet_tpu_torch import native


def _decode_rle(raw, n_voxels):
    out = native.binvox_decode_native(raw, n_voxels)
    return _decode_rle_numpy(raw, n_voxels) if out is None else out


def _decode_rle_numpy(raw, n_voxels):
    """The NumPy fallback: run-length expansion, zeros past a short input."""
    pairs = np.frombuffer(raw, np.uint8)
    values = pairs[0::2].astype(np.uint8)
    counts = pairs[1::2].astype(np.int64)
    total = int(counts.sum())
    data = np.repeat(values, counts)
    if total < n_voxels:
        data = np.concatenate([data, np.zeros(n_voxels - total, np.uint8)])
    return data[:n_voxels]


def load_binvox(path):
    """Returns dict(data (x, y, z) float {0,1}, dims, translation, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip()
        assert header.startswith("#binvox"), f"not a binvox file: {path}"
        dims = translation = scale = None
        while True:
            line = f.readline().decode().strip()
            if line.startswith("dim"):
                dims = [int(v) for v in line.split()[1:4]]
            elif line.startswith("translate"):
                translation = [float(v) for v in line.split()[1:4]]
            elif line.startswith("scale"):
                scale = float(line.split()[1])
            elif line.startswith("data"):
                break
        raw = f.read()
    n = dims[0] * dims[1] * dims[2]
    flat = _decode_rle(raw, n)
    # binvox native nesting is [x][z][y]; permute axes 1<->2 like the
    # reference (obstacles_import_binvox.lua:110-111).
    data = flat.reshape(dims[0], dims[1], dims[2]).transpose(0, 2, 1)
    return {"data": data.astype(np.float32), "dims": dims,
            "translation": translation, "scale": scale}
