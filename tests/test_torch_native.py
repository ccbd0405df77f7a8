"""The port's native host runtime (fluidnet_tpu_torch.native, built here
with g++ into build/native/) against the JAX package's native library:
flood-fill labels, component counts and sizes, the binvox RLE decoder and
the threaded frame reader, each equal element by element; the build's
atomic publish and its loud failure.
"""

import ctypes
import os
import threading

import numpy as np
import pytest

from fluidnet_tpu.data import manta_io as j_manta_io

from fluidnet_tpu_torch import native
from fluidnet_tpu_torch.data import manta_io

from tests.torch_port_util import jax_native

SHAPE = (4, 6, 5)           # Z, Y, X of the frame files


@pytest.fixture(scope="module")
def j_native():
    assert native.get_lib() is not None
    return jax_native()


def _split_2d():
    """Two 2-D samples, fluid inside an obstacle border, split by an
    obstacle column into two components (and a lone obstacle cell)."""
    flags = np.ones((2, 1, 1, 12, 12), np.int32)
    flags[..., 0, :] = flags[..., -1, :] = 2
    flags[..., :, 0] = flags[..., :, -1] = 2
    flags[..., :, 6] = 2
    flags[0, 0, 0, 3, 3] = 2
    return flags


def _random_3d():
    rng = np.random.default_rng(11)
    return np.where(rng.random((2, 1, 9, 10, 11)) < 0.35, 2,
                    1).astype(np.int32)


@pytest.mark.parametrize("case", ["split_2d", "random_3d"])
def test_flood_fill_matches_jax(j_native, case):
    flags = _split_2d() if case == "split_2d" else _random_3d()
    labels, n, sizes = native.flood_fill_native(flags)
    j_labels, j_n, j_sizes = j_native.flood_fill_native(flags)
    np.testing.assert_array_equal(labels, j_labels)
    assert n == j_n
    np.testing.assert_array_equal(sizes, j_sizes)
    assert int(sizes.sum()) == int(((flags & 1) > 0).sum())
    assert (labels[(flags & 1) == 0] == -1).all()
    if case == "split_2d":
        assert n == 4                     # two components a sample
    else:
        assert n > 2


def test_binvox_decode_matches_jax(j_native):
    rng = np.random.default_rng(12)
    values = rng.integers(0, 2, 40).astype(np.uint8)
    counts = rng.integers(1, 256, 40).astype(np.uint8)
    raw = np.stack([values, counts], 1).reshape(-1).tobytes()
    total = int(counts.astype(np.int64).sum())
    # Exact, short (zeros after the runs) and long (cut) inputs, and an odd
    # trailing byte.
    for n in (total, total + 37, total - 100):
        for r in (raw, raw + b"\x01"):
            got = native.binvox_decode_native(r, n)
            np.testing.assert_array_equal(got,
                                          j_native.binvox_decode_native(r, n))
            assert got.shape == (n,) and got.dtype == np.uint8
    want = np.repeat(values, counts.astype(np.int64))
    np.testing.assert_array_equal(native.binvox_decode_native(raw, total),
                                  want)


def _write_frames(tmp_path, n, shape=SHAPE, seed=13):
    rng = np.random.default_rng(seed)
    Z, Y, X = shape
    paths = []
    for i in range(n):
        path = str(tmp_path / f"f{i}.bin")
        manta_io.save_manta_file(
            path, rng.standard_normal((1, 1, Z, Y, X)).astype(np.float32),
            rng.standard_normal((1, 3, Z, Y, X)).astype(np.float32),
            rng.integers(1, 5, (1, 1, Z, Y, X)).astype(np.int32),
            rng.random((1, 1, Z, Y, X)).astype(np.float32))
        paths.append(path)
    return paths


def test_threaded_reader_matches_both_loaders(j_native, tmp_path):
    paths = _write_frames(tmp_path, 7)
    out = native.read_manta_frames_native(paths, *SHAPE, is_3d=True,
                                          n_threads=3)
    j_out = j_native.read_manta_frames_native(paths, *SHAPE, is_3d=True,
                                              n_threads=3)
    for k in out:
        np.testing.assert_array_equal(out[k], j_out[k], err_msg=k)
    for i, path in enumerate(paths):
        for load in (manta_io.load_manta_file, j_manta_io.load_manta_file):
            want = load(path)
            np.testing.assert_array_equal(out["u_div_or_target"][i],
                                          want["U"][0])
            for k in ("p", "flags", "density"):
                np.testing.assert_array_equal(out[k][i], want[k][0])


def test_threaded_reader_rejects_other_shapes(tmp_path):
    (tmp_path / "other").mkdir()
    paths = _write_frames(tmp_path, 2) + \
        _write_frames(tmp_path / "other", 1, shape=(4, 6, 6), seed=14)
    with pytest.raises(IOError, match="code -3"):
        native.read_manta_frames_native(paths, *SHAPE, is_3d=True)
    with pytest.raises(IOError, match="code -1"):
        native.read_manta_frames_native([str(tmp_path / "missing.bin")],
                                        *SHAPE, is_3d=True)


def test_build_is_atomic_under_threads():
    """Two forced builds at once each compile to a name of their own and
    rename it over the library: both load, and no temporary is left."""
    results, errors = [], []

    def build_and_load():
        try:
            lib = ctypes.CDLL(native.build_native(force=True))
            out = np.zeros(4, np.uint8)
            rle = np.array([1, 3], np.uint8)
            lib.fn_binvox_decode.restype = ctypes.c_int64
            n = lib.fn_binvox_decode(ctypes.c_void_p(rle.ctypes.data),
                                     ctypes.c_int64(2),
                                     ctypes.c_void_p(out.ctypes.data),
                                     ctypes.c_int64(4))
            results.append((n, out.tolist()))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build_and_load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert results == [(3, [1, 1, 1, 0])] * 2
    mine = f".{os.getpid()}."         # other processes may be building
    assert [f for f in os.listdir(native.BUILD_DIR) if mine in f] == []


def test_failed_build_is_loud(monkeypatch, tmp_path, capfd):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "build" / "x.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_lib() is None
    assert native.flood_fill_native(np.ones((1, 1, 1, 2, 2))) is None
    err = capfd.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "unavailable" in err[0] and "bad.cpp" in err[0]
