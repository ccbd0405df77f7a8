"""ctypes bindings of the native host runtime (src/fluidnet_native.cpp).

Port of fluidnet_tpu.native: the flood fill (the obstacle import's exterior
fill), the binvox RLE decoder and the threaded batch frame reader (bound
and tested; FluidDataset reads in NumPy, which was as fast), the host-side
components the reference keeps in C++ (SURVEY.md §2.1).

The library is built with the host's C++ compiler at first use,

    g++ -O3 -shared -fPIC -std=c++17 -pthread src/fluidnet_native.cpp
        -o build/native/libfluidnet_native.so

(again when the source is newer than the library), compiled to a temporary
name and published with os.replace, so a process that loads it while
another compiles never sees a half-written file. A failed build prints one
line to stderr with the compiler's error; every entry point then returns
None and its caller takes its NumPy path.
"""

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src", "fluidnet_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
LIB_PATH = os.path.join(BUILD_DIR, "libfluidnet_native.so")
MAX_COMPONENTS = 65536      # component sizes returned by flood_fill_native

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
# (restype, argtypes) of each entry point.
_SIGNATURES = {
    # flags, B, Z, Y, X, labels, comp_sizes, max_components
    "fn_flood_fill": (_I64, [_P, _I32, _I32, _I32, _I32, _P, _P, _I64]),
    # rle, n_bytes, out, n_voxels
    "fn_binvox_decode": (_I64, [_P, _I64, _P, _I64]),
    # paths, n_frames, u, p, flags, density, Z, Y, X, cu, n_threads
    "fn_read_manta_frames": (_I32, [ctypes.c_char_p, _I32] + [_P] * 4 +
                             [_I32] * 5),
}

_lock = threading.Lock()
_lib = None
_tried = False


def build_native(force=False):
    """Compiles SRC into LIB_PATH if it is missing or older than the source
    (or `force`). Returns LIB_PATH. Raises RuntimeError with the compiler's
    output if the build fails."""
    if not force and os.path.exists(LIB_PATH) and \
            os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", SRC,
           "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} exited {res.returncode}: "
                               f"{res.stderr.strip() or res.stdout.strip()}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB_PATH


def _load(path):
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def get_lib():
    """The loaded library, built at first use; None (after one line on
    stderr) if it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                _lib = _load(build_native())
            except (OSError, RuntimeError) as e:
                msg = " / ".join(str(e).split("\n"))[:600]
                sys.stderr.write(f"fluidnet_tpu_torch.native unavailable "
                                 f"({msg}); using the NumPy fallbacks\n")
        return _lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def flood_fill_native(flags):
    """Connected fluid components (6-connected; fluid = bit 0 of the flag)
    on the host. flags: (B, 1, Z, Y, X) integer. Returns (labels (B, 1, Z,
    Y, X) int32, -1 off the fluid, n_components, component sizes (int64,
    the first min(n, MAX_COMPONENTS))), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    f = np.ascontiguousarray(flags, np.int32)
    if f.ndim != 5 or f.shape[1] != 1:
        raise ValueError(f"flood_fill_native: flags {f.shape}, expected "
                         "(B, 1, Z, Y, X)")
    B, _, Z, Y, X = f.shape
    labels = np.empty(f.shape, np.int32)
    sizes = np.zeros(MAX_COMPONENTS, np.int64)
    n = int(lib.fn_flood_fill(_ptr(f), B, Z, Y, X, _ptr(labels),
                              _ptr(sizes), MAX_COMPONENTS))
    return labels, n, sizes[:n]


def binvox_decode_native(raw, n_voxels):
    """binvox's (value, count) byte pairs expanded to `n_voxels` uint8
    values (zeros past a short input), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    rle = np.frombuffer(raw, np.uint8)
    out = np.zeros(n_voxels, np.uint8)
    lib.fn_binvox_decode(_ptr(rle), len(rle), _ptr(out), n_voxels)
    return out


def read_manta_frames_native(paths, Z, Y, X, is_3d, n_threads=8):
    """Reads same-shaped frame files in parallel (`n_threads` threads) into
    batch arrays: {'u_div_or_target' (N, 2|3, Z, Y, X), 'p', 'flags',
    'density' (N, 1, Z, Y, X)}. None without the library; raises IOError if
    a file is missing, short or of another shape."""
    lib = get_lib()
    if lib is None:
        return None
    cu = 3 if is_3d else 2
    n = len(paths)
    u = np.empty((n, cu, Z, Y, X), np.float32)
    p = np.empty((n, 1, Z, Y, X), np.float32)
    flags = np.empty((n, 1, Z, Y, X), np.int32)
    density = np.empty((n, 1, Z, Y, X), np.float32)
    blob = b"".join(os.fsencode(s) + b"\0" for s in paths)
    rc = lib.fn_read_manta_frames(blob, n, _ptr(u), _ptr(p), _ptr(flags),
                                  _ptr(density), Z, Y, X, cu, n_threads)
    if rc != 0:
        raise IOError(f"fn_read_manta_frames failed with code {rc}")
    return {"u_div_or_target": u, "p": p, "flags": flags,
            "density": density}
