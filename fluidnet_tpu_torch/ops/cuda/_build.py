"""Build and load the port's CUDA kernels.

Every `fluidnet_tpu_torch/csrc/*.cu` is compiled by its own nvcc process,
all started together, into an object file, and the objects are linked
into one shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xptxas -v -Xcompiler -fPIC -c -o build/kernels/<source>.o <source>
    nvcc -shared -o build/kernels/libfluidnet_tpu_torch.so build/kernels/*.o

at first use (or when a source is newer than the library), and loaded with
ctypes. No PyTorch headers are compiled, which keeps the build to seconds.
`-fmad=false` stops nvcc from contracting a*b+c into one FMA, so a kernel
rounds each operation as PyTorch's elementwise ops do and matches its
plain version to the last bits. `build` returns ptxas's report
(registers, shared memory, spills per kernel) beside its time.

Conventions of every C entry point: pointers and the stream are
`c_void_p`, the kernel launches on the given stream (the caller passes
torch.cuda.current_stream()), it never synchronises or allocates, and it
returns cudaGetLastError() — `check` raises if that is not 0.

`launches` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else (K3 counts one per solve that
sweeps, whatever its route; K5 one per warp call, K6 one per adjoint).
"""

import collections
import ctypes
import functools
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libfluidnet_tpu_torch.so")
ARCH = "arch=compute_90a,code=sm_90a"

launches = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures (argtypes) of the entry points in csrc/.
_SIGNATURES = {
    # u, s, m, fwd_u, fwd_s, free, out, B, Z, Y, X, z0, dcoef, strength,
    # lim, is_bwd, ours, renorm, scalar, fuse, window, tile height (0: the
    # global route), planes a block, stream
    "fluidnet_mac_sweep": [_P] * 7 + [_I] * 5 + [_F] * 3 + [_I] * 8 + [_P],
    # is_bwd, ours, renorm, scalar, fuse, window, tile height, resident
    # blocks an SM (out)
    "fluidnet_mac_sweep_occupancy": [_I] * 7 + [_P],
    # u, flags, rho, ubc, uinv, out, B, Z, Y, X, YB, epi, scal7[7], tile
    # height, planes a block, stream
    "fluidnet_prologue": [_P] * 6 + [_I] * 6 + [_F] * 7 + [_I] * 2 + [_P],
    # u, flags, out, B, Z, Y, X, amp, tile height, planes a block, stream
    "fluidnet_vorticity": [_P] * 3 + [_I] * 4 + [_F] + [_I] * 2 + [_P],
    # div, flags, p0 (null: p = 0), out, scratch, B, Z, Y, X, n_sweeps,
    # route, rows per block, halo rows, shared-memory bytes, stream
    "fluidnet_jacobi": [_P] * 5 + [_I] * 9 + [_P],
    # resident blocks (out), shared-memory limit (out)
    "fluidnet_jacobi_limits": [_P] * 2,
    # srcs[], fs[], n_src, px, py, pz, out, B, G, Z, Y, X, z0, window,
    # nearest, minmax, cmin, cmax, skip_pair, stream
    "fluidnet_warp": [_P, _P, _I] + [_P] * 4 + [_I] * 12 + [_P],
    # g, px, py, pz, out, B, G, F, Z, Y, X, z0, window, nearest, stream
    "fluidnet_warp_transpose": [_P] * 5 + [_I] * 9 + [_P],
    # src, idx, out, R, C, axis, idx64, stream
    "fluidnet_dyngather": [_P] * 3 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _stale(sources):
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = sources + glob.glob(os.path.join(SRC_DIR, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in deps)


def build(force: bool = False):
    """Compiles csrc/*.cu into LIB_PATH if it is missing or stale (or
    `force`), one nvcc process per source, all at once. Returns (seconds
    spent compiling, ptxas's report), (0.0, "") if up to date. Raises
    RuntimeError with nvcc's output if the build fails."""
    sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    if not force and not _stale(sources):
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] +
                           f".{tag}.o")
        cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-fmad=false",
               "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c",
               "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        report.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = f"{LIB_PATH}.{tag}"
        cmd = [nvcc, "-gencode", ARCH, "-shared", "-o", tmp] + objs
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return time.perf_counter() - t0, "".join(report)


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, name: str):
    """Raises if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_cuda(name, *tensors, dtypes=None):
    """Validates a kernel's tensor arguments: all on one CUDA device,
    contiguous, of the expected dtypes. Returns that device."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} on {t.device}, expected "
                             f"the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise ValueError(f"{name}: argument {i} is {t.dtype}, expected "
                             f"{dtypes[i]}")
    return dev
