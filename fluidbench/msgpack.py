"""Frozen copy of the msgpack reader of
fluidnet_tpu_torch/utils/checkpoint.py at commit a3725f6: it decodes the
subset flax writes (maps, arrays, str/bin, ints, floats, bool, nil, ext
types 1 and 3), so the benchmark reads a checkpoint's weights itself.
"""

import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, buf: bytes, raw: bool):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw        # str as bytes (flax's ndarray payload) or str

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n):
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def read(self):
        t = self.unpack("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}             # bin
        if t in sized:
            return bytes(self.take(self.unpack(sized[t])))
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}             # ext
        if t in sized:
            return self.ext(self.unpack(sized[t]))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        if 0xD4 <= t <= 0xD8:                                    # fixext
            return self.ext(1 << (t - 0xD4))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}             # str
        if t in sized:
            return self.str_(self.unpack(sized[t]))
        if t in (0xDC, 0xDD):
            n = self.unpack(">H" if t == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def map_(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray(payload: bytes):
    shape, dtype_name, data = unpackb(payload, raw=True)
    dtype = np.dtype(dtype_name.decode("ascii"))
    return np.frombuffer(data, dtype=dtype).reshape(shape, order="C")


def _ext(code, payload):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack: unsupported ext type {code}")


def unpackb(buf: bytes, raw: bool = False):
    """Decodes one msgpack object (flax.serialization.msgpack_restore's
    format). Arrays come back as read-only numpy arrays."""
    r = _Reader(buf, raw)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes")
    return obj


def _lists(tree):
    """flax's list encoding ({"0": a, "1": b}) back to lists."""
    if isinstance(tree, dict):
        out = {k: _lists(v) for k, v in tree.items()}
        if out and set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out
    return tree
