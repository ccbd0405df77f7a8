"""Checkpoints: read the JAX package's, write and resume the port's.

A JAX checkpoint directory holds `mconf.json` ({"mconf": the model config,
"extra": epoch and best losses}) and `state.msgpack`, a flax-serialized
pytree {params, opt_state, step}. This module decodes it with a small
msgpack reader of its own, so the port needs neither flax nor msgpack. It
covers the subset flax writes: maps, arrays, str/bin, ints, floats, bool,
nil, and flax's ext types 1 (ndarray) and 3 (numpy scalar), whose payload
is a msgpack (shape, dtype name, C-order bytes) triple
(flax/serialization.py::_ndarray_to_bytes). flax writes lists as maps
keyed "0", "1", ...; `load_params` turns those back into lists.

The port writes `mconf.json` in the same layout (so both packages'
load_mconf read it) and its own `state.pt` (torch.save): the params under
their JAX tree paths ("stages/0/0/conv/w", ...), the optimizer state and
the step. `load_checkpoint` resumes from either file, state.pt first.
"""

import json
import os
import struct

import numpy as np
import torch

from fluidnet_tpu_torch.core.config import ModelConfig, from_dict, to_dict

STATE_FILE = "state.pt"

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


def load_state(path) -> dict:
    """The raw state dict of `path`/state.msgpack (as msgpack_restore)."""
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        return unpackb(f.read())


def load_params(path) -> dict:
    """The params pytree of a checkpoint directory, numpy leaves, in the
    JAX layout ({"stages": [[{"conv": {"w", "b"}}], ...], "final": ...})."""
    return _lists(load_state(path)["params"])


def load_mconf(path) -> ModelConfig:
    with open(os.path.join(path, "mconf.json")) as f:
        return from_dict(json.load(f)["mconf"])


def save_checkpoint(path, state, mconf: ModelConfig, extra=None):
    """Writes `path`/mconf.json (the JAX layout) and `path`/state.pt for a
    train.train.TrainState: params by JAX tree path, optimizer state and
    step, all on the CPU."""
    os.makedirs(path, exist_ok=True)

    def host(v):
        if isinstance(v, list):
            return [t.detach().cpu() for t in v]
        return v.detach().cpu()
    blob = {"params": {k: t.detach().cpu()
                       for k, t in state.model.jax_named_parameters()},
            "opt_state": {k: host(v) for k, v in state.opt_state.items()},
            "step": int(state.step)}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, "mconf.json"), "w") as f:
        json.dump({"mconf": to_dict(mconf), "extra": extra or {}}, f,
                  indent=2, sort_keys=True)


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _jax_opt_state(opt, names):
    """The optimizer state of a JAX checkpoint's optax chain (clip,
    inject_hyperparams(method), ...) in the port's layout; None if its
    layout is not one of the four methods'."""
    try:
        inj = opt["1"]
        inner = inj["inner_state"]["0"]
        out = {"learning_rate": np.asarray(inj["hyperparams"]
                                           ["learning_rate"])}
        for key in ("mu", "nu", "trace", "sum_of_squares"):
            if key in inner:
                out[key] = [np.asarray(_at(inner[key], n)) for n in names]
        if "count" in inner:
            out["count"] = np.asarray(inner["count"])
        return out
    except (KeyError, TypeError):
        return None


def load_checkpoint(path, state):
    """Loads `path` into the train.train.TrainState `state` (in place:
    params, optimizer state, step) from state.pt, or else from a JAX
    state.msgpack (params, step and the optimizer state when its layout
    matches). Returns (state, mconf, extra)."""
    with open(os.path.join(path, "mconf.json")) as f:
        meta = json.load(f)
    named = state.model.jax_named_parameters()
    names = [k for k, _ in named]
    if os.path.exists(os.path.join(path, STATE_FILE)):
        blob = torch.load(os.path.join(path, STATE_FILE),
                          weights_only=True)
        params = blob["params"]
        opt = blob["opt_state"]
        step = blob["step"]
    else:
        raw = load_state(path)
        params = {k: _at(raw["params"], k) for k in names}
        opt = _jax_opt_state(raw.get("opt_state"), names)
        step = int(np.asarray(raw.get("step", 0)))
    with torch.no_grad():
        for k, t in named:
            v = torch.as_tensor(np.array(params[k]), dtype=t.dtype)
            if v.shape != t.shape:
                raise ValueError(f"checkpoint {path}: {k} has shape "
                                 f"{tuple(v.shape)}, the model "
                                 f"{tuple(t.shape)}")
            t.copy_(v)
    if opt is not None and set(opt) == set(state.opt_state):
        dev = state.params[0].device

        def dev_(v, like):
            return torch.as_tensor(np.array(v), dtype=like.dtype).to(dev)
        state.opt_state = {
            k: ([dev_(x, y) for x, y in zip(v, state.opt_state[k])]
                if isinstance(v, list) else dev_(v, state.opt_state[k]))
            for k, v in opt.items()}
    state.step = int(step)
    return state, from_dict(meta["mconf"]), meta.get("extra", {})
