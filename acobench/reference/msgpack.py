"""A frozen copy of the program's reader of Flax msgpack checkpoints
(deepaco_tpu_torch/utils/checkpoint.py:26-139), so that the reference reads
its weights with nothing of the program. It decodes the subset that
``flax.serialization.to_bytes`` writes: maps, arrays, str, bin, int,
float, bool, nil and the extension types 1 (ndarray), 2 (complex) and 3
(numpy scalar), and joins ``__msgpack_chunked_array__`` maps back.
"""
from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(fixext[b])))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def unpackb(data: bytes):
    """Decode one msgpack object (the subset described in the module doc)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(payload)
        return complex(re, im)
    raise ValueError(f"unsupported msgpack extension type {code}")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """Counterpart of ``flax.serialization.msgpack_restore``."""
    return _unchunk(unpackb(data))


def load(path: str) -> dict:
    """The checkpoint at ``path`` as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
