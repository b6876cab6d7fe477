"""Reader and writer for the Flax msgpack checkpoints in ``checkpoints/``.

``flax.serialization.to_bytes`` writes a TrainState as msgpack: nested maps
with string keys, and every array as msgpack extension type 1 whose payload
is itself msgpack of ``(shape, dtype name, raw bytes)``. The machine with the
card has no ``msgpack`` package, so this module decodes the subset that Flax
writes by hand: maps, arrays, str, bin, int, float, bool, nil and the
extension types 1 (ndarray), 2 (complex) and 3 (numpy scalar). Arrays larger
than 1 GiB, which Flax splits into ``__msgpack_chunked_array__`` maps, are
joined back. The result is nested dicts of numpy arrays with the top keys
``params``, ``batch_stats``, ``opt_state`` and ``step``.

:func:`save_checkpoint` writes the same layout back (maps with string keys,
numpy arrays and scalars as extension types 1 and 3), so that the JAX
package's ``load_checkpoint`` restores a file the port wrote.
:func:`save_params_npz` writes the flat ``.npz`` export of a parameter
tree (checkpoint.py:33-40).
"""
from __future__ import annotations

import os
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


def load_checkpoint(path: str) -> dict:
    """Read a Flax TrainState msgpack file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# ---------------------------------------------------------------- writer ---
def _pack_len(out: list, n: int, codes, fix: int | None = None,
              fix_max: int = 0) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (type byte, struct format, limit) that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too long")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))
_MAX_CHUNK_BYTES = 2 ** 30       # flax.serialization.MAX_CHUNK_SIZE
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_int(out: list, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if -v <= limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n]]))
    else:
        _pack_len(out, n, _EXT)
    out.append(struct.pack(">b", code) + payload)


def _ndarray_bytes(a: np.ndarray) -> bytes:
    """Flax's ndarray payload: msgpack of ``(shape, dtype name, raw bytes)``."""
    return packb([list(a.shape), a.dtype.name, np.ascontiguousarray(a).tobytes()])


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), _STR, 0xA0, 32)
        out.append(data)
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), _BIN)
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), _ARRAY, 0x90, 16)
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), _MAP, 0x80, 16)
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > _MAX_CHUNK_BYTES:
            raise ValueError("arrays above 1 GiB would be chunked by Flax; "
                             "the writer does not chunk")
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} as msgpack")


def packb(obj) -> bytes:
    """Encode the subset that Flax writes: maps, arrays, str, bin, int,
    float, bool, nil, numpy arrays (ext 1) and numpy scalars (ext 3)."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


def save_checkpoint(path: str, state) -> None:
    """Write a train state as ``flax.serialization.to_bytes`` writes the JAX
    ``TrainState``: ``state`` is that tree of numpy leaves, or an object
    whose ``tree()`` returns it (``train.reinforce.TrainState``). The file is
    replaced atomically. Arrays above 1 GiB, which Flax would split into
    chunks, are refused."""
    tree = state if isinstance(state, dict) else state.tree()
    data = packb(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_params_npz(path: str, params: dict) -> None:
    """The flat ``.npz`` export of a parameter tree (nested dicts of arrays,
    e.g. ``models.gnn.to_jax_variables(net)["params"]``): one array for each
    leaf, named by its keys joined with ``/`` (``emb_net/v_lins1_0/kernel``),
    the names ``jax.tree_util``'s key paths give in the JAX package."""
    flat = {}

    def walk(node, keys):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], (*keys, str(key)))
        else:
            flat["/".join(keys)] = np.asarray(node)

    walk(params, ())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
