"""A reader of the files `flax.serialization.msgpack_serialize` writes (the
JAX package's `.ckpt`), with neither flax nor the `msgpack` package.

msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md) is a
tagged binary format: maps, arrays, str / bin, ints, floats, bool and nil,
big-endian, plus "ext" values of an application type. flax adds three ext
types:

- 1, an ndarray: a nested msgpack array (shape, dtype name, C-order bytes);
- 2, a Python complex: a nested msgpack array (real, imag);
- 3, a numpy scalar: an ndarray of shape () read back as its scalar.

Arrays over `MAX_CHUNK_SIZE` bytes (1 GiB) are written as a map
`{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
..., ...}}` of flat pieces, and joined again here. Tuples come back as lists
(msgpack has one array type), as they do from `flax.serialization.
msgpack_restore`.

Leaves are numpy arrays, except `bfloat16`, which numpy lacks: those are
`torch.bfloat16` tensors (a bf16 scalar is a 0-d tensor).
"""
from __future__ import annotations

import struct

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# fixed-width scalars: tag -> struct format
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length-prefixed values: tag -> (kind, struct format of the length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside a value")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.take(1)[0]
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.map(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return [self.value() for _ in range(tag & 0x0f)]
        if 0xa0 <= tag <= 0xbf:
            return str(self.take(tag & 0x1f), "utf-8")
        if tag in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[tag]
        if tag in _SCALARS:
            return self.unpack(_SCALARS[tag])
        if tag in _FIXEXT:
            code = self.unpack(">b")
            return _ext(code, self.take(_FIXEXT[tag]))
        if tag not in _SIZED:
            raise ValueError(f"msgpack tag 0x{tag:02x} at byte {self.pos - 1} is not valid")
        kind, fmt = _SIZED[tag]
        n = self.unpack(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _loads(data):
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes follow the msgpack value")
    return out


def _ndarray(data):
    """flax's ndarray payload: msgpack (shape, dtype name, C-order bytes)."""
    shape, name, buf = _loads(data)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        a = _ndarray(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    if code == EXT_COMPLEX:
        re, im = _loads(data)
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _unchunk(d: dict):
    shape = tuple(int(d["shape"][str(i)]) for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _join_chunks(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _join_chunks(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data) -> object:
    """The tree of `flax.serialization.msgpack_restore(data)`: nested dicts and
    lists of Python scalars, numpy arrays and (bfloat16) torch tensors."""
    return _join_chunks(_loads(data))


def read(path: str) -> object:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file beginning with `head` holds a msgpack map (the form of
    every flax checkpoint bundle)."""
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))
