"""A reader of zarr v2 arrays in a key-value store (an orbax checkpoint's
leaves, each `<path>/.zarray` + chunks in its OCDBT store), with no zarr or
tensorstore.

`.zarray` is JSON: `zarr_format` 2, `shape`, `chunks`, `dtype` (a numpy
type string: `<f4`, `<i8`, `|b1`, ...), `order` ("C" or "F", the layout of
each chunk's bytes), `fill_value`, `filters`, `compressor` and
`dimension_separator`. Chunk (i, j, ...) is
`<path>/i.j...` (the separator `.` or `/`); a 0-d array is one chunk, `0`.
A chunk holds the whole chunk shape, also at the array's edge, where what
lies past the shape is dropped. A missing chunk reads as `fill_value`; with
`fill_value: null` (orbax's, which writes every chunk) it raises.

Known: the compressors `zstd` and none, no filters. Another compressor, a
filter, a structured dtype or a zarr v3 array (`zarr.json`) raises
`ValueError` naming it.
"""
from __future__ import annotations

import itertools
import json
import math

import numpy as np

from . import zstd

_FILL_WORDS = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def _dtype(name, where: str):
    if not isinstance(name, str):
        raise ValueError(f"{where}: structured dtype {name!r} is not known")
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"{where}: dtype {name!r} is not known") from None
    if dt.kind not in "biufc" or dt.fields is not None:
        raise ValueError(f"{where}: dtype {name!r} is not known (bool, int, float, complex)")
    return dt


def read_array(store, path: str):
    """The array at `path` in `store` (an object with `read(key) -> bytes`
    and `in`): a numpy array in native byte order."""
    if f"{path}/zarr.json".encode() in store:
        raise ValueError(f"{path}: a zarr v3 array (zarr.json); only zarr v2 is known")
    key = f"{path}/.zarray".encode()
    if key not in store:
        raise ValueError(f"{path}: no .zarray in the store")
    where = f"{path}/.zarray"
    meta = json.loads(store.read(key))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')!r}, 2 is known")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or min(chunks, default=1) < 1:
        raise ValueError(f"{where}: chunks {list(chunks)} for shape {list(shape)}")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{where}: order {order!r}, C or F is known")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {[f.get('id') for f in meta['filters']]} "
                         "are not known")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {comp.get('id')!r} is not known (zstd or none)")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"{where}: dimension_separator {sep!r}")
    dt = _dtype(meta["dtype"], where)
    fill = meta.get("fill_value")
    fill = _FILL_WORDS.get(fill, fill)
    out = np.empty(shape, dt) if fill is None else np.full(shape, fill, dt)
    chunk_bytes = math.prod(chunks) * dt.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        name = sep.join(map(str, idx)) if idx else "0"
        ckey = f"{path}/{name}".encode()
        if ckey not in store:
            if fill is None:
                raise ValueError(f"{path}: chunk {name} is missing and fill_value is null")
            continue
        raw = store.read(ckey)
        what = f"{path}/{name}"
        if comp is not None:
            raw = zstd.decompress(raw, chunk_bytes, what=what)
        elif len(raw) != chunk_bytes:
            raise ValueError(f"{what}: {len(raw)} bytes, {chunk_bytes} expected")
        block = np.frombuffer(raw, dt).reshape(chunks, order=order)
        lo = [i * c for i, c in zip(idx, chunks)]
        part = tuple(slice(0, min(c, s - l)) for c, s, l in zip(chunks, shape, lo))
        out[tuple(slice(l, l + p.stop) for l, p in zip(lo, part))] = block[part]
    return out.astype(dt.newbyteorder("="), copy=False)
