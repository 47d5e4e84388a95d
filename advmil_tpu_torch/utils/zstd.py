"""zstd decompression (RFC 8878) through the system's libzstd, bound with
`ctypes`: what an orbax checkpoint (`ckpt_backend: orbax`) needs, with no
Python zstd package.

The streaming API (`ZSTD_decompressStream`) is used because the frames
tensorstore writes for zarr chunks record no content size; where the caller
knows the size (a chunk's elements x itemsize), `decompress` checks it.
Concatenated frames decode one after another, as `zstd -d` decodes them.

The library is loaded at the first call (`ctypes.util.find_library("zstd")`):
msgpack and torch checkpoints never load it. Without it the call raises an
`ImportError` that names libzstd.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise ImportError("libzstd (the zstd shared library) was not found: reading an orbax "
                          "checkpoint (ckpt_backend: orbax) needs it to decompress the "
                          "checkpoint's files; install the system's zstd library")
    lib = ctypes.CDLL(name)
    sig = {"ZSTD_createDStream": ([], ctypes.c_void_p),
           "ZSTD_initDStream": ([ctypes.c_void_p], ctypes.c_size_t),
           "ZSTD_decompressStream": ([ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
                                      ctypes.POINTER(_InBuffer)], ctypes.c_size_t),
           "ZSTD_freeDStream": ([ctypes.c_void_p], ctypes.c_size_t),
           "ZSTD_isError": ([ctypes.c_size_t], ctypes.c_uint),
           "ZSTD_getErrorName": ([ctypes.c_size_t], ctypes.c_char_p),
           "ZSTD_DStreamOutSize": ([], ctypes.c_size_t),
           "ZSTD_versionString": ([], ctypes.c_char_p)}
    for fn, (args, res) in sig.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res
    return lib


def library() -> str:
    """The libzstd in use and its version, e.g. `libzstd.so.1 1.5.4`."""
    lib = _lib()
    return f"{lib._name} {lib.ZSTD_versionString().decode()}"


def decompress(data, size: int | None = None, what: str = "zstd data") -> bytes:
    """The bytes of the zstd frame(s) `data`. With `size`, the output must
    be exactly `size` bytes. A corrupt or truncated frame, or empty input,
    raises `ValueError` naming `what`."""
    lib = _lib()
    n = len(data)
    if n == 0:
        raise ValueError(f"{what}: no zstd frame (empty input)")
    src = (ctypes.c_char * n).from_buffer_copy(data)
    cap = size + 1 if size is not None else max(int(lib.ZSTD_DStreamOutSize()), 4 * n)
    buf = ctypes.create_string_buffer(cap)
    out = bytearray()
    inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), n, 0)
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        ret = lib.ZSTD_initDStream(ds)
        if lib.ZSTD_isError(ret):
            raise ValueError(f"ZSTD_initDStream: {lib.ZSTD_getErrorName(ret).decode()}")
        while True:
            outb = _OutBuffer(ctypes.cast(buf, ctypes.c_void_p), cap, 0)
            before = inb.pos
            ret = lib.ZSTD_decompressStream(ds, ctypes.byref(outb), ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                raise ValueError(f"{what}: corrupt zstd frame "
                                 f"({lib.ZSTD_getErrorName(ret).decode()})")
            out += ctypes.string_at(buf, outb.pos)
            if size is not None and len(out) > size:
                raise ValueError(f"{what}: decompresses to more than the {size} bytes expected")
            if inb.pos == n and outb.pos < cap:
                break
            if inb.pos == before and outb.pos == 0:
                raise ValueError(f"{what}: zstd made no progress at byte {inb.pos} of {n}")
    finally:
        lib.ZSTD_freeDStream(ds)
    if ret != 0:
        raise ValueError(f"{what}: truncated zstd frame ({n} bytes read, "
                         f"{len(out)} decoded, the frame is not complete)")
    if size is not None and len(out) != size:
        raise ValueError(f"{what}: decompresses to {len(out)} bytes, {size} expected")
    return bytes(out)
