"""A read-only OCDBT key-value store over a directory: the store under an
orbax checkpoint (`ckpt_backend: orbax`, `use_ocdbt: true`), read with no
tensorstore.

OCDBT ("optionally-cooperative distributed B+tree", tensorstore's
`kvstore/ocdbt` kvstore) keeps one B+tree of keys -> values per version. The
layout read here, checked against tensorstore's own reader:

- Every manifest and B-tree node is a file region of: a magic number
  (uint32 big-endian: 0x0cdb3a2a a manifest, 0x0cdb20de a node), the
  region's length in bytes (uint64 little-endian), a version (varint, 0), a
  compression id (varint: 0 none, 1 zstd), the body (a zstd frame under
  compression 1), and a CRC-32C of all that precedes it (uint32 LE).
- Integers in a body are unsigned LEB128 varints unless said otherwise.
  Lists are columnar: a count, then each field for every item in turn.
- A data file table: count n; the shared-prefix length of each path with the
  previous one (items 1..n-1); each path's suffix length; each path's
  base-path length; the suffixes' bytes. A path is relative to the store's
  root (orbax's merged root names `ocdbt.process_0/d/...`).
- `manifest.ocdbt`: the config (16-byte uuid, manifest kind (0, one
  manifest file), max inline value bytes, max decoded node bytes, version
  tree arity log2 (a byte), compression method (0 none, 1 zstd, then its
  level as int32 LE)); a data file table; the newest versions (generation,
  root height (a byte), root node's file id / offset / length, its key
  count, tree bytes and indirect value bytes, commit time (uint64 LE)); the
  references to version tree nodes that hold the older versions (not read).
  The root of a version with no keys has offset and length 2^64 - 1.
- A B-tree node: height (a byte); a data file table; n entries; each key's
  shared-prefix length with the previous key (1..n-1) and suffix length,
  then, in an interior node, each entry's subtree common prefix length; the
  key suffixes' bytes. A leaf (height 0) then holds each value's length, its
  kind (0 inline, 1 in a data file), the file id and offset of each value
  in a data file, then the inline values' bytes. An interior node holds each
  child's file id, offset and length, then its key count, tree bytes and
  indirect value bytes. A node's keys follow the prefix its parent's entry
  gave it: the entry key's first `subtree common prefix length` bytes.

Anything else (another magic, version, compression, manifest kind, a bad
checksum, a height or key count that does not add up, bytes left over)
raises `ValueError` naming the file and what was wrong.
"""
from __future__ import annotations

import os
import os.path as osp
import struct

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_NODE = (1 << 64) - 1          # offset / length of an empty version's root


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), the checksum OCDBT files end with."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a decoded body; `where` names it in errors."""

    def __init__(self, data: bytes, where: str):
        self.buf, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what} (at byte {self.pos} of {len(self.buf)})")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            self.fail(f"ends inside a field of {n} bytes")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift >= 64:
                self.fail("a varint longer than 10 bytes")
        if out >= 1 << 64:
            self.fail("a varint over 64 bits")
        return out

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def u64s(self, n: int) -> list:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self):
        if self.pos != len(self.buf):
            self.fail(f"{len(self.buf) - self.pos} bytes follow the last field")

    def paths(self, prefix_lens: list, suffix_lens: list) -> list:
        """Strings stored with shared prefixes: each one the previous one's
        first `prefix_lens[i]` bytes, then `suffix_lens[i]` bytes of its own."""
        out, prev = [], b""
        for p, s in zip(prefix_lens, suffix_lens):
            if p > len(prev):
                self.fail(f"a shared prefix of {p} bytes after a key of {len(prev)}")
            prev = prev[:p] + self.take(s)
            out.append(prev)
        return out

    def data_file_table(self) -> list:
        n = self.varint()
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        base = self.varints(n)
        paths = self.paths(prefix, suffix)
        for p, b in zip(paths, base):
            if b > len(p):
                self.fail(f"a base path of {b} bytes in the data file path {p!r}")
            parts = p.decode().split("/")
            if p.startswith(b"/") or ".." in parts:
                self.fail(f"the data file path {p!r} leaves the store")
        return [p.decode() for p in paths]


def _unwrap(data: bytes, magic: int, where: str) -> bytes:
    """The body of a manifest or node region, its header and checksum checked."""
    if len(data) < 18:
        raise ValueError(f"{where}: {len(data)} bytes, shorter than an OCDBT header")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise ValueError(f"{where}: magic 0x{got:08x}, not 0x{magic:08x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"{where}: the header gives {length} bytes, the region has {len(data)}")
    crc = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"{where}: CRC-32C mismatch (stored 0x{crc:08x}, "
                         f"computed 0x{crc32c(data[:-4]):08x})")
    r = _Reader(data[:-4], where)
    r.pos = 12
    version = r.varint()
    if version != 0:
        r.fail(f"format version {version}, only 0 is known")
    compression = r.varint()
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, what=where)
    r.fail(f"compression id {compression} (0 none and 1 zstd are known)")


class OcdbtStore:
    """The newest version of the OCDBT store rooted at `root` (the directory
    holding `manifest.ocdbt`), read whole when opened: `keys()` and
    `read(key)`. Keys are bytes."""

    def __init__(self, root: str):
        self.root = root
        where = osp.join(root, "manifest.ocdbt")
        if not osp.isfile(where):
            raise ValueError(f"{root}: no manifest.ocdbt, not an OCDBT store")
        with open(where, "rb") as f:
            r = _Reader(_unwrap(f.read(), MANIFEST_MAGIC, where), where)
        r.take(16)                                          # uuid
        kind = r.varint()
        if kind != 0:
            r.fail(f"manifest kind {kind} (numbered manifests); only 0, one manifest "
                   "file, is known")
        r.varint()                                          # max inline value bytes
        r.varint()                                          # max decoded node bytes
        r.byte()                                            # version tree arity log2
        method = r.varint()
        if method == 1:
            r.take(4)                                       # zstd level
        elif method != 0:
            r.fail(f"compression method {method} (0 none and 1 zstd are known)")
        files = r.data_file_table()
        n = r.varint()
        if n == 0:
            r.fail("no version")
        gens = r.varints(n)
        heights = list(r.take(n))
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        nkeys = r.varints(n)
        r.varints(n)                                        # tree bytes
        r.varints(n)                                        # indirect value bytes
        r.u64s(n)                                           # commit times
        m = r.varint()                                      # version tree nodes
        for _ in range(5):                                  # generation, file, offset,
            r.varints(m)                                    # length, generations
        r.u64s(m)                                           # commit times
        r.take(m)                                           # heights
        r.end()
        if gens != sorted(set(gens)):
            r.fail(f"generations {gens} are not increasing")
        self.height = heights[-1]
        self.root_node = None           # (data file, offset, length) of the newest root
        self._values: dict = {}
        if offsets[-1] == _NO_NODE:
            if nkeys[-1] or lengths[-1] != _NO_NODE:
                r.fail("a version with no root node holds keys")
            return
        if fids[-1] >= len(files):
            r.fail(f"root node in data file {fids[-1]} of {len(files)}")
        self.root_node = (files[fids[-1]], offsets[-1], lengths[-1])
        got = self._node(*self.root_node, heights[-1], b"")
        if got != nkeys[-1]:
            r.fail(f"the newest version lists {nkeys[-1]} keys, its tree holds {got}")

    def _region(self, rel: str, offset: int, length: int) -> bytes:
        path = osp.join(self.root, *rel.split("/"))
        try:
            size = os.path.getsize(path)
        except OSError:
            raise ValueError(f"{self.root}: data file {rel} is missing") from None
        if offset + length > size:
            raise ValueError(f"{path}: bytes {offset}..{offset + length} past its end ({size})")
        with open(path, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def _node(self, rel: str, offset: int, length: int, height: int, prefix: bytes) -> int:
        """Read the node at (rel, offset, length) and its subtree into
        `_values`; returns the number of keys found."""
        where = f"{osp.join(self.root, rel)} [node at {offset}, {length} bytes]"
        r = _Reader(_unwrap(self._region(rel, offset, length), NODE_MAGIC, where), where)
        got = r.byte()
        if got != height:
            r.fail(f"node height {got}, its parent gives {height}")
        files = r.data_file_table()
        n = r.varint()
        if n == 0:
            r.fail("a node with no entries")
        prefix_lens = [0] + r.varints(n - 1)
        suffix_lens = r.varints(n)
        if height == 0:
            keys = r.paths(prefix_lens, suffix_lens)
            lens = r.varints(n)
            kinds = r.varints(n)
            if set(kinds) - {0, 1}:
                r.fail(f"value kinds {sorted(set(kinds))} (0 inline and 1 indirect are known)")
            outline = [i for i, k in enumerate(kinds) if k == 1]
            fids, offs = r.varints(len(outline)), r.varints(len(outline))
            for i, fid, off in zip(outline, fids, offs):
                if fid >= len(files):
                    r.fail(f"a value in data file {fid} of {len(files)}")
                self._values[prefix + keys[i]] = (files[fid], off, lens[i])
            for i, k in enumerate(kinds):
                if k == 0:
                    self._values[prefix + keys[i]] = r.take(lens[i])
            r.end()
            return n
        common = r.varints(n)
        keys = r.paths(prefix_lens, suffix_lens)
        fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        nkeys = r.varints(n)
        r.varints(n)                                        # tree bytes
        r.varints(n)                                        # indirect value bytes
        r.end()
        total = 0
        for key, c, fid, off, ln, want in zip(keys, common, fids, offs, lens, nkeys):
            if c > len(key) or fid >= len(files):
                r.fail(f"child {key!r}: common prefix {c}, data file {fid} of {len(files)}")
            got = self._node(files[fid], off, ln, height - 1, prefix + key[:c])
            if got != want:
                r.fail(f"child {key!r} lists {want} keys, its subtree holds {got}")
            total += got
        return total

    def keys(self) -> list:
        return sorted(self._values)

    def __contains__(self, key: bytes) -> bool:
        return key in self._values

    def read(self, key: bytes) -> bytes:
        """The value of `key`; a missing key raises `KeyError`."""
        v = self._values[key]
        if isinstance(v, bytes):
            return v
        rel, offset, length = v
        return self._region(rel, offset, length)
