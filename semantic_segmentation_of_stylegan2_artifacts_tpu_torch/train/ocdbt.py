"""OCDBT, TensorStore's "optionally-cooperative distributed B-tree"
key-value store, read and written without TensorStore: the store under an
orbax checkpoint directory (``train/orbax.py``).

Layout, as TensorStore writes it (every integer a LEB128 varint unless
marked):

* A file (``manifest.ocdbt``, or a B-tree node inside a data file) is a
  header -- magic (u32 big-endian: ``0x0cdb3a2a`` manifest, ``0x0cdb20de``
  node), length of the whole file (u64 little-endian), format version 0,
  compression (0 none, 1 zstd) -- then the body, zstd-framed when the
  compression is 1, then the CRC-32C of everything before it (u32 LE).
* The manifest's body: the config (uuid: 16 bytes; manifest kind, 0 for
  one file; max inline value bytes; max decoded node bytes; version-tree
  arity log2: u8; compression, with a zstd level as i32 LE), then the
  versions: a data-file table and, column by column, each version's
  generation, root height (u8), root node reference (data file, offset,
  length), key count, tree bytes, indirect value bytes and commit time (u64
  LE ns); then the references to older version-tree nodes, which a read of
  the newest version does not need.
* A data-file table: the count, then the paths prefix-coded against the
  path before (prefix lengths of all but the first, suffix lengths,
  base-path lengths, the suffix bytes).  A path is relative to the store's
  root: ``d/<32 hex>`` or, in a store orbax merged from its processes,
  ``ocdbt.process_0/d/<32 hex>``.
* A node's body: height (u8), its data-file table, the entry count, the
  keys prefix-coded as the paths are, relative to the prefix every key of
  the node shares (given by the parent); then for a leaf the value lengths,
  the value kinds (0 inline, 1 in a data file), the data file and offset of
  each indirect value and the inline values' bytes; for an interior node,
  after the key lengths, the length of each child's common key prefix
  (before the key bytes), then the children's references, key counts, tree
  bytes and indirect value bytes.

The writer writes one version, every file uncompressed (compression 0, the
config's compression none): values past ``MAX_INLINE`` bytes go to one data
file, the nodes, each about ``NODE_BYTES`` at most, to another.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE = 1024          # orbax's max_inline_value_bytes
MAX_DECODED_NODE = 100_000_000  # orbax's max_decoded_node_bytes
NODE_BYTES = 1 << 20       # the writer's bound on an encoded node
_EMPTY = (1 << 64) - 1     # the offset and length of an empty tree


class _Reader:
    """Varints and fixed fields of one decoded body, bounds-checked."""

    def __init__(self, buf: bytes, what: str):
        self.b = buf
        self.i = 0
        self.what = what

    def fail(self, msg: str):
        raise ValueError(f"{self.what}: {msg}")

    def u8(self) -> int:
        if self.i >= len(self.b):
            self.fail("truncated")
        self.i += 1
        return self.b[self.i - 1]

    def var(self) -> int:
        r = shift = 0
        while True:
            c = self.u8()
            r |= (c & 0x7F) << shift
            if c < 0x80:
                return r
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def vars(self, n: int) -> List[int]:
        return [self.var() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if n > len(self.b) - self.i:
            self.fail("truncated")
        self.i += n
        return self.b[self.i - n:self.i]

    def fixed(self, fmt: str) -> int:
        return struct.unpack(fmt, self.raw(struct.calcsize(fmt)))[0]

    def prefixed(self, n: int, extra: int = 0) -> Tuple[List[bytes], List[List[int]]]:
        """``n`` prefix-coded strings, with ``extra`` more columns of ``n``
        varints read between the suffix lengths and the suffix bytes."""
        prefix = [0] + self.vars(n - 1) if n else []
        suffix = self.vars(n)
        cols = [self.vars(n) for _ in range(extra)]
        out, prev = [], b""
        for p, s in zip(prefix, suffix):
            if p > len(prev):
                self.fail("key prefix longer than the key before")
            prev = prev[:p] + self.raw(s)
            out.append(prev)
        return out, cols


def _decode_file(data: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node, its CRC-32C checked."""
    if len(data) < 18:
        raise ValueError(f"{what}: truncated")
    got_magic, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{what}: bad magic {got_magic:#010x}")
    if length != len(data):
        raise ValueError(f"{what}: length {length}, {len(data)} bytes read")
    if zstd.crc32c(memoryview(data)[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise ValueError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.i = 12
    if r.var() != 0:
        r.fail("unknown format version")
    compression = r.var()
    body = data[r.i:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, limit=MAX_DECODED_NODE * 4)
    raise ValueError(f"{what}: unknown compression {compression}")


def _data_files(r: _Reader) -> List[str]:
    n = r.var()
    paths, _ = r.prefixed(n, extra=1)  # the base-path lengths: part of the path
    return [p.decode() for p in paths]


class Store:
    """The newest version of the OCDBT store at ``root``, every key read at
    open: :meth:`get` reads a value, from the node or its data file."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise FileNotFoundError(f"{path}: no OCDBT manifest")
        r = _Reader(_decode_file(path.read_bytes(), MANIFEST_MAGIC, str(path)), str(path))
        r.raw(16)  # uuid
        kind = r.var()
        if kind != 0:
            r.fail("numbered manifests are not supported (orbax writes one file)")
        r.var()  # max inline value bytes
        r.var()  # max decoded node bytes
        r.u8()  # version tree arity log2
        if r.var() == 1:
            r.fixed("<i")  # zstd level
        files = _data_files(r)
        n = r.var()
        if n == 0:
            r.fail("no version")
        cols = [r.vars(n)]          # generation
        cols.append([r.u8() for _ in range(n)])  # root height
        cols += [r.vars(n) for _ in range(6)]    # file, offset, length, keys, tree, indirect
        latest = max(range(n), key=lambda i: cols[0][i])
        height, fid, off, length, nkeys = (c[latest] for c in cols[1:6])
        self.values: Dict[bytes, Tuple] = {}
        if nkeys and off != _EMPTY:
            self._node(files, fid, off, length, height, b"")

    def _file(self, files: List[str], fid: int, what: str) -> Path:
        if fid >= len(files):
            raise ValueError(f"{what}: data file {fid} of {len(files)}")
        return self.root / files[fid]

    def _node(self, files, fid, off, length, height, prefix: bytes) -> None:
        path = self._file(files, fid, "node reference")
        what = f"{path} node at {off}"
        with open(path, "rb") as fh:
            fh.seek(off)
            data = fh.read(length)
        r = _Reader(_decode_file(data, NODE_MAGIC, what), what)
        if r.u8() != height:
            r.fail(f"height {r.b[0]}, {height} expected")
        node_files = _data_files(r)
        n = r.var()
        if height == 0:
            keys, _ = r.prefixed(n)
            lengths = r.vars(n)
            kinds = r.vars(n)
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            if len(indirect) + kinds.count(0) != n:
                r.fail("unknown value kind")
            ids, offs = r.vars(len(indirect)), r.vars(len(indirect))
            refs = dict(zip(indirect, zip(ids, offs)))
            for i, key in enumerate(keys):
                if i in refs:
                    vfid, voff = refs[i]
                    self.values[prefix + key] = (self._file(node_files, vfid, what), voff,
                                                 lengths[i])
                else:
                    self.values[prefix + key] = (r.raw(lengths[i]),)
            return
        keys, (common,) = r.prefixed(n, extra=1)
        ids, offs, lens = r.vars(n), r.vars(n), r.vars(n)
        for i, key in enumerate(keys):
            if common[i] > len(key):
                r.fail("child prefix longer than its key")
            self._node(node_files, ids[i], offs[i], lens[i], height - 1,
                       prefix + key[:common[i]])

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self.values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self.values

    def get(self, key: str) -> Optional[np.ndarray]:
        """The value of ``key`` as uint8, or None when the store lacks it."""
        ref = self.values.get(key.encode())
        if ref is None:
            return None
        if len(ref) == 1:
            return np.frombuffer(ref[0], np.uint8)
        path, off, length = ref
        out = np.fromfile(path, dtype=np.uint8, count=length, offset=off)
        if out.size != length:
            raise ValueError(f"{path}: {out.size} bytes at {off}, {length} expected")
        return out


# ---- writer ------------------------------------------------------------------
def _var(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _vars(vs: Iterable[int]) -> bytes:
    return b"".join(_var(v) for v in vs)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _prefixed(strings: List[bytes], extra: Iterable[List[int]] = ()) -> bytes:
    prefix = [_common(a, b) for a, b in zip(strings, strings[1:])]
    out = [_vars(prefix), _vars(len(s) - p for s, p in zip(strings, [0] + prefix))]
    out += [_vars(col) for col in extra]
    out += [s[p:] for s, p in zip(strings, [0] + prefix)]
    return b"".join(out)


def _table(paths: List[str]) -> bytes:
    enc = [p.encode() for p in paths]
    return _var(len(enc)) + _prefixed(enc, [[0] * len(enc)]) if enc else _var(0)


def _file_bytes(magic: int, body: bytes) -> bytes:
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + 2 + len(body) + 4) + b"\x00\x00"
    data = head + body
    return data + struct.pack("<I", zstd.crc32c(data))


class _Child:
    """A written node: its first and last key, reference and totals."""

    def __init__(self, first, last, off, length, keys, tree, indirect):
        self.first, self.last = first, last
        self.off, self.length = off, length
        self.keys, self.tree, self.indirect = keys, tree, indirect


def write_store(root, items: Iterable[Tuple[str, object]]) -> None:
    """Write ``(key, value)`` pairs (values: bytes-like or uint8-viewable
    arrays) as a new OCDBT store at ``root``, which must not hold one."""
    root = Path(root)
    (root / "d").mkdir(parents=True, exist_ok=True)
    if (root / "manifest.ocdbt").exists():
        raise FileExistsError(f"{root}: an OCDBT store is there already")
    values_name = f"d/{uuid.uuid4().hex}"
    nodes_name = f"d/{uuid.uuid4().hex}"
    entries = []  # (key, inline bytes or None, length, offset)
    with open(root / values_name, "wb") as vf:
        for key, value in sorted(items, key=lambda kv: kv[0].encode()):
            view = memoryview(np.ascontiguousarray(value).reshape(-1).view(np.uint8)
                              if isinstance(value, np.ndarray) else value).cast("B")
            if view.nbytes <= MAX_INLINE:
                entries.append((key.encode(), bytes(view), view.nbytes, 0))
            else:
                entries.append((key.encode(), None, view.nbytes, vf.tell()))
                vf.write(view)
        has_values = vf.tell() > 0
    if not has_values:
        os.remove(root / values_name)
    if not entries:
        raise ValueError(f"{root}: an empty store")
    keys = [e[0] for e in entries]
    if len(set(keys)) != len(keys):
        raise ValueError(f"{root}: duplicate keys")

    with open(root / nodes_name, "wb") as nf:
        def emit(height: int, group: List, prefix: bytes, body_of) -> _Child:
            body = bytes([height]) + body_of([k[len(prefix):] for k in _group_keys(group)])
            data = _file_bytes(NODE_MAGIC, body)
            off = nf.tell()
            nf.write(data)
            return off, len(data)

        # a node's keys are relative to the prefix every key of its subtree
        # shares, which its parent gives it; the root's parent gives none
        def leaf(group, root: bool) -> _Child:
            first, last = group[0][0], group[-1][0]
            prefix = b"" if root else first[:_common(first, last)]
            indirect = [e for e in group if e[1] is None]

            def body_of(rel):
                out = [_table([values_name] if indirect else []), _var(len(group)),
                       _prefixed(rel), _vars(e[2] for e in group),
                       _vars(0 if e[1] is not None else 1 for e in group),
                       _vars(0 for _ in indirect), _vars(e[3] for e in indirect)]
                out += [e[1] for e in group if e[1] is not None]
                return b"".join(out)

            off, length = emit(0, group, prefix, body_of)
            return _Child(first, last, off, length, len(group), length,
                          sum(e[2] for e in indirect))

        def interior(height, group: List[_Child], root: bool) -> _Child:
            first, last = group[0].first, group[-1].last
            prefix = b"" if root else first[:_common(first, last)]

            def body_of(rel):
                common = [_common(c.first, c.last) - len(prefix) for c in group]
                return b"".join([
                    _table([nodes_name]), _var(len(group)), _prefixed(rel, [common]),
                    _vars(0 for _ in group), _vars(c.off for c in group),
                    _vars(c.length for c in group), _vars(c.keys for c in group),
                    _vars(c.tree for c in group), _vars(c.indirect for c in group)])

            off, length = emit(height, group, prefix, body_of)
            return _Child(first, last, off, length, sum(c.keys for c in group),
                          length + sum(c.tree for c in group),
                          sum(c.indirect for c in group))

        groups = _split(entries, lambda e: len(e[0]) + 12 + (
            e[2] if e[1] is not None else 0), NODE_BYTES)
        level = [leaf(g, len(groups) == 1) for g in groups]
        height = 0
        while len(level) > 1:
            height += 1
            groups = _split(level, lambda c: len(c.first) + 48, NODE_BYTES)
            level = [interior(height, g, len(groups) == 1) for g in groups]
    top = level[0]

    config = (uuid.uuid4().bytes + _var(0) + _var(MAX_INLINE) + _var(MAX_DECODED_NODE)
              + bytes([4]) + _var(0))
    version = b"".join([_table([nodes_name]), _var(1), _var(1), bytes([height]), _var(0),
                        _var(top.off), _var(top.length), _var(top.keys), _var(top.tree),
                        _var(top.indirect), struct.pack("<Q", time.time_ns()), _var(0)])
    tmp = root / "manifest.ocdbt.tmp"
    tmp.write_bytes(_file_bytes(MANIFEST_MAGIC, config + version))
    os.replace(tmp, root / "manifest.ocdbt")


def _group_keys(group) -> List[bytes]:
    return [g.first if isinstance(g, _Child) else g[0] for g in group]


def _split(items: List, size_of, limit: int) -> List[List]:
    """Consecutive groups of ``items`` of at most ``limit`` estimated bytes
    (and at least one item, two for interior levels to shrink)."""
    groups, cur, total = [], [], 0
    for it in items:
        s = size_of(it)
        if cur and total + s > limit and len(cur) >= 2:
            groups.append(cur)
            cur, total = [], 0
        cur.append(it)
        total += s
    groups.append(cur)
    return groups
