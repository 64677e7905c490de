"""A read-only OCDBT key-value store: the one Orbax writes a checkpoint
into (``train/orbax_reader.py``), read without tensorstore.

OCDBT (tensorstore's "optionally cooperative distributed B+tree") keeps a
versioned B+tree of keys in files under the store's directory:

* ``manifest.ocdbt``: the store's config and its latest versions, each
  version a reference to the root node of that version's tree;
* ``d/<hex>``: data files.  A node is a file or a byte range of one, and
  so is a value too large to be kept inline in its leaf.

Every manifest and node starts with a header: a magic number (big-endian
``0x0cdb3a2a`` for a manifest, ``0x0cdb20de`` for a node), the file's
length (u64 little-endian), a format version (varint, 0) and a
compression id (varint: 0 none, 1 zstd, decoded by ``zstd.py``); it ends
with the CRC-32C of the bytes before it (u32 little-endian).  The body:

* manifest: config (a 16-byte uuid, manifest kind, inline-value and node
  size limits, version tree arity, compression method and its level),
  a data file table, the inline versions as columns (generation, root
  height, root file, offset, length, key count, tree bytes, indirect
  bytes, commit time) and the count of version tree nodes, which hold
  only older versions and are not read;
* node: height (u8), a data file table, the entry count, then columns.
  A leaf: prefix-coded keys, each value's length and kind (0 inline, 1 a
  reference), the references' file ids and offsets, then the inline
  values.  An interior node: prefix-coded keys, each child's common key
  prefix (which the child's keys omit), the children's file ids, offsets
  and lengths, and three statistics per child.

A data file table is a count, then per file a prefix length into the
previous path (varint, from the second on), a suffix length and the
length of its base path, then the suffixes.  Paths are relative to the
store's directory; a child node's references are relative to the base
path its parent gave it.

A cooperative save by several processes writes one store per process in
``ocdbt.process_<p>/`` and a root manifest that Orbax merges them into;
``Store`` reads the root manifest and each process's, so the keys of
every process are found whether or not the merge ran.  A format version,
compression, manifest kind or node kind that is not known here is
refused by name.
"""

from __future__ import annotations

import glob
import os

from .. import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_NAME = 'manifest.ocdbt'
MISSING = (1 << 64) - 1          # the offset of an empty version's root
COMPRESSIONS = {0: 'none', 1: 'zstd'}


class _Cursor:
    """Reads varints and fixed-width fields from one decoded body."""

    def __init__(self, buf: bytes, where: str):
        self.buf, self.pos, self.where = buf, 0, where

    def fail(self, what: str):
        raise ValueError(f'{self.where}: {what} (body offset {self.pos})')

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.buf):
                self.fail('truncated varint')
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail('varint longer than 64 bits')

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            self.fail(f'truncated: {n} bytes wanted')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]


def _body(raw: bytes, magic: int, where: str) -> bytes:
    """The decoded body of a manifest or node file (header and CRC-32C
    checked)."""
    if len(raw) < 18:
        raise ValueError(f'{where}: {len(raw)} bytes is too short for an '
                         'OCDBT file')
    got = int.from_bytes(raw[:4], 'big')
    if got != magic:
        raise ValueError(f'{where}: magic {got:#010x}, expected '
                         f'{magic:#010x}')
    length = int.from_bytes(raw[4:12], 'little')
    if length != len(raw):
        raise ValueError(f'{where}: header says {length} bytes, the file '
                         f'has {len(raw)}')
    crc = int.from_bytes(raw[-4:], 'little')
    if zstd.crc32c(raw[:-4]) != crc:
        raise ValueError(f'{where}: CRC-32C mismatch')
    c = _Cursor(raw[:-4], where)
    c.pos = 12
    version = c.varint()
    if version != 0:
        raise ValueError(f'{where}: OCDBT format version {version} is not '
                         'supported (only 0)')
    compression = c.varint()
    body = raw[c.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise ValueError(f'{where}: OCDBT compression {compression} is not '
                         f'supported (only {COMPRESSIONS})')
    return body


def _file_table(c: _Cursor) -> list[tuple[str, str]]:
    """``[(path, base_path), ...]`` of a data file table."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    out, prev = [], b''
    for k in range(n):
        if prefix[k] > len(prev):
            c.fail('data file path prefix longer than the previous path')
        path = prev[:prefix[k]] + c.take(suffix[k])
        if base[k] > len(path):
            c.fail('data file base path longer than its path')
        out.append((path.decode(), path[:base[k]].decode()))
        prev = path
    return out


def _keys(c: _Cursor, n: int) -> tuple[list[int], list[int]]:
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    return prefix, suffix


def _key_bytes(c: _Cursor, prefix, suffix) -> list[bytes]:
    out, prev = [], b''
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            c.fail('key prefix longer than the previous key')
        prev = prev[:p] + c.take(s)
        out.append(prev)
    return out


class Store:
    """The keys of an OCDBT store (a checkpoint directory), read at
    construction; values are read on demand.  ``read(key)`` is a value's
    bytes, ``items(prefix)`` ``{key: bytes}`` of the keys under a
    prefix."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        # key -> bytes (inline) or (file, offset, length)
        self._index: dict[str, object] = {}
        manifests = [os.path.join(self.root, MANIFEST_NAME)]
        manifests += sorted(glob.glob(os.path.join(
            self.root, 'ocdbt.process_*', MANIFEST_NAME)))
        found = [m for m in manifests if os.path.exists(m)]
        if not found:
            raise ValueError(f'{root}: no {MANIFEST_NAME} (an OCDBT store '
                             'has one at its root or in ocdbt.process_<p>/)')
        self.manifests = found
        for m in found:
            self._read_manifest(m)

    # --- the tree -------------------------------------------------------------

    def _file(self, db: str, rel: str) -> str:
        """The path of data file ``rel`` of the store in directory
        ``db``; one outside the checkpoint directory is refused."""
        path = os.path.normpath(os.path.join(db, rel))
        if not path.startswith(self.root + os.sep):
            raise ValueError(f'{db}: data file {rel!r} lies outside the '
                             f'store {self.root}')
        return path

    def _read_range(self, path: str, offset: int, length: int) -> bytes:
        with open(path, 'rb') as f:
            f.seek(offset)
            out = f.read(length)
        if len(out) != length:
            raise ValueError(f'{path}: {length} bytes at offset {offset} '
                             f'wanted, the file holds {len(out)}')
        return out

    def _read_manifest(self, path: str):
        db = os.path.dirname(path)
        with open(path, 'rb') as f:
            c = _Cursor(_body(f.read(), MANIFEST_MAGIC, path), path)
        c.take(16)                                  # uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(f'{path}: manifest kind {kind} (numbered) is '
                             'not supported (only 0, single)')
        c.varint()                                  # max_inline_value_bytes
        c.varint()                                  # max_decoded_node_bytes
        c.u8()                                      # version_tree_arity_log2
        method = c.varint()
        if method == 1:
            c.take(4)                               # zstd level, int32
        elif method != 0:
            raise ValueError(f'{path}: OCDBT compression method {method} is '
                             f'not supported (only {COMPRESSIONS})')
        files = _file_table(c)
        n = c.varint()
        gens = c.varints(n)
        heights = c.varints(n)
        ids = c.varints(n)
        offsets = c.varints(n)
        lengths = c.varints(n)
        if not n:
            return
        latest = max(range(n), key=gens.__getitem__)
        if offsets[latest] == MISSING:              # an empty tree
            return
        if ids[latest] >= len(files):
            c.fail(f'root refers to data file {ids[latest]} of '
                   f'{len(files)}')
        rel, base = files[ids[latest]]
        self._walk(db, self._file(db, rel), offsets[latest], lengths[latest],
                   heights[latest], base, b'')

    def _walk(self, db: str, path: str, offset: int, length: int,
              height: int, base: str, prefix: bytes):
        """Index the subtree of the node at ``path[offset:offset +
        length]`` of the store in directory ``db``, whose references are
        relative to ``base`` and whose keys follow ``prefix``."""
        where = f'{path}@{offset}'
        c = _Cursor(_body(self._read_range(path, offset, length),
                          NODE_MAGIC, where), where)
        got = c.u8()
        if got != height:
            c.fail(f'node of height {got} where {height} was expected')
        files = [(os.path.join(base, rel), os.path.join(base, b))
                 for rel, b in _file_table(c)]
        n = c.varint()
        kp, ks = _keys(c, n)
        if height == 0:
            keys = _key_bytes(c, kp, ks)
            sizes = c.varints(n)
            kinds = c.varints(n)
            bad = set(kinds) - {0, 1}
            if bad:
                c.fail(f'value kind {sorted(bad)} is not known (0 inline, '
                       '1 a reference)')
            m = kinds.count(1)
            ids, offs = c.varints(m), c.varints(m)
            refs = iter(zip(ids, offs))
            for key, size, kind in zip(keys, sizes, kinds):
                name = (prefix + key).decode()
                if kind == 1:
                    fid, off = next(refs)
                    if fid >= len(files):
                        c.fail(f'value refers to data file {fid} of '
                               f'{len(files)}')
                    value = (self._file(db, files[fid][0]), off, size)
                else:
                    value = c.take(size)
                self._index.setdefault(name, value)
            if c.pos != len(c.buf):
                c.fail('bytes after the leaf entries')
            return
        common = c.varints(n)
        keys = _key_bytes(c, kp, ks)
        ids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)                  # keys, tree bytes, indirect bytes
        if c.pos != len(c.buf):
            c.fail('bytes after the interior entries')
        for key, cp, fid, off, ln in zip(keys, common, ids, offs, lens):
            if fid >= len(files) or cp > len(key):
                c.fail('corrupt interior entry')
            rel, child_base = files[fid]
            self._walk(db, self._file(db, rel), off, ln, height - 1,
                       child_base, prefix + key[:cp])

    # --- values -----------------------------------------------------------------

    def keys(self, prefix: str = '') -> list[str]:
        return sorted(k for k in self._index if k.startswith(prefix))

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def read(self, key: str) -> bytes:
        v = self._index[key]
        if isinstance(v, bytes):
            return v
        return self._read_range(*v)

    def items(self, prefix: str = '') -> dict[str, bytes]:
        return {k: self.read(k) for k in self.keys(prefix)}
