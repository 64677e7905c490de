"""msgpack in plain Python, and Flax's arrays in it: what
``flax.serialization.msgpack_restore`` reads from a ``flax_model.msgpack``
(``FlaxPreTrainedModel.save_pretrained``), with neither ``flax`` nor
``msgpack``.

* ``unpackb(data)`` decodes every msgpack type code as
  ``msgpack.unpackb(data)`` does by default: integers of every width,
  ``nil``, booleans, float32 and float64, ``str`` (UTF-8), ``bin``
  (``bytes``), arrays (lists) and maps (``dict``; ``str`` or ``bytes``
  keys), and an ext as ``ExtType(code, data)``.  A type code that msgpack
  does not define, a truncated object, a key of another type or bytes
  after the object raise ``ValueError`` with the byte offset.
* ``restore(data)`` is ``msgpack_restore``: Flax's ext types (1, an
  ndarray packed as ``(shape, dtype name, C-order bytes)``; 2, a native
  complex; 3, a numpy scalar) decoded, and the chunked form of an array
  over Flax's ``MAX_CHUNK_SIZE`` (2**30 bytes; ``_chunk``: a dict with
  ``'__msgpack_chunked_array__'``, ``shape`` and ``chunks``) joined again.
  An array is ``np.frombuffer`` over the input's bytes (read-only, no
  copy); bfloat16 comes back widened to float32 (exact), every other
  dtype as itself.  Another ext code or dtype raises, naming it and the
  offset.
* ``read_flax_file(path)`` reads a file with ``restore``; ``flatten`` and
  ``unflatten`` map a tree to and from the ``/``-joined names of a sharded
  checkpoint's index.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

CHUNKED = '__msgpack_chunked_array__'
EXT_NDARRAY, EXT_COMPLEX, EXT_SCALAR = 1, 2, 3
# the dtypes an array may have (numpy's names, as Flax writes them)
DTYPES = frozenset(('bool', 'int8', 'int16', 'int32', 'int64', 'uint8',
                    'uint16', 'uint32', 'uint64', 'float16', 'float32',
                    'float64', 'bfloat16'))


class ExtType(NamedTuple):
    """An ext that is not decoded (equal to ``msgpack.ExtType``)."""
    code: int
    data: bytes


# the fixed-width scalars: type code -> struct format
_SCALARS = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
            0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
# str, bin, array, map and ext with a length field: code -> (kind, width)
_SIZED = {0xd9: ('str', 1), 0xda: ('str', 2), 0xdb: ('str', 4),
          0xc4: ('bin', 1), 0xc5: ('bin', 2), 0xc6: ('bin', 4),
          0xdc: ('array', 2), 0xdd: ('array', 4),
          0xde: ('map', 2), 0xdf: ('map', 4),
          0xc7: ('ext', 1), 0xc8: ('ext', 2), 0xc9: ('ext', 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Decoder:
    """One pass over ``buf`` (a ``memoryview``); ``ext(code, start, end)``
    decodes an ext's payload ``buf[start:end]``."""

    def __init__(self, buf: memoryview, ext):
        self.buf, self.ext = buf, ext

    def take(self, pos: int, n: int, what: str) -> int:
        if pos + n > len(self.buf):
            raise ValueError(f'msgpack: {what} at byte {pos} needs {n} '
                             f'bytes, {len(self.buf) - pos} left')
        return pos + n

    def decode(self, pos: int, bins: bool = True):
        """``(object, end)`` of the object at ``pos``; ``bin`` payloads as
        ``bytes``, or as ``memoryview`` slices of the input when ``bins``
        is false."""
        buf = self.buf
        at = pos
        pos = self.take(pos, 1, 'a type code')
        code = buf[at]
        if code <= 0x7f:
            return code, pos
        if code >= 0xe0:
            return code - 0x100, pos
        if 0x80 <= code <= 0x8f:
            return self.map(code & 0x0f, pos, at, bins)
        if 0x90 <= code <= 0x9f:
            return self.array(code & 0x0f, pos, bins)
        if 0xa0 <= code <= 0xbf:
            return self.str(code & 0x1f, pos)
        if code == 0xc0:
            return None, pos
        if code in (0xc2, 0xc3):
            return code == 0xc3, pos
        if code in _SCALARS:
            fmt = _SCALARS[code]
            end = self.take(pos, struct.calcsize(fmt), f'type 0x{code:02x}')
            return struct.unpack_from(fmt, buf, pos)[0], end
        if code in _FIXEXT:
            return self.ext_at(buf[pos] if pos < len(buf) else None,
                               pos + 1, _FIXEXT[code], at)
        if code in _SIZED:
            kind, width = _SIZED[code]
            start = self.take(pos, width, f'the length of type 0x{code:02x}')
            n = int.from_bytes(buf[pos:start], 'big')
            if kind == 'str':
                return self.str(n, start)
            if kind == 'bin':
                end = self.take(start, n, 'a bin')
                return (bytes(buf[start:end]) if bins
                        else buf[start:end]), end
            if kind == 'array':
                return self.array(n, start, bins)
            if kind == 'map':
                return self.map(n, start, at, bins)
            return self.ext_at(buf[start] if start < len(buf) else None,
                               start + 1, n, at)
        raise ValueError(f'msgpack: type code 0x{code:02x} at byte {at} is '
                         'not defined')

    def str(self, n: int, pos: int):
        end = self.take(pos, n, 'a str')
        return str(self.buf[pos:end], 'utf-8'), end

    def array(self, n: int, pos: int, bins: bool):
        out = []
        for _ in range(n):
            item, pos = self.decode(pos, bins)
            out.append(item)
        return out, pos

    def map(self, n: int, pos: int, at: int, bins: bool):
        out = {}
        for _ in range(n):
            key_at = pos
            key, pos = self.decode(pos, bins)
            if not isinstance(key, (str, bytes)):
                raise ValueError(f'msgpack: the map at byte {at} has a key '
                                 f'of type {type(key).__name__} at byte '
                                 f'{key_at} (str or bytes only)')
            out[key], pos = self.decode(pos, bins)
        return out, pos

    def ext_at(self, code, start: int, n: int, at: int):
        if code is None:
            raise ValueError(f'msgpack: the ext at byte {at} has no type')
        end = self.take(start, n, 'an ext')
        code = code - 0x100 if code >= 0x80 else code
        return self.ext(code, start, end, at), end


def _whole(decoder: _Decoder, pos: int = 0):
    obj, end = decoder.decode(pos)
    if end != len(decoder.buf):
        raise ValueError(f'msgpack: {len(decoder.buf) - end} bytes after '
                         f'the object, from byte {end}')
    return obj


def unpackb(data) -> object:
    """``msgpack.unpackb(data)`` with its defaults (``raw=False``, lists,
    ``str``/``bytes`` map keys); an ext is an ``ExtType``."""
    buf = memoryview(data).cast('B')

    def ext(code, start, end, at):
        return ExtType(code, bytes(buf[start:end]))
    return _whole(_Decoder(buf, ext))


def _array(decoder: _Decoder, start: int, end: int, at: int) -> np.ndarray:
    """Flax's packed ndarray at ``buf[start:end]``: its bytes viewed in
    place."""
    sub = _Decoder(decoder.buf[:end], decoder.ext)
    fields, stop = sub.decode(start, bins=False)
    if stop != end or not isinstance(fields, list) or len(fields) != 3:
        raise ValueError(f'msgpack: the ndarray ext at byte {at} is not '
                         '(shape, dtype, bytes)')
    shape, name, raw = fields
    if isinstance(name, (bytes, memoryview)):
        name = bytes(name).decode()
    if name not in DTYPES:
        raise ValueError(f'msgpack: the ndarray at byte {at} has dtype '
                         f'{name!r}: the port reads '
                         f'{", ".join(sorted(DTYPES))}')
    if name == 'bfloat16':
        bits = np.frombuffer(raw, np.uint16)
        arr = (bits.astype(np.uint32) << 16).view(np.float32)
    else:
        arr = np.frombuffer(raw, np.dtype(name))
    return arr.reshape(shape)


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d['shape'][str(i)] for i in range(len(d['shape'])))
    chunks = [d['chunks'][str(i)] for i in range(len(d['chunks']))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """``flax.serialization._unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_leaves(v)
    return d


def restore(data):
    """``flax.serialization.msgpack_restore(data)`` (see the module)."""
    buf = memoryview(data).cast('B')

    def ext(code, start, end, at):
        if code == EXT_NDARRAY:
            return _array(decoder, start, end, at)
        if code == EXT_SCALAR:
            return _array(decoder, start, end, at)[()]
        if code == EXT_COMPLEX:
            real, imag = _whole(_Decoder(buf[start:end], ext))
            return complex(real, imag)
        raise ValueError(f'msgpack: ext type {code} at byte {at} is not one '
                         'of Flax\'s (1 ndarray, 2 complex, 3 numpy scalar)')

    decoder = _Decoder(buf, ext)
    return _unchunk_leaves(_whole(decoder))


def flatten(tree: dict, path: tuple = ()) -> dict:
    """``flax.traverse_util.flatten_dict(tree, sep='/')``: the leaves
    under their ``/``-joined paths."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, (*path, key)))
        else:
            out['/'.join((*path, key))] = value
    return out


def unflatten(flat: dict) -> dict:
    """``flax.traverse_util.unflatten_dict(flat, sep='/')``."""
    tree: dict = {}
    for name, value in flat.items():
        *parents, leaf = name.split('/')
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def read_flax_file(path: str):
    """The tree of a Flax msgpack file (``restore``); the arrays view the
    file's bytes."""
    with open(path, 'rb') as f:
        data = f.read()
    try:
        return restore(data)
    except ValueError as e:
        raise ValueError(f'{path}: {e}') from None
