"""The port's Zstandard decoder and CRC-32C (``csrc/zstd_decode.cpp``),
built with the host C++ compiler at first use (``native.build``) and
loaded with ``ctypes``.

The JAX package saves ``--ckpt_backend orbax`` runs through Orbax, whose
OCDBT store compresses its B-tree nodes with zstd and whose zarr arrays
compress each chunk with zstd (``data/ocdbt.py``,
``train/orbax_reader.py``).  The GPU machine has no ``zstandard``,
``tensorstore`` or ``compression.zstd``, and a decoder in Python would
take minutes for a table of S1's size, so the port decodes RFC 8878 in
C++: every frame kind, block kind, literals and sequences mode and the
XXH64 content checksum (verified).  A frame that names a dictionary is
refused, and corrupt input raises ``ValueError`` with the input offset.

Imports the standard library and numpy only.
"""

from __future__ import annotations

import ctypes
import os
import threading

from . import native

SOURCE = os.path.join(native.PACKAGE_DIR, 'csrc', 'zstd_decode.cpp')

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native.build(SOURCE))
            h = ctypes.c_void_p
            lib.zstd_decode.restype = h
            lib.zstd_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_int64]
            lib.zstd_failed.restype = ctypes.c_int32
            lib.zstd_failed.argtypes = [h, ctypes.POINTER(ctypes.c_int64)]
            lib.zstd_message.restype = ctypes.c_char_p
            lib.zstd_message.argtypes = [h]
            lib.zstd_size.restype = ctypes.c_int64
            lib.zstd_size.argtypes = [h]
            lib.zstd_copy.restype = None
            lib.zstd_copy.argtypes = [h, ctypes.c_char_p]
            lib.zstd_free.restype = None
            lib.zstd_free.argtypes = [h]
            lib.crc32c_of.restype = ctypes.c_uint32
            lib.crc32c_of.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            _lib = lib
        return _lib


def decompress(data: bytes, limit: int = -1) -> bytes:
    """The content of the zstd (and skippable) frames in ``data``, at most
    ``limit`` bytes when it is not negative.  Raises ``ValueError`` naming
    the input offset of the first fault."""
    lib = load()
    data = bytes(data)
    h = lib.zstd_decode(data, len(data), limit)
    if not h:
        raise MemoryError('zstd: out of memory')
    try:
        at = ctypes.c_int64(0)
        if lib.zstd_failed(h, ctypes.byref(at)):
            raise ValueError(f'zstd: {lib.zstd_message(h).decode()} (input '
                             f'offset {at.value})')
        out = ctypes.create_string_buffer(max(lib.zstd_size(h), 1))
        lib.zstd_copy(h, out)
        return out.raw[:lib.zstd_size(h)]
    finally:
        lib.zstd_free(h)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, as OCDBT closes its files."""
    data = bytes(data)
    return int(load().crc32c_of(data, len(data)))
