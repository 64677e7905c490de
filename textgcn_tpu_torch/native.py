"""The port's native interaction reader (``csrc/graphbuild.cpp``), built
with the host C++ compiler at first use and loaded with ``ctypes``.

``read_pairs(path)`` parses a ``train.tsv``/``test.tsv`` as the plain
reader of ``data/core.py`` does (``csv.reader`` semantics, columns
``user_id`` and ``asin`` by name), sorts the pairs and numbers users and
items in order of first appearance, in C++.  ``data/core.load_interactions``
uses it unless ``TEXTGCN_TPU_NATIVE=0``.

Build: ``$CXX`` (default ``c++``) with ``-O3 -std=c++17 -shared -fPIC``
into ``build/native/`` beside the package (listed in ``.gitignore``), the
library named by its source and a digest of the source, the compiler and
the flags; ``build(source)`` builds the package's other host library,
``csrc/zstd_decode.cpp`` (``zstd.py``), the same way.  The
compiler writes a temporary file that is moved into place with
``os.replace`` under an ``flock`` on ``build/native/.lock``, so processes
that start together build once and load the same library.  A failed build
raises with the compiler's output; nothing falls back to Python.

Imports the standard library and numpy only.
"""

from __future__ import annotations

import csv
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(PACKAGE_DIR, 'csrc', 'graphbuild.cpp')
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build', 'native')
CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')
ENV = 'TEXTGCN_TPU_NATIVE'

# tsv_status codes
OK, NOT_UTF8, FIELD_COUNT, MISSING_COLUMN, EMPTY, FIELD_LIMIT = range(6)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def enabled() -> bool:
    """False when ``TEXTGCN_TPU_NATIVE=0`` selects the plain reader."""
    return os.environ.get(ENV, '') != '0'


def compiler() -> str:
    return os.environ.get('CXX') or 'c++'


def library_path(source: str = SOURCE) -> str:
    with open(source, 'rb') as f:
        digest = hashlib.sha256(f.read())
    digest.update(' '.join((compiler(), *CXX_FLAGS)).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f'{stem}-{digest.hexdigest()[:16]}.so')


def build(source: str = SOURCE) -> str:
    """The path of ``source``'s library (``graphbuild.cpp``'s unless
    another host source of ``csrc/`` is named), compiled first if it is
    not there (once across processes: under an ``flock``).  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    target = library_path(source)
    what = os.path.basename(source)
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, '.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(target):
            return target
        tmp = f'{target}.{os.getpid()}.tmp'
        cmd = [compiler(), *CXX_FLAGS, '-o', tmp, source]
        try:
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except OSError as e:
            raise RuntimeError(f'{what} cannot be built: '
                               f'{" ".join(cmd)}: {e}') from e
        if run.returncode or not os.path.exists(tmp):
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f'{what} cannot be built: {" ".join(cmd)} '
                f'exited with {run.returncode}:\n{run.stdout}{run.stderr}')
        os.replace(tmp, target)
    return target


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            h = ctypes.c_void_p
            lib.tsv_read_pairs.restype = h
            lib.tsv_read_pairs.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                           ctypes.c_char_p, ctypes.c_char_p,
                                           ctypes.c_int64]
            lib.tsv_status.restype = ctypes.c_int32
            lib.tsv_status.argtypes = [h]
            lib.tsv_error.argtypes = [h, i64p]
            lib.tsv_error.restype = None
            lib.tsv_n_rows.restype = ctypes.c_int64
            lib.tsv_n_rows.argtypes = [h]
            lib.tsv_copy_codes.argtypes = [h, i32p, i32p]
            lib.tsv_copy_codes.restype = None
            lib.tsv_n_strings.restype = ctypes.c_int64
            lib.tsv_n_strings.argtypes = [h, ctypes.c_int32]
            lib.tsv_strings_bytes.restype = ctypes.c_int64
            lib.tsv_strings_bytes.argtypes = [h, ctypes.c_int32]
            lib.tsv_copy_strings.argtypes = [h, ctypes.c_int32,
                                             ctypes.c_char_p, i64p]
            lib.tsv_copy_strings.restype = None
            lib.tsv_free.argtypes = [h]
            lib.tsv_free.restype = None
            _lib = lib
        return _lib


def _strings(lib, h, which: int) -> list[str]:
    n = lib.tsv_n_strings(h, which)
    size = int(lib.tsv_strings_bytes(h, which))
    blob = ctypes.create_string_buffer(max(size, 1))
    offsets = np.empty(n + 1, np.int64)
    lib.tsv_copy_strings(h, which, blob, offsets.ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64)))
    raw = blob.raw[:size]
    at = offsets.tolist()
    return [raw[at[k]:at[k + 1] - 1].decode('utf-8') for k in range(n)]


def read_pairs(path: str, user_col: str = 'user_id',
               item_col: str = 'asin'):
    """``(user_codes, item_codes, user_ids, item_ids)`` of a TSV: int32
    codes per row in (user, item) string order and the external ids in
    order of first appearance.  Raises ``ValueError`` naming the path and
    the line, with the plain reader's message, for a file it refuses."""
    lib = load()
    with open(path, 'rb') as f:
        buf = f.read()
    h = lib.tsv_read_pairs(buf, len(buf), user_col.encode(),
                           item_col.encode(), csv.field_size_limit())
    try:
        status = lib.tsv_status(h)
        if status != OK:
            err = np.zeros(3, np.int64)
            lib.tsv_error(h, err.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)))
            line, expected, got = map(int, err)
            header = _strings(lib, h, 2)
            raise ValueError(error_message(path, status, line, expected,
                                           got, header, user_col, item_col))
        n = lib.tsv_n_rows(h)
        user = np.empty(n, np.int32)
        item = np.empty(n, np.int32)
        lib.tsv_copy_codes(h, user.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)), item.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)))
        return user, item, _strings(lib, h, 0), _strings(lib, h, 1)
    finally:
        lib.tsv_free(h)


def error_message(path: str, status: int, line: int, expected: int,
                  got: int, header: list[str], user_col: str = 'user_id',
                  item_col: str = 'asin') -> str:
    """The message of a refused file, worded once for both readers."""
    if status == NOT_UTF8:
        return f'{path}:{line}: the bytes are not UTF-8'
    if status == FIELD_COUNT:
        return f'{path}:{line}: expected {expected} fields, got {got}'
    if status == MISSING_COLUMN:
        return (f'{path}:{line}: the header needs {user_col} and '
                f'{item_col} columns, got {header}')
    if status == EMPTY:
        return f'{path}:{line}: no header'
    if status == FIELD_LIMIT:
        return (f'{path}:{line}: field larger than field limit '
                f'({csv.field_size_limit()})')
    raise ValueError(f'unknown status {status}')
