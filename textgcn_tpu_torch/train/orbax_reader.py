"""An Orbax PyTree checkpoint, read as the JAX package's ``restore``
returns it, without orbax or tensorstore.

The JAX package's ``--ckpt_backend orbax`` saves a run through
``ocp.PyTreeCheckpointer`` (``textgcn_tpu/train/checkpoint.py:77-162``):
``latest_checkpoint.orbax/``, ``best.orbax/`` and ``resume_state.orbax/``.
Such a directory holds

* ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's key path to
  its keys (``key_type`` 2 a dict key, 1 a sequence index, which rebuilds
  the lists) and its ``value_type``: ``jax.Array`` or ``np.ndarray`` (an
  array), ``scalar`` (a 0-d array restored as a Python value),
  ``string`` (kept in ``_strings.json`` under the dotted key path), or
  ``Dict``, ``List`` and ``None`` for an empty node;
* the arrays, as zarr v2 arrays named by the dotted key path: in an
  OCDBT store (``data/ocdbt.py``; ``use_ocdbt``, the default) or, with
  ``use_ocdbt=False``, one directory per array on the file system.  An
  array is ``<name>/.zarray`` (JSON: ``shape``, ``chunks``, ``dtype``,
  ``compressor``, ``filters``, ``fill_value``, ``order``,
  ``dimension_separator``) and its chunks ``<name>/0.0``, ``1.0``, ...
  (``0`` for a scalar), each a whole chunk in C order (edge chunks
  padded), zstd compressed (``zstd.py``) or raw.  A table sharded over 4 devices is 4
  chunks, one per shard, each process writing its own; a missing chunk
  is the ``fill_value``.

The dtypes read are ``<f4 <f8 <f2 <i4 <i8 <u4 |b1`` as themselves and
bfloat16 widened to float32 (exactly: numpy has no bfloat16 without
ml_dtypes); the compressors ``zstd`` and none.  Filters, another
compressor or dtype, and a zarr v3 array (``zarr.json``, ``use_zarr3``)
are refused by name.

``restore(path)`` is the tree, arrays as numpy; ``is_orbax_dir(path)``
tells such a directory from a ``torch.distributed.checkpoint`` one.
"""

from __future__ import annotations

import itertools
import json
import math
import os

import numpy as np

from .. import zstd
from ..data.ocdbt import MANIFEST_NAME, Store

METADATA = '_METADATA'
STRINGS = '_strings.json'
DICT_KEY, SEQUENCE_KEY = 2, 1
DTYPES = ('<f4', '<f8', '<f2', '<i4', '<i8', '<u4', '|b1')
BFLOAT16 = 'bfloat16'
EMPTY = {'Dict': dict, 'List': list, 'None': lambda: None}
ARRAYS = ('jax.Array', 'np.ndarray')


def is_orbax_dir(path: str) -> bool:
    """True for a directory that Orbax wrote (it has ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, METADATA))


class _Files:
    """The keys of ``use_ocdbt=False``: files under the directory."""

    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> bytes | None:
        path = os.path.join(self.root, *key.split('/'))
        if not os.path.isfile(path):
            return None
        with open(path, 'rb') as f:
            return f.read()


class _Ocdbt:
    def __init__(self, root: str):
        self.store = Store(root)

    def get(self, key: str) -> bytes | None:
        return self.store.read(key) if key in self.store else None


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):
        specials = {'NaN': np.nan, 'Infinity': np.inf, '-Infinity': -np.inf}
        if value not in specials:
            raise ValueError(f'fill_value {value!r} is not understood')
        return specials[value]
    return value


def read_array(source, name: str, where: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``source`` (a key -> bytes reader)."""
    if source.get(f'{name}/zarr.json') is not None:
        raise ValueError(f'{where}: {name} is a zarr v3 array (zarr.json): '
                         'only zarr v2 (.zarray) is read')
    raw = source.get(f'{name}/.zarray')
    if raw is None:
        raise ValueError(f'{where}: no {name}/.zarray')
    meta = json.loads(raw)
    if meta.get('zarr_format') != 2:
        raise ValueError(f'{where}: {name} has zarr_format '
                         f'{meta.get("zarr_format")!r}, only 2 is read')
    if meta.get('filters'):
        raise ValueError(f'{where}: {name} has filters {meta["filters"]}: '
                         'none are supported')
    comp = meta.get('compressor')
    if comp is not None and comp.get('id') != 'zstd':
        raise ValueError(f'{where}: {name} is compressed with '
                         f'{comp.get("id")!r}: only zstd and none are read')
    code = meta['dtype']
    if code == BFLOAT16:
        dtype = np.dtype('<u2')
    elif code in DTYPES:
        dtype = np.dtype(code)
    else:
        raise ValueError(f'{where}: {name} has dtype {code!r}: only '
                         f'{", ".join(DTYPES)} and {BFLOAT16} are read')
    if meta.get('order', 'C') != 'C':
        raise ValueError(f'{where}: {name} has order {meta["order"]!r}: '
                         'only C order is read')
    shape, chunks = tuple(meta['shape']), tuple(meta['chunks'])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f'{where}: {name} has shape {shape} and chunks '
                         f'{chunks}')
    sep = meta.get('dimension_separator', '.')
    fill = _fill(meta.get('fill_value'))
    if code == BFLOAT16:
        fill = int(np.float32(fill).view('<u4')) >> 16
    out = np.full(shape, fill, dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f'{name}/{sep.join(map(str, idx)) if idx else "0"}'
        data = source.get(key)
        if data is None:
            continue
        if comp is not None:
            data = zstd.decompress(data, limit=chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f'{where}: chunk {key} holds {len(data)} bytes, '
                             f'a chunk of {chunks} {code} has {chunk_bytes}')
        block = np.frombuffer(data, dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if code == BFLOAT16:
        return (out.astype('<u4') << 16).view('<f4')
    return out


def _insert(tree, keys, value, where: str):
    node = tree
    for k, (key, kind) in enumerate(keys):
        if kind == SEQUENCE_KEY:
            key = int(key)
        elif kind != DICT_KEY:
            raise ValueError(f'{where}: key type {kind} of {key!r} is not '
                             'known (2 a dict key, 1 a sequence index)')
        if k + 1 == len(keys):
            node[key] = value
        else:
            node = node.setdefault(key, ({}, keys[k + 1][1]))[0]


def _lists(node):
    """The insertion tree (sequence levels as ``{index: ...}``) as dicts
    and lists."""
    if not isinstance(node, dict):
        return node
    out = {}
    for key, value in node.items():
        if isinstance(value, tuple):
            child, kind = value
            child = _lists(child)
            if kind == SEQUENCE_KEY:
                if sorted(child) != list(range(len(child))):
                    raise ValueError(f'sequence indices {sorted(child)} are '
                                     'not 0..n-1')
                child = [child[i] for i in range(len(child))]
            value = child
        out[key] = value
    return out


def restore(path: str):
    """The tree that ``ocp.PyTreeCheckpointer().restore(path)`` gives,
    its arrays as numpy arrays and its scalars as Python values."""
    where = os.path.abspath(path)
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if 'tree_metadata' not in meta:
        raise ValueError(f'{where}: {METADATA} has no tree_metadata')
    if meta.get('use_zarr3'):
        raise ValueError(f'{where}: the checkpoint was saved with zarr v3 '
                         '(use_zarr3): only zarr v2 is read')
    strings = {}
    if os.path.exists(os.path.join(path, STRINGS)):
        with open(os.path.join(path, STRINGS)) as f:
            strings = json.load(f)
    ocdbt = os.path.exists(os.path.join(path, MANIFEST_NAME)) or any(
        n.startswith('ocdbt.process_') for n in os.listdir(path))
    source = _Ocdbt(path) if ocdbt else _Files(path)
    root: dict = {}
    top_kind = None
    for entry in meta['tree_metadata'].values():
        keys = [(k['key'], k['key_type']) for k in entry['key_metadata']]
        vm = entry['value_metadata']
        kind = vm['value_type']
        name = '.'.join(str(k) for k, _ in keys)
        if kind in EMPTY:
            value = EMPTY[kind]()
        elif kind == 'string':
            if name not in strings:
                raise ValueError(f'{where}: string {name} is not in '
                                 f'{STRINGS}')
            value = strings[name]
        elif kind == 'scalar':
            value = read_array(source, name, where).item()
        elif kind in ARRAYS:
            value = read_array(source, name, where)
        else:
            raise ValueError(f'{where}: {name} has value type {kind!r}: '
                             'only arrays, scalars, strings and empty '
                             'nodes are read')
        top_kind = keys[0][1]
        _insert(root, keys, value, where)
    return _lists({'': (root, top_kind or DICT_KEY)})['']
