"""Checkpoints: the JAX package's pickle files, read and written.

Counterpart of the pickle half of ``textgcn_tpu/train/checkpoint.py``.
A checkpoint is ``{'params': {name: numpy array}, 'epoch', 'model'}``,
the conv models' params with their ``convs`` list of per-layer dicts
(``weights.py``); given a run directory, ``best.pkl`` is read.  The unpickler admits numpy
arrays and plain Python values only, so a crafted file cannot run code.
``save_latest`` writes ``latest_checkpoint.pkl`` atomically and
``promote_best`` copies it to ``best.pkl``.  ``save_resume`` writes the
trainer's ``resume_state.pkl`` beside it, the file ``--resume`` reads
(``load_resume``; its payload is ``Trainer.resume_payload``'s).  On a
mesh rank 0 alone writes them (``cooperative = False``).

``--ckpt_backend orbax`` is ``DistCheckpointer``, the JAX package's
Orbax backend (``textgcn_tpu/train/checkpoint.py:77-167``) on
``torch.distributed.checkpoint`` (DCP): the same directory names
(``latest_checkpoint.orbax/``, ``best.orbax/``, ``resume_state.orbax/``)
and the same contract, ``cooperative = True``: every rank takes part in a
save and writes its own rows of the tables and of their Adam moments
(``weights.RowShard``, saved as a ``Shard(0)`` DTensor over a 1-D device
mesh of the ranks); what every rank holds whole is written once.  A save
goes to ``<name>.tmp`` and is renamed into place by rank 0 between
barriers; ``promote_best`` is rank 0's copy between barriers.  Without a
process group (one card, no ``--mesh``) it saves in one process.  A load
returns what the pickle backend's returns, the whole real tables as
numpy arrays: each process reads every rank's rows, drops the phantom
rows recorded with them (the padding depends on the number of ranks), and
the trainer keeps the rows it owns, so a checkpoint of W ranks loads at
any W and in one process.  ``load`` of a run directory prefers
``best.orbax`` and falls back to ``best.pkl``.  A load goes by what the
directory holds: DCP's ``.metadata`` is read as above; Orbax's
``_METADATA`` (a checkpoint that the JAX package's own Orbax backend
wrote, on a TPU or a mesh of processes) is read by ``orbax_reader``
without orbax, and ``load`` returns what the JAX package's
``OrbaxCheckpointer.load`` does: the ``meta`` keys and ``params``.  Any
other directory is refused with both formats named.

The boosted heads write their fitted ensemble beside it as
``forest.npz`` (``save_forest``, ``load_forest``): every tree's node
arrays concatenated, with ``offsets`` into them, the initial prediction,
the learning rate and the feature count; numeric arrays only, read with
``allow_pickle=False``.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import shutil
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..ops.trees import GBRTState, Tree
from ..parallel.multihost import barrier, is_primary
from ..weights import RowShard
from . import orbax_reader

# the classes a numpy-array pickle needs (numpy 1.x and 2.x module names)
_ALLOWED = {
    (mod, name)
    for mod in ('numpy', 'numpy.core.multiarray', 'numpy._core.multiarray',
                'numpy.core.numeric', 'numpy._core.numeric')
    for name in ('ndarray', 'dtype', '_reconstruct', 'scalar',
                 '_frombuffer')
}


class _ArrayUnpickler(pickle.Unpickler):

    def find_class(self, module, name):
        if (module, name) in _ALLOWED or (
                module == 'numpy' and name.endswith('DType')) or (
                module == 'numpy.dtypes'):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f'checkpoint refers to {module}.{name}: only numpy arrays and '
            'plain values are loaded')


def _atomic_dump(obj, path: str):
    """Write ``obj`` to a temporary file and rename it, so a crash
    mid-write keeps the previous file."""
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _load(path: str) -> dict:
    with open(path, 'rb') as f:
        return _ArrayUnpickler(f).load()


def run_dir(path: str) -> str:
    """The run directory of a ``--load`` path: the path itself, or the
    directory that holds a checkpoint file or ``.orbax`` directory."""
    path = os.path.normpath(path)
    if os.path.isdir(path) and not path.endswith('.orbax'):
        return path
    return os.path.dirname(path)


class PickleCheckpointer:
    latest_name = 'latest_checkpoint.pkl'
    best_name = 'best.pkl'
    resume_name = 'resume_state.pkl'
    cooperative = False

    def save_latest(self, save_path: str, state: dict):
        """Write ``state`` (its params already numpy)."""
        os.makedirs(save_path, exist_ok=True)
        _atomic_dump(state, os.path.join(save_path, self.latest_name))

    def save_resume(self, save_path: str, payload: dict):
        """Write the trainer's resume payload (numpy arrays and plain
        values) as ``resume_state.pkl``."""
        os.makedirs(save_path, exist_ok=True)
        _atomic_dump(payload, os.path.join(save_path, self.resume_name))

    def load_resume(self, path: str) -> dict:
        if os.path.isdir(path):
            path = os.path.join(path, self.resume_name)
        return _load(path)

    def promote_best(self, save_path: str):
        shutil.copyfile(os.path.join(save_path, self.latest_name),
                        os.path.join(save_path, self.best_name))

    def load(self, path: str) -> dict:
        if os.path.isdir(path):
            path = os.path.join(path, self.best_name)
        return _load(path)


@contextlib.contextmanager
def _quiet_single_process():
    """DCP warns that it assumes one process when it runs without a
    process group: that is the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings('ignore', message='torch.distributed is '
                                'disabled, unavailable or uninitialized')
        yield


SKELETON_KEY = 'skeleton'
DCP_METADATA = '.metadata'


class DistCheckpointer:
    """``--ckpt_backend orbax`` on ``torch.distributed.checkpoint`` (see
    the module docstring).  A tree is saved as flat tensors ``a0, a1,
    ...`` and a ``skeleton``: the tree's JSON with each array replaced by
    its key (numpy or torch, and a ``RowShard``'s real row count), plain
    values kept, empty arrays by shape and type."""

    latest_name = 'latest_checkpoint.orbax'
    best_name = 'best.orbax'
    resume_name = 'resume_state.orbax'
    cooperative = True

    def __init__(self):
        self._device_meshes = {}

    # --- the tree as flat tensors -----------------------------------------

    def _device_mesh(self, device_type: str):
        """A 1-D device mesh of every rank (made once a device type)."""
        from torch.distributed.device_mesh import init_device_mesh
        if device_type not in self._device_meshes:
            self._device_meshes[device_type] = init_device_mesh(
                device_type, (dist.get_world_size(),))
        return self._device_meshes[device_type]

    def _encode(self, tree) -> dict:
        tensors = {}

        def leaf(x):
            key = f'a{len(tensors)}'
            if isinstance(x, RowShard):
                from torch.distributed.tensor import DTensor, Shard
                local = x.local.detach().contiguous()
                tensors[key] = DTensor.from_local(
                    local, self._device_mesh(local.device.type), [Shard(0)],
                    run_check=False)
                return {'a': key, 'rows': x.n_rows}
            if isinstance(x, torch.Tensor):
                t, kind = x.detach(), 'torch'
            else:
                t, kind = torch.from_numpy(np.ascontiguousarray(x)), 'numpy'
            if not t.numel():
                return {'empty': list(t.shape), 'dtype': str(t.dtype),
                        'kind': kind}
            tensors[key] = t
            return {'a': key, 'kind': kind}

        def walk(x):
            if isinstance(x, (RowShard, torch.Tensor, np.ndarray)):
                return leaf(x)      # a RowShard before the tuples
            if isinstance(x, dict):
                return {'d': {str(k): walk(v) for k, v in x.items()}}
            if isinstance(x, (list, tuple)):
                return {'l' if isinstance(x, list) else 't':
                        [walk(v) for v in x]}
            if isinstance(x, np.generic):
                return {'n': x.item(), 'dtype': str(x.dtype)}
            if x is None or isinstance(x, (bool, int, float, str)):
                return {'v': x}
            raise TypeError(f'cannot checkpoint a {type(x).__name__}')

        skeleton = json.dumps(walk(tree)).encode()
        tensors[SKELETON_KEY] = torch.frombuffer(bytearray(skeleton),
                                                 dtype=torch.uint8)
        return tensors

    @staticmethod
    def _decode(node, tensors):
        def walk(n):
            if 'd' in n:
                return {k: walk(v) for k, v in n['d'].items()}
            if 'l' in n:
                return [walk(v) for v in n['l']]
            if 't' in n:
                return tuple(walk(v) for v in n['t'])
            if 'n' in n:
                return np.dtype(n['dtype']).type(n['n'])
            if 'v' in n:
                return n['v']
            if 'empty' in n:
                t = torch.empty(n['empty'],
                                dtype=getattr(torch, n['dtype'][6:]))
                return t if n['kind'] == 'torch' else t.numpy()
            t = tensors[n['a']]
            if 'rows' in n:
                return t[:n['rows']].numpy()
            return t if n['kind'] == 'torch' else t.numpy()

        return walk(node)

    # --- saving -------------------------------------------------------------

    def _atomic_save(self, target: str, tree):
        """Every rank writes into ``target.tmp`` (cleared by rank 0
        first); rank 0 renames it to ``target`` once all have written."""
        import torch.distributed.checkpoint as dcp
        tmp = target + '.tmp'
        if is_primary() and os.path.exists(tmp):
            shutil.rmtree(tmp)
        barrier()
        with _quiet_single_process():
            dcp.save(self._encode(tree), checkpoint_id=tmp,
                     no_dist=not dist.is_initialized())
        barrier()           # every rank's rows are written
        if is_primary():
            if os.path.exists(target):
                shutil.rmtree(target)
            os.rename(tmp, target)
        barrier()           # the checkpoint is in place for every rank

    def save_latest(self, save_path: str, state: dict):
        """``state``'s params (numpy arrays, or ``RowShard``s of the
        tables), epoch and model; every rank calls it."""
        os.makedirs(save_path, exist_ok=True)
        self._atomic_save(os.path.join(save_path, self.latest_name), state)

    def save_resume(self, save_path: str, payload: dict):
        os.makedirs(save_path, exist_ok=True)
        self._atomic_save(os.path.join(save_path, self.resume_name),
                          payload)

    def promote_best(self, save_path: str):
        """Rank 0 copies ``latest_checkpoint.orbax`` to ``best.orbax``
        between barriers."""
        barrier()
        if is_primary():
            dst = os.path.join(save_path, self.best_name)
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(os.path.join(save_path, self.latest_name), dst)
        barrier()

    # --- loading --------------------------------------------------------------

    def _restore(self, path: str):
        """The tree saved in the DCP or Orbax directory ``path``, read by
        this process alone."""
        if os.path.isdir(path) and orbax_reader.is_orbax_dir(path) and \
                not os.path.exists(os.path.join(path, DCP_METADATA)):
            return orbax_reader.restore(path)
        import torch.distributed.checkpoint as dcp
        if not os.path.isdir(path) or not os.path.exists(
                os.path.join(path, DCP_METADATA)):
            raise ValueError(
                f'{path} is neither a torch.distributed.checkpoint '
                f'directory (it has no {DCP_METADATA}) nor an Orbax '
                f'checkpoint (it has no {orbax_reader.METADATA})')
        meta = dcp.FileSystemReader(path).read_metadata()
        tensors = {key: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                   for key, m in meta.state_dict_metadata.items()}
        with _quiet_single_process():
            dcp.load(tensors, checkpoint_id=path, no_dist=True)
        skeleton = json.loads(bytes(tensors[SKELETON_KEY].numpy()))
        return self._decode(skeleton, tensors)

    def load_resume(self, path: str) -> dict:
        if os.path.isdir(path) and not os.path.normpath(path).endswith(
                '.orbax'):
            path = os.path.join(path, self.resume_name)
        return self._restore(path)

    def load(self, path: str) -> dict:
        """A checkpoint directory, or a run directory's ``best.orbax``
        (``best.pkl`` when it has none)."""
        if os.path.isdir(path) and not os.path.normpath(path).endswith(
                '.orbax'):
            best = os.path.join(path, self.best_name)
            path = best if os.path.exists(best) else os.path.join(
                path, PickleCheckpointer.best_name)
        if path.endswith('.pkl'):
            return PickleCheckpointer().load(path)
        tree = self._restore(path)
        if orbax_reader.is_orbax_dir(path):
            out = dict(tree.get('meta', {}))
            out['params'] = tree['params']
            return out
        return tree


FOREST_NAME = 'forest.npz'
_TREE_FIELDS = ('children_left', 'children_right', 'feature', 'threshold',
                'value', 'impurity', 'n_node_samples')


def save_forest(save_path: str, state: GBRTState) -> str:
    """Write ``state`` (``ops.trees.GBRTState``) as ``forest.npz`` in
    ``save_path``, atomically; returns the path."""
    os.makedirs(save_path, exist_ok=True)
    sizes = [t.node_count for t in state.trees]
    arrays = {f: np.concatenate([np.asarray(getattr(t, f)).reshape(-1)
                                 for t in state.trees])
              for f in _TREE_FIELDS}
    path = os.path.join(save_path, FOREST_NAME)
    tmp = path + '.tmp.npz'
    np.savez(tmp, offsets=np.concatenate([[0], np.cumsum(sizes)]),
             init=np.float64(state.init),
             learning_rate=np.float64(state.learning_rate),
             n_features=np.int64(state.n_features), **arrays)
    os.replace(tmp, path)
    return path


def load_forest(path: str):
    """The ``ops.trees.GBRTState`` of a ``forest.npz`` (a file or the run
    directory that holds it)."""
    if os.path.isdir(path):
        path = os.path.join(path, FOREST_NAME)
    with np.load(path, allow_pickle=False) as z:
        off = z['offsets']
        cols = {f: z[f] for f in _TREE_FIELDS}
        trees = [Tree(**{f: cols[f][a:b].copy() for f in _TREE_FIELDS})
                 for a, b in zip(off[:-1], off[1:])]
        return GBRTState(trees, float(z['init']), float(z['learning_rate']),
                         int(z['n_features']))


def make_checkpointer(backend: str = 'pickle'):
    """``PickleCheckpointer`` or, for ``orbax``, ``DistCheckpointer``."""
    if backend == 'orbax':
        return DistCheckpointer()
    if backend != 'pickle':
        raise ValueError(f'unknown checkpoint backend {backend!r}')
    return PickleCheckpointer()
