"""Checkpoints: the JAX package's pickle files, read and written.

Counterpart of the pickle half of ``textgcn_tpu/train/checkpoint.py``.
A checkpoint is ``{'params': {name: numpy array}, 'epoch', 'model'}``,
the conv models' params with their ``convs`` list of per-layer dicts
(``weights.py``); given a run directory, ``best.pkl`` is read.  The unpickler admits numpy
arrays and plain Python values only, so a crafted file cannot run code.
``save_latest`` writes ``latest_checkpoint.pkl`` atomically and
``promote_best`` copies it to ``best.pkl``.  ``save_resume`` writes the
trainer's ``resume_state.pkl`` beside it, the file ``--resume`` reads
(``load_resume``; its payload is ``Trainer.resume_payload``'s).  The
orbax backend is not ported yet.

The boosted heads write their fitted ensemble beside it as
``forest.npz`` (``save_forest``, ``load_forest``): every tree's node
arrays concatenated, with ``offsets`` into them, the initial prediction,
the learning rate and the feature count; numeric arrays only, read with
``allow_pickle=False``.
"""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np

from ..ops.trees import GBRTState, Tree

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


class PickleCheckpointer:
    latest_name = 'latest_checkpoint.pkl'
    best_name = 'best.pkl'
    resume_name = 'resume_state.pkl'

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


def make_checkpointer(backend: str = 'pickle') -> PickleCheckpointer:
    if backend == 'orbax':
        raise NotImplementedError('the orbax checkpoint backend is not '
                                  'ported yet')
    if backend != 'pickle':
        raise ValueError(f'unknown checkpoint backend {backend!r}')
    return PickleCheckpointer()
