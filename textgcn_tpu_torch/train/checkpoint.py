"""Checkpoints: the JAX package's pickle files, read and written.

Counterpart of the pickle half of ``textgcn_tpu/train/checkpoint.py``.
A checkpoint is ``{'params': {name: numpy array}, 'epoch', 'model'}``;
given a run directory, ``best.pkl`` is read.  The unpickler admits numpy
arrays and plain Python values only, so a crafted file cannot run code.
``save_latest`` writes ``latest_checkpoint.pkl`` atomically and
``promote_best`` copies it to ``best.pkl``.  The orbax backend and the
``resume_state.pkl`` of ``--resume`` are not ported yet.
"""

from __future__ import annotations

import os
import pickle
import shutil

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


class PickleCheckpointer:
    latest_name = 'latest_checkpoint.pkl'
    best_name = 'best.pkl'

    def save_latest(self, save_path: str, state: dict):
        """Write ``state`` (its params already numpy) to a temporary file
        and rename it, so a crash mid-write keeps the previous file."""
        os.makedirs(save_path, exist_ok=True)
        path = os.path.join(save_path, self.latest_name)
        tmp = path + '.tmp'
        with open(tmp, 'wb') as f:
            pickle.dump(state, f)
        os.replace(tmp, path)

    def promote_best(self, save_path: str):
        shutil.copyfile(os.path.join(save_path, self.latest_name),
                        os.path.join(save_path, self.best_name))

    def load(self, path: str) -> dict:
        if os.path.isdir(path):
            path = os.path.join(path, self.best_name)
        with open(path, 'rb') as f:
            return _ArrayUnpickler(f).load()


def make_checkpointer(backend: str = 'pickle') -> PickleCheckpointer:
    if backend == 'orbax':
        raise NotImplementedError('the orbax checkpoint backend is not '
                                  'ported yet')
    if backend != 'pickle':
        raise ValueError(f'unknown checkpoint backend {backend!r}')
    return PickleCheckpointer()
