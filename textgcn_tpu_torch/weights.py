"""Parameters of the JAX package, as the port's tensors.

The JAX package pickles its tables as numpy arrays whose row count may
exceed the real one: its TPU kernel pads them to a multiple of 4096
(``textgcn_tpu/models/lightgcn.py:72-80``) and a mesh run to a multiple
of the mesh size.  The phantom rows carry no edges and are never scored,
so the port slices them off.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(np_params: dict, n_users: int, n_items: int,
                    device='cpu') -> dict[str, torch.Tensor]:
    """``{'user_emb': (n_users, d), 'item_emb': (n_items, d)}`` float32
    tensors on ``device`` from a JAX parameter dict (other keys are
    ignored)."""
    out = {}
    for name, n in (('user_emb', n_users), ('item_emb', n_items)):
        if name not in np_params:
            raise KeyError(f'checkpoint has no {name!r} table')
        table = np.asarray(np_params[name])
        if table.ndim != 2 or table.shape[0] < n:
            raise ValueError(f'{name}: expected at least {n} rows, got '
                             f'shape {table.shape}')
        out[name] = torch.from_numpy(
            np.ascontiguousarray(table[:n], dtype=np.float32)).to(device)
    return out
