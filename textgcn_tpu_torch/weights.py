"""Parameters of the JAX package, as the port's tensors, and back.

The JAX package pickles its tables as numpy arrays whose row count may
exceed the real one: its TPU kernel pads them to a multiple of 4096
(``textgcn_tpu/models/lightgcn.py:72-80``) and a mesh run to a multiple
of the mesh size.  The phantom rows carry no edges and are never scored,
so the port slices them off.  Conv models add ``convs``, a list with one
dict of arrays per layer, in the same layout in both packages (``w*``
shaped ``(d_in, d_out)``, vectors ``(d,)``): ``gcn`` {``w``, ``b``},
``graphsage`` {``w_nbr``, ``w_root``, ``b``}, ``gat`` {``w``, ``a_src``,
``a_dst``, ``b``}, ``gatv2`` {``w_src``, ``w_dst``, ``a``, ``b``}.  The
LTR heads add ``tower``, a list of ``{'w': (fan_in, fan_out), 'b':
(fan_out,)}`` per layer: the JAX layout, which ``models/ltr.py``
transposes into and out of ``nn.Linear.weight`` (``(fan_out, fan_in)``).
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        device)


def params_from_jax(np_params: dict, n_users: int, n_items: int,
                    device='cpu') -> dict:
    """``{'user_emb': (n_users, d), 'item_emb': (n_items, d)}`` float32
    tensors on ``device`` from a JAX parameter dict, plus ``convs`` and
    ``tower`` (lists of dicts of tensors) when it has them; other keys are
    ignored."""
    out = {}
    for name, n in (('user_emb', n_users), ('item_emb', n_items)):
        if name not in np_params:
            raise KeyError(f'checkpoint has no {name!r} table')
        table = np.asarray(np_params[name])
        if table.ndim != 2 or table.shape[0] < n:
            raise ValueError(f'{name}: expected at least {n} rows, got '
                             f'shape {table.shape}')
        out[name] = _tensor(table[:n], device)
    for name in ('convs', 'tower'):
        if name in np_params:
            out[name] = [{k: _tensor(v, device) for k, v in layer.items()}
                         for layer in np_params[name]]
    return out


def params_to_jax(params: dict) -> dict:
    """The inverse: numpy float32 arrays in the JAX package's tree, for a
    checkpoint the JAX package's ``Trainer.load`` reads."""
    def arr(t):
        return t.detach().to('cpu', torch.float32).numpy().copy()

    out = {name: arr(params[name]) for name in ('user_emb', 'item_emb')}
    for name in ('convs', 'tower'):
        if name in params:
            out[name] = [{k: arr(v) for k, v in layer.items()}
                         for layer in params[name]]
    return out
