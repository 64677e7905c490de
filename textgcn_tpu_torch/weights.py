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

``RowShard`` marks a rank's rows of a table in a tree that a
cooperative checkpoint writes.

The boosted heads' fitted ensemble is carried across by
``forest_from_estimator`` (a scikit-learn estimator object, read
duck-typed) and ``forest_from_tree_pkl`` (the JAX package's ``tree.pkl``,
the pickled estimator, read by a restricted unpickler that builds inert
stand-ins for scikit-learn's classes); neither imports scikit-learn.

``bert_state_from_flax`` turns a Flax BERT's, RoBERTa's, XLM-RoBERTa's or
DistilBERT's parameter tree into the ``state_dict`` of the port's text encoder
(``data/encoder_models.py``).
"""

from __future__ import annotations

import io
import pickle
import pickletools
from typing import NamedTuple

import numpy as np
import torch

from .data.encoder_models import bert_name


class RowShard(NamedTuple):
    """This rank's rows of a row-sharded table (the zero-padded table's
    rows ``parallel.mesh.Mesh.rows`` gives it) and the table's real row
    count: what a cooperative checkpoint writes for a table on a mesh
    (``train.checkpoint.DistCheckpointer``), where the pickle backend
    writes the gathered real rows."""
    local: torch.Tensor
    n_rows: int


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
    checkpoint the JAX package's ``Trainer.load`` reads (a ``RowShard``
    table is passed on as it is)."""
    def arr(t):
        if isinstance(t, RowShard):
            return t
        return t.detach().to('cpu', torch.float32).numpy().copy()

    out = {name: arr(params[name]) for name in ('user_emb', 'item_emb')}
    for name in ('convs', 'tower'):
        if name in params:
            out[name] = [{k: arr(v) for k, v in layer.items()}
                         for layer in params[name]]
    return out


def forest_from_estimator(est):
    """The port's ensemble (``ops.trees.GBRTState``) of a fitted
    scikit-learn ``GradientBoostingRegressor`` (its ``estimators_``' trees,
    ``learning_rate`` and ``init_.constant_``; ``init='zero'`` gives 0) or
    of one ``DecisionTreeRegressor`` (``tree_``: learning rate 1, init 0),
    read duck-typed.  Refuses another ``init`` estimator and an ensemble
    without trees."""
    from .ops.trees import GBRTState, Tree
    if hasattr(est, 'estimators_'):
        if not hasattr(est, 'learning_rate'):
            raise ValueError(f'{type(est).__name__} is not a gradient-'
                             'boosted ensemble (no learning_rate)')
        trees = [e.tree_ for e in np.asarray(est.estimators_).reshape(-1)]
        init = getattr(est, 'init_', None)
        if init is not None and hasattr(init, 'constant_'):
            base = float(np.asarray(init.constant_).reshape(()))
        elif init is None or (isinstance(init, str) and init == 'zero'):
            base = 0.0
        else:
            raise ValueError(f'init estimator {type(init).__name__} is not '
                             'supported: only a constant (DummyRegressor) '
                             "or 'zero'")
        scale = float(est.learning_rate)
    elif hasattr(est, 'tree_'):
        trees, base, scale = [est.tree_], 0.0, 1.0
    else:
        raise TypeError(f'{type(est).__name__} has no fitted trees')
    if not trees:
        raise ValueError('the estimator has no trees')
    out = [Tree(np.asarray(t.children_left, np.int64).copy(),
                np.asarray(t.children_right, np.int64).copy(),
                np.asarray(t.feature, np.int64).copy(),
                np.asarray(t.threshold, np.float64).copy(),
                np.asarray(t.value, np.float64).reshape(-1).copy(),
                np.asarray(t.impurity, np.float64).copy(),
                np.asarray(t.n_node_samples, np.int64).copy())
           for t in trees]
    return GBRTState(out, base, scale, int(est.n_features_in_))


# the globals of a pickled GradientBoostingRegressor (scikit-learn 1.9,
# numpy 2) besides numpy's arrays: each gets an inert stand-in
TREE_PKL_GLOBALS = {
    ('sklearn.ensemble._gb', 'GradientBoostingRegressor'),
    ('sklearn.tree._classes', 'DecisionTreeRegressor'),
    ('sklearn.tree._tree', 'Tree'),
    ('sklearn.dummy', 'DummyRegressor'),
    ('sklearn._loss.loss', 'HalfSquaredError'),
    ('sklearn._loss.link', 'IdentityLink'),
    ('sklearn._loss.link', 'Interval'),
    ('sklearn._loss._loss', 'CyHalfSquaredError'),
    ('numpy.random._pickle', '__randomstate_ctor'),
    ('numpy.random._pickle', '__bit_generator_ctor'),
    ('numpy.random._mt19937', 'MT19937'),
    ('numpy.random.bit_generator', '__pyx_unpickle_SeedSequence'),
    ('numpy.random.bit_generator', 'SeedSequence'),
}
_STRING_OPS = {'SHORT_BINUNICODE', 'BINUNICODE', 'BINUNICODE8', 'UNICODE',
               'SHORT_BINSTRING', 'BINSTRING', 'STRING'}
_QUIET_OPS = {'PROTO', 'FRAME', 'MEMOIZE', 'PUT', 'BINPUT', 'LONG_BINPUT',
              'STOP'}


class _Inert:
    """A stand-in for a scikit-learn or ``numpy.random`` global of a
    ``tree.pkl``: built or called, it keeps its arguments and state and
    runs nothing; a key of a dict state reads as an attribute."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __getattr__(self, name):
        state = self.__dict__.get('state')
        if isinstance(state, dict) and name in state:
            return state[name]
        raise AttributeError(f'{type(self).__name__} has no {name!r}')


class _InertTree(_Inert):
    """``sklearn.tree._tree.Tree``: reduce arguments ``(n_features,
    n_classes, n_outputs)``, state ``nodes`` (a structured array read by
    field name), ``values`` and ``node_count``."""

    def _field(self, name):
        nodes = self.state['nodes']
        if nodes.dtype.names is None or name not in nodes.dtype.names:
            raise ValueError(f'tree.pkl: Tree nodes have no {name!r} field '
                             f'(fields {nodes.dtype.names})')
        if len(nodes) != int(self.state['node_count']):
            raise ValueError(f'tree.pkl: {len(nodes)} nodes, node_count '
                             f'{self.state["node_count"]}')
        return nodes[name]

    children_left = property(lambda self: self._field('left_child'))
    children_right = property(lambda self: self._field('right_child'))
    feature = property(lambda self: self._field('feature'))
    threshold = property(lambda self: self._field('threshold'))
    impurity = property(lambda self: self._field('impurity'))
    n_node_samples = property(lambda self: self._field('n_node_samples'))

    @property
    def value(self):
        values = np.asarray(self.state['values'])
        if len(self.args) != 3 or int(self.args[2]) != 1 or \
                values.shape[0] != len(self._field('left_child')) or \
                values.size != values.shape[0]:
            raise ValueError(f'tree.pkl: a Tree of {self.args[2:]} outputs '
                             f'and values of shape {values.shape}: one '
                             'regression output per node is read')
        return values


def _refuse(module: str, name: str, path: str):
    what = f'{module}.{name}'
    if module.split('.')[0] == 'xgboost':
        raise pickle.UnpicklingError(
            f'{path} holds an xgboost model ({what}): the port reads the '
            'GradientBoostingRegressor the JAX package pickles, and xgboost '
            'is not installed where it runs; refit the head')
    raise pickle.UnpicklingError(
        f'{path} refers to {what}: a tree.pkl may name numpy arrays and '
        "the classes of a scikit-learn GradientBoostingRegressor only")


def _tree_pkl_globals(data: bytes, path: str) -> list[tuple[str, str]]:
    """Every global the pickle names, found by reading its opcodes
    (nothing is built); raises for one it cannot name."""
    out, recent, memo = [], [], {}
    for op, arg, _ in pickletools.genops(data):
        name = op.name
        if name == 'MEMOIZE':
            memo[len(memo)] = recent[-1] if recent else None
        elif name in ('PUT', 'BINPUT', 'LONG_BINPUT'):
            memo[arg] = recent[-1] if recent else None
        elif name in _QUIET_OPS:
            continue
        elif name in _STRING_OPS:
            recent.append(arg if isinstance(arg, str) else None)
        elif name in ('GET', 'BINGET', 'LONG_BINGET'):
            recent.append(memo.get(arg))
        elif name == 'STACK_GLOBAL':
            pair = recent[-2:]
            if len(pair) != 2 or not all(isinstance(x, str) for x in pair):
                raise pickle.UnpicklingError(
                    f'{path}: a global at opcode {name} whose module and '
                    'name are not plain strings')
            out.append(tuple(pair))
            recent.append(None)
        elif name in ('GLOBAL', 'INST'):
            out.append(tuple(arg.split(' ', 1)))
            recent.append(None)
        elif name in ('EXT1', 'EXT2', 'EXT4', 'PERSID', 'BINPERSID'):
            raise pickle.UnpicklingError(f'{path}: opcode {name} is not '
                                         'read')
        else:
            recent.append(None)
    return out


def forest_from_tree_pkl(path: str):
    """The port's ensemble (``ops.trees.GBRTState``) of the JAX package's
    ``tree.pkl`` (a pickled ``GradientBoostingRegressor``), equal to
    ``forest_from_estimator(pickle.load(...))`` and made without
    scikit-learn.  The file's globals are read from its opcodes first:
    any but numpy's array globals and ``TREE_PKL_GLOBALS`` raises
    ``pickle.UnpicklingError`` naming it before anything is built.  Those
    are then unpickled as inert stand-ins (``_Inert``), so no code from the
    file runs, and each ``Tree`` is read from its ``nodes`` and
    ``values``."""
    from .train.checkpoint import _ArrayUnpickler
    with open(path, 'rb') as f:
        data = f.read()

    class _Unpickler(_ArrayUnpickler):
        def find_class(self, module, name):
            if (module, name) in TREE_PKL_GLOBALS:
                base = _InertTree if name == 'Tree' else _Inert
                return type(name, (base,), {'__module__': module})
            try:
                return super().find_class(module, name)
            except pickle.UnpicklingError:
                _refuse(module, name, path)

    probe = _Unpickler(io.BytesIO(b''))
    for module, name in _tree_pkl_globals(data, path):
        probe.find_class(module, name)
    est = _Unpickler(io.BytesIO(data)).load()
    if type(est).__name__ != 'GradientBoostingRegressor':
        raise ValueError(f'{path} holds a {type(est).__name__}, not a '
                         'GradientBoostingRegressor')
    return forest_from_estimator(est)


def bert_state_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's text encoder
    (``data.encoder_models``) from a Flax BERT's, RoBERTa's, XLM-RoBERTa's
    or DistilBERT's parameter tree of numpy arrays (``FlaxBertModel
    .params``, ``FlaxRobertaModel.params``, ``FlaxXLMRobertaModel.params``,
    ``FlaxDistilBertModel.params``): Dense
    kernels ``(in, out)`` transposed into ``nn.Linear.weight``, LayerNorm
    ``scale`` as ``weight``, Embed ``embedding`` as ``weight``, DistilBERT's
    names mapped onto BERT's (``bert_name``); the pooler left out.  A
    DistilBERT with ``sinusoidal_pos_embds`` has no position table in
    Flax: the encoder makes its own."""
    names = {'kernel': 'weight', 'scale': 'weight', 'embedding': 'weight',
             'bias': 'bias'}
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, (*path, str(key)))
                continue
            t = torch.from_numpy(np.array(value, np.float32))
            if key == 'kernel':
                t = t.T.contiguous()
            out[bert_name('.'.join((*path, names[key])))] = t

    for top in ('embeddings', 'encoder', 'transformer'):
        if top in params:
            walk(params[top], (top,))
    return out
