"""The port's data layer and config against the JAX package's.

``textgcn_tpu_torch.data.core.load_interactions`` (csv + numpy) must give
the JAX package's ``load_interactions`` (pandas) field by field, and the
port's ``Config`` must keep every flag name and default.
"""

import dataclasses

import numpy as np
import pytest

from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data.core import load_interactions as jax_load
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions as torch_load


def _assert_same_data(a, b):
    for name in ('n_users', 'n_items', 'n_train', 'n_test'):
        assert getattr(a, name) == getattr(b, name), name
    for name in ('edge_user', 'edge_item', 'edge_weight', 'user_degree',
                 'item_degree'):
        x, y = getattr(a.graph, name), getattr(b.graph, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.graph.n_users, a.graph.n_items) == (b.graph.n_users,
                                                  b.graph.n_items)
    for name in ('pos_padded', 'pos_degree', 'test_users'):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert [[int(i) for i in t] for t in a.true_test] == \
        [[int(i) for i in t] for t in b.true_test]
    for name in ('user_id_map', 'item_id_map'):
        x = {int(k): str(v) for k, v in getattr(a, name).items()}
        y = {int(k): str(v) for k, v in getattr(b, name).items()}
        assert x == y, name


def test_loader_matches_jax_on_dummy(dummy_dir):
    _assert_same_data(jax_load(dummy_dir), torch_load(dummy_dir))


def _write_tsv(path, rows):
    with open(path, 'w') as f:
        f.write('user_id\tasin\n')
        for u, a in rows:
            f.write(f'{u}\t{a}\n')


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_loader_matches_jax_on_synthetic(tmp_path, seed):
    """Ids that sort differently as strings and as numbers, duplicate
    edges, a user without test items and an item only in the test file
    (dropped with a warning)."""
    rng = np.random.RandomState(seed)
    users = [f'{n}' for n in rng.permutation(40)] + ['u10', 'u9', 'u100']
    items = [f'i{n}' for n in rng.permutation(30)] + ['10', '9']
    train = [(users[rng.randint(len(users))], items[rng.randint(len(items))])
             for _ in range(400)]
    train += [(u, items[rng.randint(len(items))]) for u in users]
    train += train[:7]                                   # duplicates
    rng.shuffle(train)
    tu = sorted({u for u, _ in train})[:-1]
    test = [(u, items[rng.randint(len(items))]) for u in tu
            for _ in range(rng.randint(0, 3))]
    test += [(tu[0], 'only_in_test')]
    _write_tsv(tmp_path / 'train.tsv', train)
    _write_tsv(tmp_path / 'test.tsv', test)
    a, b = jax_load(str(tmp_path)), torch_load(str(tmp_path))
    assert 'only_in_test' not in b.item_id_map.values()
    _assert_same_data(a, b)


def test_loader_rejects_test_only_user_and_reshuffle(tmp_path, dummy_dir):
    _write_tsv(tmp_path / 'train.tsv', [('a', 'x'), ('b', 'y')])
    _write_tsv(tmp_path / 'test.tsv', [('c', 'x')])
    with pytest.raises(ValueError, match="don't appear in train"):
        torch_load(str(tmp_path))
    with pytest.raises(NotImplementedError, match='reshuffle'):
        torch_load(dummy_dir, reshuffle=True)


def test_loader_rejects_ragged_row(tmp_path):
    (tmp_path / 'train.tsv').write_text('user_id\tasin\na\tx\nb\n')
    (tmp_path / 'test.tsv').write_text('user_id\tasin\n')
    with pytest.raises(ValueError, match='expected 2 fields'):
        torch_load(str(tmp_path))


def test_config_fields_and_defaults_match_jax():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default
                   for f in dataclasses.fields(tconfig.Config)}
    assert jax_fields == port_fields


@pytest.mark.parametrize('argv', [
    ['--model', 'lgcn'],
    ['--model', 'lgcn', '--data', 'data/dummy', '-k', '40', '3', '--single',
     '--no_train', '--predict', '--uid', 'u', '--emb_size', '16'],
    ['--model', 'lgcn', '--no_pallas', '--steps_per_call', '8',
     '--weight', 'max(p-n)_|b-g|', '--no_save'],
])
def test_parse_args_matches_jax(argv):
    from textgcn_tpu.config import parse_args as jax_parse
    argv = argv + ['--uid', 'same']
    a, b = jax_parse(argv), tconfig.parse_args(argv)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize('argv, err', [
    (['--model', 'adv_sampling'], NotImplementedError),
    (['--model', 'ltr_linear'], NotImplementedError),
    (['--model', 'gcn', '--aggr', 'mean', '--mesh', '2x4'],
     NotImplementedError),
    (['--model', 'lgcn', '--approx_topk', '0.95'], NotImplementedError),
    (['--model', 'lgcn', '--dropout', '1.5'], ValueError),
    (['--model', 'lgcn', '--load', 'a', '--load_base', 'b'], ValueError),
    (['--model', 'lgcn', '--refresh_every', '4'], NotImplementedError),
    (['--model', 'lgcn', '--trace', 'out'], NotImplementedError),
    (['--model', 'gat'], ValueError),
])
def test_parse_args_refuses_what_is_not_ported(argv, err):
    with pytest.raises(err):
        tconfig.parse_args(argv)
