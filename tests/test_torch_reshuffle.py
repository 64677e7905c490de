"""``--reshuffle`` in the port against the JAX package.

``reshuffle_train_test`` must write ``reshuffle_<seed>/{train,test}.tsv``
byte-equal to the JAX package's (pandas and scikit-learn there, csv and
``data/split.py`` here) on a copy of ``data/dummy`` and on a 600 x 240
sharp set, and ``load_interactions(reshuffle=True)`` must load what the
JAX loader loads from them.
"""

import os
import shutil

import pytest
from test_torch_data import _assert_same_data

from textgcn_tpu.data import core as jax_core
from textgcn_tpu_torch.data import core as port_core
from textgcn_tpu_torch.tools.make_synthetic import generate

SEEDS = [0, 3, 42]


@pytest.fixture(scope='module')
def sources(tmp_path_factory, dummy_dir):
    root = tmp_path_factory.mktemp('sources')
    sharp = str(root / 'sharp')
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        generate(sharp, 600, 240, seed=0, sharp=True)
    return {'dummy': dummy_dir, 'sharp': sharp}


@pytest.fixture(scope='module')
def reshuffled(sources, tmp_path_factory):
    """{(source, seed): (JAX folder, port folder)}, each side on its own
    copy of the source."""
    out = {}
    for name, src in sources.items():
        for seed in SEEDS:
            dirs = []
            for side, mod in (('jax', jax_core), ('port', port_core)):
                d = str(tmp_path_factory.mktemp(f'{name}{seed}{side}')
                        / name)
                shutil.copytree(src, d)
                dirs.append(mod.reshuffle_train_test(d, seed))
            out[(name, seed)] = tuple(dirs)
    return out


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('source', ['dummy', 'sharp'])
@pytest.mark.parametrize('name', ['train.tsv', 'test.tsv'])
def test_reshuffled_files_are_byte_equal(reshuffled, source, seed, name):
    a, b = reshuffled[(source, seed)]
    assert os.path.basename(b) == f'reshuffle_{seed}'
    with open(os.path.join(a, name), 'rb') as f:
        want = f.read()
    with open(os.path.join(b, name), 'rb') as f:
        assert f.read() == want
    assert want.count(b'\n') > 3


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('source', ['dummy', 'sharp'])
def test_load_with_reshuffle_matches_jax(reshuffled, source, seed):
    a, b = reshuffled[(source, seed)]
    _assert_same_data(
        jax_core.load_interactions(os.path.dirname(a), reshuffle=True,
                                   seed=seed),
        port_core.load_interactions(os.path.dirname(b), reshuffle=True,
                                    seed=seed))


def test_an_existing_folder_is_reused(tmp_path, dummy_dir):
    d = str(tmp_path / 'dummy')
    shutil.copytree(dummy_dir, d)
    out = port_core.reshuffle_train_test(d, 5)
    with open(os.path.join(out, 'train.tsv'), 'a') as f:
        f.write('marker\tline\n')
    assert port_core.reshuffle_train_test(d, 5) == out
    with open(os.path.join(out, 'train.tsv')) as f:
        assert f.read().endswith('marker\tline\n')


def test_extra_columns_and_na_fields_follow_pandas(tmp_path):
    """Files with an extra column (in test only), NA sentinels and quoted
    fields: the columns' union, missing values empty, as pandas writes."""
    rows = [('u%d' % (n % 7), 'i%d' % (n % 11)) for n in range(60)]
    with open(tmp_path / 'train.tsv', 'w') as f:
        f.write('user_id\tasin\n')
        for n, (u, i) in enumerate(rows[:50]):
            f.write(f'{u}\t{"NA" if n == 3 else i}\n')
    with open(tmp_path / 'test.tsv', 'w') as f:
        f.write('user_id\tasin\tnote\n')
        for n, (u, i) in enumerate(rows[50:]):
            f.write(f'{u}\t{i}\t"a ""quoted"" note {n}"\n')
    copies = []
    for side in ('jax', 'port'):
        d = tmp_path / side
        shutil.copytree(tmp_path, d, ignore=shutil.ignore_patterns(
            'jax', 'port'))
        copies.append(str(d))
    a = jax_core.reshuffle_train_test(copies[0], 1)
    b = port_core.reshuffle_train_test(copies[1], 1)
    for name in ('train.tsv', 'test.tsv'):
        with open(os.path.join(a, name), 'rb') as x, \
                open(os.path.join(b, name), 'rb') as y:
            assert x.read() == y.read(), name
