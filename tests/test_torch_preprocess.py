"""The port's ``data/preprocess.py`` against the JAX package's.

A raw meta/review JSON pair is written in ``tmp_path`` with what the
pandas pipeline has to get right: duplicate asins and (user, asin)
pairs, list descriptions, HTML and accents, texts of 5 characters or
fewer, pandas' NA strings, quotes and tabs in review text, float ratings,
a review with no time (the time column turns float), and users and items
that pass the 5-core but not the 13-core.  Both ``main``s run on copies
of it; the four TSVs and the summary must be byte-equal.
"""

import json
import os
import shutil

import numpy as np
import pytest

from textgcn_tpu.data import preprocess as jax_pre
from textgcn_tpu_torch.data import preprocess as port_pre

DOMAIN = 'Toys'


def _raw(rng: np.random.RandomState, with_null_time: bool):
    """(meta records, review records) of a small domain."""
    n_items, n_users = 30, 45
    meta = []
    for i in range(n_items):
        desc = (['Part one of <b>item</b>', f'&amp; part {i} café']
                if i % 4 == 0 else f'A description of item {i}, naïve')
        meta.append({'asin': f'A{i:03d}',
                     'title': f'Title été number {i}',
                     'description': desc, 'price': 1.0})
    meta[3]['title'] = 'NA'                      # NA after cleaning
    meta[5]['description'] = 'short'             # <= 5 characters
    meta[7]['title'] = '<i>null</i>'             # cleans to 'null'
    meta.append(dict(meta[2], title='a duplicate asin, dropped'))
    meta.append({'asin': 'A999', 'title': 'no description'})
    meta.append({'asin': 'N/A', 'title': 'an NA asin here',
                 'description': 'whose asin is an NA string'})
    reviews = []

    def review(u, i):
        reviews.append({
            'reviewerID': f'U{u}', 'asin': f'A{i:03d}',
            'reviewText': f'Review "{u}" of item {i}:\tgood™ <br/>value',
            'unixReviewTime': int(1_400_000_000 + rng.randint(10**6)),
            'overall': float(rng.randint(1, 6)), 'summary': 'x'})

    # users 0-39 review 14-21 of items 0-24; users 40-44 review 6-9 of
    # them and items 25-29 get 6-9 of users 0-39: these pass the 5-core
    # but not the 13-core
    for u in range(n_users):
        n = rng.randint(6, 10) if u >= 40 else rng.randint(14, 22)
        for i in rng.choice(25, n, replace=False):
            review(u, i)
    for i in range(25, n_items):
        for u in rng.choice(40, rng.randint(6, 10), replace=False):
            review(u, i)
    reviews[4]['reviewText'] = 'ok'              # cleans to ''
    reviews[9]['reviewText'] = 'NA'              # dropped as NA
    reviews[11]['reviewerID'] = 'null'           # dropped as NA
    reviews[13]['reviewText'] = ['a', 'list']    # not a string: cleans to ''
    reviews.append(dict(reviews[20], reviewText='duplicate pair, dropped'))
    reviews.append({'reviewerID': 'U0', 'asin': 'A001', 'overall': 5.0})
    if with_null_time:
        reviews[30]['unixReviewTime'] = None
    return meta, reviews


def _write_domain(root, meta, reviews) -> str:
    d = os.path.join(root, DOMAIN)
    os.makedirs(d)
    for name, recs in ((f'meta_{DOMAIN}.json', meta),
                       (f'{DOMAIN}.json', reviews)):
        with open(os.path.join(d, name), 'w') as f:
            for r in recs:
                f.write(json.dumps(r) + '\n')
    return d


OUTPUTS = ('meta_synced.tsv', 'reviews_text.tsv', 'train.tsv', 'test.tsv')


@pytest.fixture(scope='module', params=[(0, 42, False), (1, 3, True),
                                        (2, 0, False)],
                ids=['seed42', 'seed3-null-time', 'seed0'])
def runs(request, tmp_path_factory):
    """Both ``main``s on copies of one raw domain: {side: (dir, stdout)}."""
    data_seed, seed, null_time = request.param
    meta, reviews = _raw(np.random.RandomState(data_seed), null_time)
    import contextlib
    import io
    out = {}
    for side, mod in (('jax', jax_pre), ('port', port_pre)):
        d = _write_domain(str(tmp_path_factory.mktemp(side)), meta, reviews)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main([d, str(seed)])
        out[side] = (d, buf.getvalue())
    return out


@pytest.mark.parametrize('name', OUTPUTS)
def test_outputs_are_byte_equal(runs, name):
    (a, _), (b, _) = runs['jax'], runs['port']
    with open(os.path.join(a, name), 'rb') as f:
        want = f.read()
    with open(os.path.join(b, name), 'rb') as f:
        got = f.read()
    assert got == want
    assert want.count(b'\n') > 5


def test_summary_is_equal_and_the_13_core_cut(runs):
    (a, out_a), (_, out_b) = runs['jax'], runs['port']
    assert out_a == out_b
    with open(os.path.join(a, 'reviews_text.tsv')) as f:
        text = f.read()
    assert '""' in text and '\t1' in text      # quoting, int ratings
    # the small users and their items pass the 5-core, not the 13-core
    small_users = {f'U{u}' for u in range(40, 45)}
    small_items = {f'A{i:03d}' for i in range(25, 30)}
    meta = port_pre.process_metadata(os.path.join(a, f'meta_{DOMAIN}.json'))
    five = port_pre.process_reviews(os.path.join(a, f'{DOMAIN}.json'),
                                    set(meta.columns['asin']))
    assert small_users <= set(five.columns['user_id'])
    assert small_items <= set(five.columns['asin'])
    rows = [line.split('\t') for line in text.splitlines()[1:]]
    assert not small_users & {r[1] for r in rows if len(r) > 2}
    assert not small_items & {r[2] for r in rows if len(r) > 2}


def test_clean_text_matches():
    for s in ('<p>Café &amp; crème</p>', '  __hello__world ',
              '...leading punctuation', 'short', None, 5, 'x™ y z '
              'emoji \U0001F600 tail'):
        assert port_pre.clean_text(s) == jax_pre.clean_text(s)
    assert port_pre.NA_VALUES == jax_pre.NA_VALUES


def test_usage_without_arguments(capsys):
    with pytest.raises(SystemExit):
        port_pre.main([])
    assert 'usage' in capsys.readouterr().out


def test_split_of_a_copy_is_sklearns(tmp_path):
    """``train_test_split`` on a table gives the rows scikit-learn's
    split of the same table gives."""
    import pandas as pd
    rng = np.random.RandomState(5)
    users = [f'U{u}' for u in rng.randint(0, 30, 400)]
    items = [f'A{i}' for i in rng.randint(0, 50, 400)]
    df = pd.DataFrame({'user_id': users, 'asin': items})
    a_tr, a_te = jax_pre.train_test_split(df, seed=7)
    t = port_pre.Table({'user_id': users, 'asin': items},
                       {'user_id': 'object', 'asin': 'object'})
    b_tr, b_te = port_pre.train_test_split(t, seed=7)
    for a, b in ((a_tr, b_tr), (a_te, b_te)):
        assert a['user_id'].tolist() == b.columns['user_id']
        assert a['asin'].tolist() == b.columns['asin']


def test_module_entry_point(tmp_path):
    """``python -m textgcn_tpu_torch.data.preprocess <domain> [seed]``."""
    import subprocess
    import sys
    meta, reviews = _raw(np.random.RandomState(0), False)
    d = _write_domain(str(tmp_path), meta, reviews)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, '-m',
                        'textgcn_tpu_torch.data.preprocess', d, '42'],
                       cwd=repo, capture_output=True, text=True, check=True)
    assert r.stdout.startswith('reviews:')
    ref = shutil.copytree(d, str(tmp_path / 'ref' / DOMAIN))
    for f in OUTPUTS:
        os.remove(os.path.join(ref, f))
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        jax_pre.main([ref, '42'])
    for f in OUTPUTS:
        with open(os.path.join(d, f), 'rb') as x, \
                open(os.path.join(ref, f), 'rb') as y:
            assert x.read() == y.read(), f
