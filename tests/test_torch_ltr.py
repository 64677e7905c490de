"""The port's LTR heads (``ltr_linear``, ``ltr_pop``) and their text data
against the JAX package's, on the CPU.

Both sides take the stub encoder (conftest sets
``TEXTGCN_TPU_TEXT_ENCODER=stub``) or the embedding caches checked in
under ``data/dummy/embeddings``; tests that could write a cache run on a
copy of ``data/dummy`` in ``tmp_path``.  The models take the same params
(``params_from_jax``), batches and dropout salts; the JAX side takes the
hash-dropout weights through its exact-f32 XLA op, as
``tests/test_torch_train.py`` does.

Tolerances: the loader's counts and popularity exactly, its vectors 1e-6;
scores and losses 1e-5 (f32 sums of a few terms in another order), the
gradients 1e-5 absolute / 1e-4 relative, the fused catalogue scores 1e-5
and the top-k's values 1e-5 (indices where the values are apart).
"""

import logging
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.config import warn_footguns as jax_warn_footguns
from textgcn_tpu.data import text as jax_text
from textgcn_tpu.models.ltr import LTRLinear as JaxLTRLinear
from textgcn_tpu.models.ltr import LTRLinearWPop as JaxLTRLinearWPop
from textgcn_tpu.models.ltr import collapse_tower as jax_collapse_tower
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data import text
from textgcn_tpu_torch.models.ltr import (LTRLinear, LTRLinearWPop,
                                          collapse_tower)
from textgcn_tpu_torch.ops.spmm import spmm_dropout_cuda
from textgcn_tpu_torch.train.trainer import Trainer
from textgcn_tpu_torch.weights import params_from_jax, params_to_jax

SALT = 0x9E3779B9                      # high bit set
KEEP = float(np.float32(1.0 - 0.4))
PAIRS = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))
D = 16
TEXT_FIELDS = ('items_as_desc', 'items_as_avg_reviews',
               'users_as_avg_reviews', 'users_as_avg_desc')
EXACT_FIELDS = ('popularity_users', 'popularity_items', 'text_dim',
                'n_users', 'n_items', 'n_train', 'n_test')
MODELS = {'ltr_linear': (JaxLTRLinear, LTRLinear),
          'ltr_pop': (JaxLTRLinearWPop, LTRLinearWPop)}


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def _configs(data_dir, **kw):
    common = dict(data=str(data_dir), emb_size=D, n_layers=3, dropout=0.4,
                  reg_lambda=1e-3, batch_size=16, k=(3, 5), lr=1e-2,
                  save_path='/nonexistent')
    common.update(kw)
    return (JaxConfig(**common).finalize(),
            tconfig.Config(save=False, **common).finalize())


@pytest.fixture(scope='module')
def dummy_copy(tmp_path_factory, dummy_dir):
    """A copy of data/dummy with its checked-in caches: a cache written by
    a test lands here, not in the repository."""
    out = tmp_path_factory.mktemp('ltr') / 'dummy'
    shutil.copytree(dummy_dir, out)
    return str(out)


@pytest.fixture(scope='module')
def ltr_data(dummy_copy):
    """(JAX LTRData, port LTRData) of data/dummy, popularity 'fixed'."""
    jc, tc = _configs(dummy_copy)
    return jax_text.load_ltr_data(jc), text.load_ltr_data(tc)


def _assert_same_data(a, b):
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                      np.asarray(getattr(a, f)), err_msg=f)
    for f in TEXT_FIELDS:
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), atol=1e-6,
                                   rtol=0, err_msg=f)
    np.testing.assert_array_equal(b.pos_padded, a.pos_padded)
    assert b.true_test == a.true_test


# --- the stub encoder and the cache -----------------------------------------

SENTENCES = ['', 'a', 'item number 0 title words [SEP] detail',
             'überstark — ✓ 数据', 'x' * 5000]


def test_stub_encoder_and_fingerprint_are_the_jax_ones():
    got = text._stub_encode(SENTENCES)
    np.testing.assert_array_equal(got, jax_text._stub_encode(SENTENCES))
    assert got.shape == (len(SENTENCES), text.STUB_DIM)
    assert text._texts_fingerprint(SENTENCES) == \
        jax_text._texts_fingerprint(SENTENCES)
    assert text._texts_fingerprint(SENTENCES[:2]) != \
        text._texts_fingerprint(SENTENCES[1::-1])


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_a_cache_one_package_writes_the_other_reads(tmp_path, writer):
    """The writer encodes and writes ``.npy`` + ``.meta``; the rows are
    then replaced in place (the fingerprint kept), so a reader that
    re-encoded would not return them."""
    cache = str(tmp_path / 'emb' / 'repr_m_0-seed')
    texts = SENTENCES + SENTENCES[:2]
    if writer == 'jax':
        first = jax_text.embed_text(pd.Series(texts), cache, 'm', 4)
    else:
        first = text.embed_text(texts, cache, 'm', 4)
    np.testing.assert_array_equal(first, text._stub_encode(texts))
    marked = np.random.RandomState(0).randn(*first.shape).astype(np.float32)
    np.save(cache + '.npy', marked)
    np.testing.assert_array_equal(
        jax_text.embed_text(pd.Series(texts), cache, 'm', 4), marked)
    np.testing.assert_array_equal(text.embed_text(texts, cache, 'm', 4),
                                  marked)
    # another row set is stale for both: re-encoded
    np.testing.assert_array_equal(text.embed_text(texts[:3], cache, 'm', 4),
                                  text._stub_encode(texts[:3]))


def test_reference_torch_cache_and_missing_encoder(tmp_path, monkeypatch):
    cache = str(tmp_path / 'repr_m_0-seed')
    vecs = torch.randn(3, 5)
    torch.save(vecs, cache + '.torch')
    np.testing.assert_array_equal(text.embed_text(['a', 'b', 'c'], cache,
                                                  'm', 4), vecs.numpy())
    # without a cache the encoder runs: it refuses a model that is absent
    # (nothing is downloaded) or of a type it does not run (roberta runs
    # since the encoder families came, xlm-roberta since the multilingual
    # encoders), and never falls back
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('HF_HUB_CACHE', str(tmp_path / 'hub'))
    monkeypatch.setenv(text.ENCODER_ENV, 'st')
    with pytest.raises(FileNotFoundError, match="'m' not found"):
        text.embed_text(['a', 'b'], cache, 'm', 4)
    monkeypatch.delenv(text.ENCODER_ENV)
    other = tmp_path / 'gpt2'
    other.mkdir()
    (other / 'config.json').write_text('{"model_type": "gpt2"}')
    with pytest.raises(NotImplementedError, match="'gpt2' is not ported"):
        text.encode_sentences(['a'], str(other), 4)


# --- the loader --------------------------------------------------------------

def test_load_ltr_data_matches_jax_on_dummy(ltr_data):
    _assert_same_data(*ltr_data)
    a, b = ltr_data
    assert b.items_as_desc.shape == (b.n_items, text.STUB_DIM)
    assert b.popularity_users.max() == pytest.approx(1.0)


def _write_edge_case_data(root):
    """A dataset that exercises pandas' semantics: 40 users x 12 items,
    reviews with many equal times (so the unstable sort decides), pairs
    reviewed twice, reviews of test edges and of unknown ids, rows with an
    empty field; a meta file with quoted, empty, integer-with-gap, float
    and boolean columns, a repeated asin and two items it omits."""
    rng = np.random.RandomState(7)
    n_users, n_items = 40, 12
    pairs = sorted({(u, int(i)) for u in range(n_users)
                    for i in rng.choice(n_items, 4, replace=False)})
    test = [p for j, p in enumerate(pairs) if j % 5 == 4]
    train = [p for j, p in enumerate(pairs) if j % 5 != 4]
    os.makedirs(root / 'embeddings')
    for name, rows in (('train.tsv', train), ('test.tsv', test)):
        with open(root / name, 'w') as f:
            f.write('user_id\tasin\n')
            f.writelines(f'u{u:02d}\ti{i:02d}\n' for u, i in rows)
    lines = ['user_id\tasin\treview\ttime\trating']
    for j, (u, i) in enumerate(pairs + pairs[::7] + [(99, 1), (3, 50)]):
        t = str(1000 + rng.randint(0, 4))
        review = f'review {j} of i{i:02d} by u{u:02d}'
        if j == 11:
            review = ''                        # dropped by dropna
        if j == 17:
            t = 'NA'                           # dropped by dropna
        if j == 23:
            t = 'soon'                         # not a number: time 0
        lines.append(f'u{u:02d}\ti{i:02d}\t{review}\t{t}\t{j % 5}')
    (root / 'reviews_text.tsv').write_text('\n'.join(lines) + '\n')
    meta = ['asin\ttitle\tyear\tprice\tinstock']
    for i in range(n_items - 2):
        title = f'"title {i}, ""quoted"""' if i % 3 == 0 else f'title {i}'
        year = '' if i == 4 else str(1990 + i)
        price = '' if i == 5 else f'{i * 1.25}'
        stock = ('True', 'False', '')[i % 3]
        if i == 6:
            title = 'NA'
        meta.append(f'i{i:02d}\t{title}\t{year}\t{price}\t{stock}')
    meta.append('i03\ttitle 3 again\t2001\t3.5\tTrue')
    (root / 'meta_synced.tsv').write_text('\n'.join(meta) + '\n')


@pytest.fixture(scope='module')
def edge_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp('edge') / 'edge'
    _write_edge_case_data(root)
    return root


@pytest.mark.parametrize('mode', ['fixed', 'compat'])
def test_load_ltr_data_matches_jax_on_edge_cases(edge_dir, mode):
    """Against the JAX loader under pandas' object-dtype strings (its
    behaviour before pandas 3; see the next test), both popularity
    modes."""
    jc, tc = _configs(edge_dir, popularity_mode=mode)
    with pd.option_context('future.infer_string', False):
        a = jax_text.load_ltr_data(jc)
    b = text.load_ltr_data(tc)
    _assert_same_data(a, b)
    assert len(np.unique(b.popularity_items)) > 3
    # the review cache the JAX package wrote was read, not re-encoded
    npy = os.path.join(str(edge_dir), 'embeddings',
                       'item_full_reviews_loss_repr_all-MiniLM-L6-v2_0-seed'
                       '.npy')
    assert os.path.exists(npy + '.meta')


def test_meta_rendering_and_the_pandas_3_deviation(edge_dir):
    """The port renders a missing meta field as ``'nan'`` (pandas before
    3).  Under pandas 3's default string dtype the JAX loader's
    ``astype(str)`` keeps it missing and the whole item text becomes
    ``''``: the port differs from it exactly on the items with a missing
    field, and agrees on the others."""
    from textgcn_tpu_torch.data.core import load_interactions
    _, tc = _configs(edge_dir)
    base = load_interactions(tc.data)
    texts = text._item_texts(base, tc)
    by_ext = {base.item_id_map[i]: t for i, t in enumerate(texts)}
    # year has a gap: a float column; instock has one too: the text
    assert by_ext['i00'] == ('title 0, "quoted" [SEP] 1990.0 [SEP] 0.0 '
                             '[SEP] True')
    assert by_ext['i03'] == ('title 3 again [SEP] 2001.0 [SEP] 3.5 [SEP] '
                             'True')
    assert by_ext['i04'] == 'title 4 [SEP] nan [SEP] 5.0 [SEP] False'
    assert by_ext['i06'] == 'nan [SEP] 1996.0 [SEP] 7.5 [SEP] True'
    assert by_ext['i10'] == by_ext['i11'] == ''
    jc, _ = _configs(edge_dir)
    jbase = jax_text.load_interactions(jc.data)
    kg = pd.read_table(os.path.join(jc.data, 'meta_synced.tsv')).set_index(
        'asin')
    cols = list(kg.columns)
    joined = kg[cols[0]].astype(str)
    for c in cols[1:]:
        joined = joined + ' [SEP] ' + kg[c].astype(str)
    jtexts = jbase.item_mapping['org_id'].map(joined.to_dict()).fillna('')
    missing = {'i02', 'i04', 'i05', 'i06', 'i08'}   # a field is empty
    for ext, t in zip(jbase.item_mapping['org_id'], jtexts):
        if ext in missing and pd.__version__ >= '3':
            assert t == '' and by_ext[ext].count('nan') >= 1
        else:
            assert t == by_ext[ext], ext


def test_numeric_asins_match_no_item(tmp_path, dummy_dir):
    shutil.copytree(dummy_dir, tmp_path / 'd')
    meta = tmp_path / 'd' / 'meta_synced.tsv'
    meta.write_text('asin\ttitle\n1\tone\n2\ttwo\n')
    from textgcn_tpu_torch.data.core import load_interactions
    _, tc = _configs(tmp_path / 'd')
    assert set(text._item_texts(load_interactions(tc.data), tc)) == {''}


def test_nargsort_is_pandas_order():
    rng = np.random.RandomState(3)
    for dtype in (np.int64, np.float64):
        t = rng.randint(0, 5, 300).astype(dtype)
        want = pd.Series(t).sort_values(ascending=False).index.to_numpy()
        np.testing.assert_array_equal(text._nargsort_desc(t), want)


# --- the models ----------------------------------------------------------------

def _jax_hash_weights(op, w_pairs):
    out = []
    for salt, keep in w_pairs:
        w = op.w_u * jax_scale(op.eu_u, op.ei_u, jnp.uint32(salt),
                               jnp.float32(keep))
        out.append((w, w[op.perm_u2i]))
    (wu1, wi1), (wu2, wi2) = out
    return (wu1, wi1), (wi2, wu2)


def _pair_models(ltr_data, dummy_copy, name, layers, freeze=False):
    """The JAX model with params, and the port model loaded from them."""
    jcls, tcls = MODELS[name]
    jc, tc = _configs(dummy_copy, model=name, ltr_layers=layers,
                      freeze=freeze)
    jd, td = ltr_data
    jm = jcls(jc, jd)
    plain = jm.graph_op.weights
    jm.graph_op.weights = lambda key, dropout: (
        _jax_hash_weights(jm.graph_op, PAIRS) if dropout > 0
        else plain(key, dropout))
    rng = np.random.RandomState(len(layers) + len(name))
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(3)))
    params['user_emb'] = (0.3 * rng.randn(*params['user_emb'].shape)
                          ).astype(np.float32)
    params['item_emb'] = (0.3 * rng.randn(*params['item_emb'].shape)
                          ).astype(np.float32)
    tm = tcls(tc, td, device='cpu')
    tm.load_params(params_from_jax(params, td.n_users, td.n_items))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _batch(data, seed=5, b=9, n_neg=2):
    rng = np.random.RandomState(seed)
    users = rng.randint(0, data.n_users, b)
    pos = np.array([data.pos_padded[u][rng.randint(data.pos_degree[u])]
                    for u in users])
    return users, pos, rng.randint(0, data.n_items, (b, n_neg))


CASES = [(name, layers) for name in MODELS for layers in ((), (4, 2))]


@pytest.mark.parametrize('name, layers', CASES)
def test_ltr_loss_grads_and_scores_match_jax(ltr_data, dummy_copy, name,
                                             layers):
    jm, jp, tm = _pair_models(ltr_data, dummy_copy, name, layers)
    batch = _batch(ltr_data[1])
    users, pos, negs = (jnp.asarray(a, jnp.int32) for a in batch)
    jb = (users, pos, negs, jnp.ones(users.shape[0], bool))
    (loss, aux), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, jb, jax.random.key(0))
    tb = tuple(torch.from_numpy(a.astype(np.int64)) for a in batch)
    t_loss, t_aux = tm.loss(tb, w_pairs=PAIRS)
    t_loss.backward()
    t_loss = t_loss.detach()
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-5,
                               atol=1e-6)
    for c in ('bpr', 'reg'):
        np.testing.assert_allclose(float(t_aux[c]), float(aux[c]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.user_emb.grad.numpy(),
                               np.asarray(grads['user_emb']), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tm.item_emb.grad.numpy(),
                               np.asarray(grads['item_emb']), atol=1e-5,
                               rtol=1e-4)
    tree = params_to_jax({'user_emb': tm.user_emb, 'item_emb': tm.item_emb,
                          'tower': [{'w': lin.weight.grad.T,
                                     'b': lin.bias.grad}
                                    for lin in tm.tower]})
    for got, want in zip(tree['tower'], grads['tower']):
        for k in ('w', 'b'):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-5, rtol=1e-4)
    # pairwise head scores of the propagated rows (eval mode)
    with torch.no_grad():
        ur, ir = tm.representation()
        got = tm.score_pairwise(ur[tb[0]], ir[tb[1]], tb[0], tb[1])
    jur, jir = jm.representation(jp, training=False)
    want = jm.score_pairwise(jp, None, jur[users], jir[pos], users, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert spmm_dropout_cuda.launches == 0


@pytest.mark.parametrize('name, layers', CASES)
def test_fused_catalogue_topk_and_factors_match_jax(ltr_data, dummy_copy,
                                                    name, layers):
    jm, jp, tm = _pair_models(ltr_data, dummy_copy, name, layers)
    n_users = ltr_data[1].n_users
    users = np.arange(n_users)
    jreprs = jm.representation(jp, training=False)
    want = np.asarray(jm.fused_batch_scores(jp, jreprs,
                                            jnp.asarray(users, jnp.int32)))
    want_v, want_i = jm.topk_for_users(jp, jreprs,
                                       jnp.asarray(users, jnp.int32), 5)
    ju, ji, jbias = jm.fused_catalog_inputs(jp, jreprs,
                                            jnp.asarray(users, jnp.int32))
    tu = torch.from_numpy(users)
    with torch.no_grad():
        reprs = tm.scoring_reprs()
        got = tm.score_batchwise(reprs, tu).numpy()
        vals, idx = tm.topk_for_users(reprs, tu, 5)
        # the reference's way: (B, n_items, F) features, uncollapsed tower
        ur, ir = reprs
        items = torch.arange(tm.n_items)
        feats = tm.features_pairwise(
            ur[tu][:, None, :].expand(-1, tm.n_items, -1),
            ir[items][None].expand(n_users, -1, -1),
            tu[:, None].expand(-1, tm.n_items), items[None].expand(
                n_users, -1))
        naive = tm.apply_tower(feats).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(naive, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), atol=1e-5,
                               rtol=0)
    v = np.asarray(want_v)
    apart = np.array([[np.sum(np.abs(row - x) < 1e-4) == 1 for x in row]
                      for row in v]) & np.isfinite(v)
    assert (idx.numpy()[apart] == np.asarray(want_i)[apart]).all()
    with torch.no_grad():
        u_cat, i_cat, bias = tm.fused_catalog_inputs(reprs, tu)
    np.testing.assert_allclose(u_cat.numpy(), np.asarray(ju), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(i_cat.numpy(), np.asarray(ji), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(float(bias), float(jbias), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize('layers', [(), (4, 2), (3,)])
def test_collapse_tower_matches_jax_and_the_tower(layers):
    rng = np.random.RandomState(len(layers))
    sizes = [7, *layers, 1]
    tower = [{'w': rng.randn(i, j).astype(np.float32),
              'b': rng.randn(j).astype(np.float32)}
             for i, j in zip(sizes, sizes[1:])]
    lins = torch.nn.ModuleList()
    for layer in tower:
        lin = torch.nn.Linear(*layer['w'].shape)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(layer['w'].T))
            lin.bias.copy_(torch.from_numpy(layer['b']))
        lins.append(lin)
    w, b = collapse_tower(lins)
    jw, jb = jax_collapse_tower(jax.tree.map(jnp.asarray, tower))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(b), float(jb), atol=1e-5, rtol=1e-5)
    x = torch.from_numpy(rng.randn(6, 7).astype(np.float32))
    full = x
    for lin in lins:
        full = lin(full)
    np.testing.assert_allclose((x @ w + b).detach().numpy(),
                               full[:, 0].detach().numpy(), atol=1e-5)


def test_tower_init_is_seeded_uniform(ltr_data, dummy_copy):
    _, tc = _configs(dummy_copy, model='ltr_pop', ltr_layers=(4,))
    a = LTRLinearWPop(tc, ltr_data[1], device='cpu')
    b = LTRLinearWPop(tc, ltr_data[1], device='cpu')
    assert [tuple(lin.weight.shape) for lin in a.tower] == [(4, 7), (1, 4)]
    for la, lb in zip(a.tower, b.tower):
        assert torch.equal(la.weight, lb.weight)
        assert float(la.weight.abs().max()) <= 1.0 / np.sqrt(
            la.weight.shape[1])
    tree = params_to_jax(a.param_tree())
    assert [layer['w'].shape for layer in tree['tower']] == [(7, 4), (4, 1)]


def test_freeze_moves_the_tower_as_optax_and_keeps_the_tables(
        ltr_data, dummy_copy):
    """Three Adam steps with ``--freeze``: the tables stay bit-unchanged
    and the tower follows optax's ``multi_transform`` (adam on the tower,
    ``set_to_zero`` on the tables) within 1e-5."""
    jm, jp, tm = _pair_models(ltr_data, dummy_copy, 'ltr_linear', (4,),
                              freeze=True)
    jc, tc = _configs(dummy_copy, model='ltr_linear', ltr_layers=(4,),
                      freeze=True)
    labels = jax.tree.map(lambda t: 'train' if t else 'frozen',
                          jm.trainable_mask(jp))
    opt = optax.multi_transform({'train': optax.adam(tc.lr),
                                 'frozen': optax.set_to_zero()}, labels)
    state = opt.init(jp)
    tr = Trainer(tc, tm, ltr_data[1])
    assert {id(p) for p in tr.optimizer.param_groups[0]['params']} == {
        id(p) for p in tm.tower.parameters()}
    tables = (tm.user_emb.detach().clone(), tm.item_emb.detach().clone())
    tower0 = [lin.weight.detach().clone() for lin in tm.tower]
    for step in range(3):
        batch = _batch(ltr_data[1], seed=step)
        users, pos, negs = (jnp.asarray(a, jnp.int32) for a in batch)
        grads = jax.grad(lambda p: jm.loss(p, (
            users, pos, negs, jnp.ones(users.shape[0], bool)),
            jax.random.key(0))[0])(jp)
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        tr.train_step(tuple(torch.from_numpy(a.astype(np.int64))
                            for a in batch), PAIRS)
    assert torch.equal(tm.user_emb, tables[0])
    assert torch.equal(tm.item_emb, tables[1])
    np.testing.assert_array_equal(np.asarray(jp['user_emb']),
                                  tables[0].numpy())
    # the weights; not the biases: a bias adds the same to a positive's
    # and a negative's score, so BPR's gradient of it is rounding noise
    # (~1e-9), which Adam scales up to steps of ~lr on either side
    got = params_to_jax(tm.param_tree())['tower']
    for g, w in zip(got, jp['tower']):
        np.testing.assert_allclose(g['w'], np.asarray(w['w']), atol=1e-5,
                                   rtol=0)
    assert all(not torch.equal(w0, lin.weight)
               for w0, lin in zip(tower0, tm.tower))


# --- the CLI -------------------------------------------------------------------

def _base_checkpoint(path, data, seed=4):
    rng = np.random.RandomState(seed)
    params = {'user_emb': (0.3 * rng.randn(data.n_users, D)).astype(
        np.float32), 'item_emb': (0.3 * rng.randn(data.n_items, D)).astype(
        np.float32)}
    with open(path, 'wb') as f:
        pickle.dump({'params': params, 'epoch': 3, 'model': 'lgcn'}, f)
    return params


def test_load_base_evaluates_the_base_as_lgcn_through_both_clis(
        tmp_path, monkeypatch, dummy_copy, ltr_data):
    """``--load_base`` evaluates the loaded base with plain scoring: the
    metrics of ``lgcn --load`` on the same checkpoint, in the port and in
    the JAX package; then the head scores, and the tower kept its init."""
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu.train.trainer import Trainer as JaxTrainer
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    ck = str(tmp_path / 'base.pkl')
    params = _base_checkpoint(ck, ltr_data[1])
    common = ['--data', dummy_copy, '--emb_size', str(D), '-k', '3', '5',
              '--batch_size', '16', '--no_train', '--quiet']
    lgcn = port_main(['--model', 'lgcn', '--load', ck, '--uid', 'l']
                     + common)
    ltr = port_main(['--model', 'ltr_linear', '--load_base', ck, '--freeze',
                     '--uid', 'b'] + common)
    jax_metrics = []
    evaluate = JaxTrainer.evaluate
    monkeypatch.setattr(JaxTrainer, 'evaluate', lambda self, epoch=None: (
        jax_metrics.append(evaluate(self, epoch)) or jax_metrics[-1]))
    jax_main(['--model', 'ltr_linear', '--load_base', ck, '--freeze',
              '--uid', 'j'] + common)
    for name, want in lgcn.last_metrics.items():
        np.testing.assert_allclose(ltr.last_metrics[name], want, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(jax_metrics[0][name], want, atol=1e-6,
                                   rtol=0)
    assert ltr.model.score_with_head
    np.testing.assert_array_equal(ltr.model.user_emb.numpy(),
                                  params['user_emb'])
    fresh = LTRLinear(ltr.cfg, ltr_data[1], device='cpu')
    assert torch.equal(ltr.model.tower[0].weight, fresh.tower[0].weight)


@pytest.mark.parametrize('model', ['ltr_linear', 'ltr_pop'])
def test_cli_trains_frozen_ltr_and_jax_loads_it(tmp_path, monkeypatch,
                                               dummy_copy, ltr_data, model):
    """``--load_base --freeze`` trains, checkpoints, predicts and exports;
    the tables stay the base's, the JAX package's ``--load`` of
    ``best.pkl`` reproduces the port's metrics, and the exported factors
    give the head's scores."""
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    ck = str(tmp_path / 'base.pkl')
    params = _base_checkpoint(ck, ltr_data[1], seed=6)
    common = ['--model', model, '--data', dummy_copy, '--emb_size', str(D),
              '-k', '3', '5', '--batch_size', '16', '--quiet',
              '--ltr_layers', '3']
    pt = port_main(common + ['--load_base', ck, '--freeze', '--epochs', '4',
                             '--evaluate_every', '2', '--predict',
                             '--export_reprs', '--uid', 'port'])
    run = tmp_path / 'runs' / 'dummy' / 'port'
    assert {'best.pkl', 'latest_checkpoint.pkl', 'resume_state.pkl',
            'predictions.tsv', 'users_repr.npy', 'items_repr.npy',
            'ltr_user_factors.npy', 'ltr_item_factors.npy',
            'ltr_bias.npy'} <= {p.name for p in run.iterdir()}
    assert all(np.isfinite(h['loss']) for h in pt.loss_history)
    np.testing.assert_array_equal(pt.model.user_emb.numpy(),
                                  params['user_emb'])
    jt = jax_main(common + ['--no_train', '--load', str(run), '--uid',
                            'jax'])
    got = jt.evaluate()
    for name, want in pt.last_metrics.items():
        np.testing.assert_allclose(got[name], want, atol=1e-6, rtol=0)
    u = np.load(run / 'ltr_user_factors.npy')
    i = np.load(run / 'ltr_item_factors.npy')
    b = np.load(run / 'ltr_bias.npy')
    with torch.no_grad():
        want = pt.model.score_batchwise(pt.model.scoring_reprs(),
                                        torch.arange(pt.model.n_users))
    np.testing.assert_allclose(u @ i.T + b, want.numpy(), atol=1e-5)


@pytest.mark.parametrize('argv, n_warnings', [
    (['--model', 'ltr_linear'], 2),
    (['--model', 'ltr_pop', '--freeze'], 1),
    (['--model', 'ltr_linear', '--load_base', 'x', '--freeze'], 0),
    (['--model', 'ltr_pop', '--load', 'x'], 1),
    (['--model', 'lgcn'], 0),
])
def test_warn_footguns_says_what_jax_says(argv, n_warnings):
    argv = argv + ['--uid', 'same']
    from textgcn_tpu.config import parse_args as jax_parse
    got = tconfig.warn_footguns(tconfig.parse_args(argv))
    assert got == jax_warn_footguns(jax_parse(argv))
    assert len(got) == n_warnings


@pytest.mark.parametrize('model', ['ltr_linear', 'ltr_pop'])
def test_ltr_on_a_mesh_is_refused(model):
    """No LTR head refuses a mesh any more: the two heads run on one
    (``tests/test_torch_mesh_ltr.py``), and so do the concat scorers
    (``tests/test_torch_mesh_text.py``) and the boosted heads beside them
    (``tests/test_torch_mesh_boosted.py``); a malformed mesh is refused
    for each."""
    for name in (model, 'gbdt', 'gbdt_pop', 'marcus'):
        assert tconfig.parse_args(['--model', name, '--mesh', '1x1']).mesh
        with pytest.raises(ValueError, match='--mesh'):
            tconfig.parse_args(['--model', name, '--mesh', '1by1'])
