"""The port's text-loss family (``text``, ``kg``, ``reviews``,
``text_probe``) and the loader's per-(item, user) review vectors against
the JAX package's, on the CPU.

The models take the same params, batches and dropout salts (the JAX side
through its exact-f32 XLA op with the hash weights), on ``data/dummy``
with its checked-in embedding caches (a copy in ``tmp_path``).

Tolerances: the review-pair arrays bit for bit; ``semantic_loss`` 1e-5;
one step's loss, its components and gradients 1e-4 (gradients 1e-5
absolute); the ``--pos user`` lookup exactly; the probe's metrics 1e-6; a
served JAX checkpoint's metrics 1e-6.
"""

import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ltr import (_base_checkpoint, _batch, _configs,
                            _jax_hash_weights, _write_edge_case_data)
from textgcn_tpu.data import text as jax_text
from textgcn_tpu.models import text_loss as jax_tl
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data import text
from textgcn_tpu_torch.models import text_loss as tl
from textgcn_tpu_torch.ops import spmm as spmm_mod
from textgcn_tpu_torch.weights import params_from_jax

SALT = 0x9E3779B9
KEEP = float(np.float32(1.0 - 0.4))
PAIRS = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))
PAIR_FIELDS = ('review_pair_items', 'review_pair_users',
               'review_pair_item_ptr', 'review_pair_vectors')
MODELS = {'text': (jax_tl.TextModel, tl.TextModel),
          'kg': (jax_tl.TextModelKG, tl.TextModelKG),
          'reviews': (jax_tl.TextModelReviews, tl.TextModelReviews)}


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@pytest.fixture(scope='module')
def dummy_copy(tmp_path_factory, dummy_dir):
    out = tmp_path_factory.mktemp('text') / 'dummy'
    shutil.copytree(dummy_dir, out)
    return str(out)


@pytest.fixture(scope='module')
def ltr_data(dummy_copy):
    jc, tc = _configs(dummy_copy)
    return jax_text.load_ltr_data(jc), text.load_ltr_data(tc)


@pytest.fixture(scope='module')
def edge_data(tmp_path_factory):
    """The LTR edge-case dataset (pairs reviewed twice, reviews of test
    edges) through both loaders, pandas' object-dtype strings for JAX."""
    root = tmp_path_factory.mktemp('edge') / 'edge'
    _write_edge_case_data(root)
    jc, tc = _configs(root)
    with pd.option_context('future.infer_string', False):
        a = jax_text.load_ltr_data(jc)
    return root, a, text.load_ltr_data(tc)


def _pair(data, dummy_copy, name, seed=0, **kw):
    """The JAX model with params and the port model loaded from them."""
    jcls, tcls = MODELS[name]
    jc, tc = _configs(dummy_copy, model=name, **kw)
    jd, td = data
    jm = jcls(jc, jd)
    jm.graph_op.weights = lambda key, dropout: _jax_hash_weights(
        jm.graph_op, PAIRS)
    rng = np.random.RandomState(seed)
    params = {'user_emb': (0.3 * rng.randn(td.n_users, tc.emb_size)
                           ).astype(np.float32),
              'item_emb': (0.3 * rng.randn(td.n_items, tc.emb_size)
                           ).astype(np.float32)}
    tm = tcls(tc, td, device='cpu')
    tm.load_params(params_from_jax(params, td.n_users, td.n_items))
    return jm, jax.tree.map(jnp.asarray, params), tm


# --- the loader --------------------------------------------------------------

@pytest.mark.parametrize('which', ['dummy', 'edge'])
def test_review_pair_arrays_are_the_jax_ones(which, ltr_data, edge_data):
    a, b = ltr_data if which == 'dummy' else edge_data[1:]
    for f in PAIR_FIELDS:
        got, want = getattr(b, f), getattr(a, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    if which == 'edge':
        keys = b.review_pair_items * b.n_users + b.review_pair_users
        assert (np.diff(keys) >= 0).all() and (np.diff(keys) == 0).any()


def test_pos_user_lookup_matches_jax_with_missing_pairs(edge_data):
    """Every (item, user) pair: a pair reviewed twice gives the first
    review, a pair never reviewed in train gives zeros."""
    root, jd, td = edge_data
    jc, tc = _configs(root, model='text', pos='user')
    jm = jax_tl.TextModel(jc, jd)
    tm = tl.TextModel(tc, td, device='cpu')
    assert tm.pos_mode == 'user'
    items, users = np.meshgrid(np.arange(td.n_items), np.arange(td.n_users))
    items, users = items.ravel(), users.ravel()
    want = np.asarray(jm._item_reviews_user(jnp.asarray(items, jnp.int32),
                                            jnp.asarray(users, jnp.int32)))
    got = tm.item_reviews_user(torch.from_numpy(items),
                               torch.from_numpy(users)).numpy()
    np.testing.assert_array_equal(got, want)
    missing = ~np.abs(want).any(axis=1)
    assert 0 < missing.sum() < len(missing)


# --- the semantic loss -------------------------------------------------------

SEM_CASES = [(w, d, f) for w in tl.WEIGHT_FORMULAS
             for d in tl.DISTANCE_FORMULAS for f in tl.DIST_FNS]


@pytest.fixture(scope='module')
def sem_models(ltr_data, dummy_copy):
    return _pair(ltr_data, dummy_copy, 'text', seed=1)


@pytest.mark.parametrize('weight, distance, dist_fn', SEM_CASES)
def test_semantic_loss_matches_jax(sem_models, ltr_data, weight, distance,
                                   dist_fn):
    """Every formula of the three tables, over two negative columns (the
    JAX package's per-column terms averaged)."""
    jm, jp, tm = sem_models
    for m, table in ((jm, jax_tl), (tm, tl)):
        m.weight_formula = table.WEIGHT_FORMULAS[weight]
        m.distance_formula = table.DISTANCE_FORMULAS[distance]
        m.dist_fn = table.DIST_FNS[dist_fn]
    users, pos, negs = _batch(ltr_data[1], seed=2)
    rng = np.random.RandomState(3)
    pos_s = rng.randn(len(users)).astype(np.float32)
    neg_s = rng.randn(*negs.shape).astype(np.float32)
    mask = np.ones(len(users), bool)
    mask[-2:] = False
    want = np.mean([float(jm.semantic_loss(
        jp, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(negs[:, j]),
        jnp.asarray(pos_s), jnp.asarray(neg_s[:, j]), jnp.asarray(mask)))
        for j in range(negs.shape[1])])
    got = tm.semantic_loss(*(torch.from_numpy(a) for a in (
        users, pos, negs, pos_s, neg_s, mask)))
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5,
                               atol=1e-6)


def test_unknown_formulas_raise_as_in_jax(ltr_data, dummy_copy):
    for flag in ('weight', 'distance', 'dist_fn'):
        jc, tc = _configs(dummy_copy, model='kg', **{flag: 'nope'})
        with pytest.raises(KeyError):
            jax_tl.TextModelKG(jc, ltr_data[0])
        with pytest.raises(KeyError, match='nope'):
            tl.TextModelKG(tc, ltr_data[1], device='cpu')


# --- one step ----------------------------------------------------------------

STEP_CASES = [('text', {'pos': p, 'neg': n}) for p in ('avg', 'user', 'kg')
              for n in ('avg', 'kg')] + [('kg', {}), ('reviews',
                                                      {'pos': 'user'})]


@pytest.mark.parametrize('name, kw', STEP_CASES,
                         ids=[f'{n}-{"-".join(kw.values()) or "default"}'
                              for n, kw in STEP_CASES])
def test_one_step_matches_jax(ltr_data, dummy_copy, name, kw):
    """``reviews`` reads ``avg`` whatever ``--pos`` says; ``text`` reads
    ``--pos`` and ``--neg``."""
    jm, jp, tm = _pair(ltr_data, dummy_copy, name, weight='(p-n)',
                       distance='selu(g-b)', **kw)
    if name == 'reviews':
        assert tm.pos_mode == jm.pos_mode == 'avg'
    elif name == 'text':
        assert (tm.pos_mode, tm.neg_mode) == (kw['pos'], kw['neg'])
    batch = _batch(ltr_data[1], seed=7)
    users, pos, negs = (jnp.asarray(a, jnp.int32) for a in batch)
    (loss, aux), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, (users, pos, negs, jnp.ones(users.shape[0], bool)),
        jax.random.key(0))
    t_loss, t_aux = tm.loss(tuple(torch.from_numpy(a.astype(np.int64))
                                  for a in batch), w_pairs=PAIRS)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(loss),
                               rtol=1e-4, atol=1e-6)
    for c in ('bpr', 'sem', 'reg'):
        np.testing.assert_allclose(float(t_aux[c].detach()), float(aux[c]),
                                   rtol=1e-4, atol=1e-7)
    for n in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(getattr(tm, n).grad.numpy(),
                                   np.asarray(grads[n]), atol=1e-5,
                                   rtol=1e-4)


# --- the probe and serving ---------------------------------------------------

def test_text_probe_matches_jax_and_propagates_nothing(ltr_data, dummy_copy,
                                                      monkeypatch):
    from textgcn_tpu.models.lightgcn import LightGCN as JaxLightGCN
    from textgcn_tpu.train.trainer import Trainer as JaxTrainer
    from textgcn_tpu_torch.models.lightgcn import LightGCN
    from textgcn_tpu_torch.train.trainer import Trainer
    jc, tc = _configs(dummy_copy, model='text_probe')
    jd, td = ltr_data
    want = jax_tl.probe_text_representations(
        jc, jd, JaxTrainer(jc, JaxLightGCN(jc, jd), jd))
    calls = []
    spmm = spmm_mod.spmm
    monkeypatch.setattr(spmm_mod, 'spmm', lambda *a: calls.append(1)
                        or spmm(*a))
    model = LightGCN(tc, td, device='cpu')
    got = tl.probe_text_representations(td, Trainer(tc, model, td))
    assert not calls
    assert list(got) == list(want) == list(tl.TEXT_COMBOS)
    for combo, metrics in want.items():
        for name, v in metrics.items():
            np.testing.assert_allclose(got[combo][name], v, atol=1e-6,
                                       rtol=0, err_msg=f'{combo} {name}')
    assert 'representation' not in model.__dict__


def test_a_jax_kg_checkpoint_serves_the_same_metrics(tmp_path, monkeypatch,
                                                     dummy_copy, ltr_data):
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    ck = str(tmp_path / 'kg.pkl')
    _base_checkpoint(ck, ltr_data[1], seed=9)
    argv = ['--model', 'kg', '--data', dummy_copy, '--emb_size', '16', '-k',
            '3', '5', '--no_train', '--load', ck, '--quiet']
    got = port_main(argv + ['--uid', 'p']).last_metrics
    want = jax_main(argv + ['--uid', 'j']).evaluate()
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, atol=1e-6, rtol=0)
