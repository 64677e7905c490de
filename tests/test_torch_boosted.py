"""The port's boosted tree heads (``gbdt``, ``gbdt_pop``, ``xgboost``,
``xgboost_pop``, ``marcus``) against the JAX package's, on the CPU, on a
copy of ``data/dummy`` with the stub text encoder.

The JAX side runs once per model in a module fixture: its CLI with
``--load_base`` of one pickle and ``--predict`` (scikit-learn fits its
trees; without xgboost every head takes that path).  Then:

* ``batch_features`` equals the JAX package's within 1e-6;
* ``marcus``'s sampled rows (users, items, labels) equal the JAX
  package's bit for bit, its fit matrix is ``(n_train * (1 + neg), F)``;
* the JAX fit, carried across by ``weights.forest_from_estimator``,
  serves the JAX package's metrics (1e-6) and the same
  ``predictions.tsv`` bytes;
* the port's own fit equals scikit-learn's on the port's features up to
  the first tree where scikit-learn's random feature order decides a tie
  (the dummy data's 120 rows make tiny nodes, where two features often
  split alike; from there on the carried case above holds the scoring);
* ``forest.npz`` round-trips through ``--load RUN --no_train``, a JAX
  run's ``tree.pkl`` serves its metrics and predictions through the
  port's restricted unpickler, and a tree head exports no LTR factors.

The heads on ``--mesh`` are ``tests/test_torch_mesh_boosted.py``'s.
"""

import contextlib
import logging
import os
import pickle
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.ensemble import GradientBoostingRegressor

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.models import ltr_boosted
from textgcn_tpu_torch.ops import trees
from textgcn_tpu_torch.train.checkpoint import load_forest
from textgcn_tpu_torch.weights import forest_from_estimator

D = 16
BOOSTED = ('gbdt', 'gbdt_pop', 'xgboost', 'xgboost_pop', 'marcus')
JAX_RUNS = ('gbdt', 'gbdt_pop', 'marcus')
STRUCTURE = ('children_left', 'children_right', 'feature', 'threshold',
             'n_node_samples')


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@contextlib.contextmanager
def _cpu_run_in(path):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(path)
        mp.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
        yield


@pytest.fixture(scope='module')
def workdir(tmp_path_factory, dummy_dir):
    """A directory with a copy of data/dummy (``dummy``) and an ``lgcn``
    base pickle in the JAX package's format (``base.pkl``)."""
    root = tmp_path_factory.mktemp('boosted')
    shutil.copytree(dummy_dir, root / 'dummy')
    from textgcn_tpu_torch.data.core import load_interactions
    data = load_interactions(str(root / 'dummy'))
    rng = np.random.RandomState(4)
    params = {'user_emb': (0.3 * rng.randn(data.n_users, D)).astype(
        np.float32), 'item_emb': (0.3 * rng.randn(data.n_items, D)).astype(
        np.float32)}
    with open(root / 'base.pkl', 'wb') as f:
        pickle.dump({'params': params, 'epoch': 3, 'model': 'lgcn'}, f)
    return root


def _argv(model, uid, *extra):
    return ['--model', model, '--data', 'dummy', '--emb_size', str(D),
            '-k', '3', '5', '--batch_size', '16', '--uid', uid, '--quiet',
            *extra]


@pytest.fixture(scope='module')
def jax_runs(workdir):
    """``{model: (JAX BoostedTrainer, run dir)}`` of the JAX CLI with
    ``--load_base base.pkl --predict``."""
    from textgcn_tpu.cli import main as jax_main
    out = {}
    with _cpu_run_in(workdir):
        for model in JAX_RUNS:
            trainer = jax_main(_argv(model, f'jax-{model}', '--load_base',
                                     'base.pkl', '--predict'))
            out[model] = (trainer, str(workdir / trainer.cfg.save_path))
    return out


def _port_loaded(workdir, model, uid):
    """The port's CLI with ``--load_base base.pkl --no_train``: the base
    evaluated, no trees."""
    from textgcn_tpu_torch.cli import main as port_main
    with _cpu_run_in(workdir):
        return port_main(_argv(model, uid, '--load_base', 'base.pkl',
                               '--no_train'))


@pytest.mark.parametrize('model', ['gbdt', 'gbdt_pop'])
def test_batch_features_match_jax(model, workdir, jax_runs):
    jt, _ = jax_runs[model]
    jm = jt.model
    users = np.arange(jm.n_users, dtype=np.int32)
    reprs = jm.compute_reprs(jt.inner.params)
    want = np.asarray(jm._batch_features_fn()(
        jt.inner.params, reprs, jm.captured_state(), jnp.asarray(users)))
    pm = _port_loaded(workdir, model, f'feat-{model}').model
    got = pm.batch_features(pm.compute_reprs(), torch.from_numpy(
        users.astype(np.int64))).numpy()
    assert got.shape == want.shape == (jm.n_users, jm.n_items,
                                       pm.n_features)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('neg_samples', [1, 3])
def test_marcus_rows_match_jax(neg_samples, workdir):
    """The JAX package's rows, recorded where its fit takes them: the
    pairs its feature function is called on and the labels its tree is
    fitted on."""
    from textgcn_tpu.config import Config as JaxConfig
    from textgcn_tpu.data.text import load_ltr_data as jax_load
    from textgcn_tpu.models.ltr_boosted import MarcusGradientBoosted
    common = dict(model='marcus', data=str(workdir / 'dummy'), emb_size=D,
                  neg_samples=neg_samples, seed=7, save_path='/nonexistent')
    jdata = jax_load(JaxConfig(**common).finalize())
    jm = MarcusGradientBoosted(JaxConfig(**common).finalize(), jdata)
    seen = {'u': [], 'i': []}

    def record_pairs(cap, reprs, users, items):
        seen['u'].append(np.asarray(users))
        seen['i'].append(np.asarray(items))
        return jnp.zeros((len(users), jm.n_features), jnp.float32)

    class RecordFit:
        def fit(self, x, y, group=None):
            self.x, self.y, self.group = x, y, group

    jm._jit_cache = {'pairwise_features': record_pairs}   # _jitted's cache
    jm.tree = RecordFit()
    jm.fit_trees(jm.init_params(jax.random.key(0)), jdata.pos_padded,
                 jdata.pos_degree)

    from textgcn_tpu_torch.data.text import load_ltr_data
    cfg = tconfig.Config(save=False, **common).finalize()
    data = load_ltr_data(cfg)
    pm = ltr_boosted.MarcusGradientBoosted(cfg, data, device='cpu')
    users, items, y = pm.sample_rows(data.pos_padded, data.pos_degree)
    np.testing.assert_array_equal(users, np.concatenate(seen['u']))
    np.testing.assert_array_equal(items, np.concatenate(seen['i']))
    np.testing.assert_array_equal(y, jm.tree.y)
    n_train = int(data.pos_degree.sum())
    assert len(y) == n_train * (1 + max(1, neg_samples))
    assert jm.tree.x.shape == (len(y), pm.n_features)
    x = pm.pair_features(pm.compute_reprs(), torch.from_numpy(users).long(),
                         torch.from_numpy(items).long())
    assert tuple(x.shape) == (n_train * (1 + neg_samples), pm.n_features)


@pytest.mark.parametrize('model', JAX_RUNS)
def test_carried_forest_serves_jax_metrics_and_predictions(model, workdir,
                                                          jax_runs):
    jt, jax_dir = jax_runs[model]
    want = {m: v[-1] for m, v in jt.inner.metrics_logger.items()}
    pt = _port_loaded(workdir, model, f'carried-{model}')
    pt.model.forest_state = forest_from_estimator(jt.model.tree)
    got = pt.evaluate(1)
    for name, values in want.items():
        np.testing.assert_allclose(got[name], values, rtol=0, atol=1e-6,
                                   err_msg=name)
    with _cpu_run_in(workdir):
        pt.predict(range(pt.data.n_users), with_scores=True, save=True)
    with open(os.path.join(jax_dir, 'predictions.tsv'), 'rb') as f:
        jax_bytes = f.read()
    with open(os.path.join(workdir, pt.cfg.save_path, 'predictions.tsv'),
              'rb') as f:
        assert f.read() == jax_bytes


@pytest.mark.parametrize('model', ['gbdt', 'gbdt_pop'])
def test_own_fit_matches_sklearn_up_to_the_first_tie(model, workdir):
    pm = _port_loaded(workdir, model, f'own-{model}').model
    pm.fit_trees(pm.pos_padded, pm.pos_degree)
    users = torch.arange(pm.n_users)
    x = pm.batch_features(pm.compute_reprs(), users).reshape(
        -1, pm.n_features).numpy()
    y = pm.labels(users, pm.pos_padded, pm.pos_degree).reshape(-1).numpy()
    fits = [[e.tree_ for e in GradientBoostingRegressor(
        n_estimators=10, max_depth=3, random_state=rs).fit(
            x, y).estimators_.reshape(-1)] for rs in range(6)]

    def same(a, b):
        return all(np.array_equal(np.asarray(getattr(a, k)),
                                  np.asarray(getattr(b, k)))
                   for k in STRUCTURE)

    first_tie = next((t for t in range(10)
                      if not all(same(fits[0][t], f[t]) for f in fits[1:])),
                     10)
    assert first_tie >= 1, 'the first tree already ties'
    ours = pm.forest_state.trees
    for t in range(first_tie):
        assert same(fits[0][t], ours[t]), f'tree {t}'
        np.testing.assert_allclose(ours[t].value,
                                   fits[0][t].value.reshape(-1), rtol=1e-12,
                                   atol=1e-15)
    if first_tie < 10:
        warnings.warn(f'{model} on data/dummy: scikit-learn\'s tree '
                      f'{first_tie + 1} depends on its feature order (tied '
                      'splits); the trees from there are checked through '
                      'the carried forest instead')


def test_cli_fit_writes_and_reserves_forest_npz(workdir):
    """``gbdt --load_base --predict --export_reprs`` fits, evaluates,
    writes ``forest.npz`` and no LTR factors; ``--load RUN --no_train``
    restores the trees before its evaluation: the same metrics."""
    from textgcn_tpu_torch.cli import main as port_main
    with _cpu_run_in(workdir):
        fit = port_main(_argv('gbdt', 'npz', '--load_base', 'base.pkl',
                              '--predict', '--export_reprs'))
        run = os.path.join(workdir, fit.cfg.save_path)
        files = set(os.listdir(run))
        assert {'forest.npz', 'best.pkl', 'latest_checkpoint.pkl',
                'predictions.tsv', 'users_repr.npy',
                'items_repr.npy'} <= files
        assert not any(f.startswith('ltr_') for f in files)
        state = load_forest(run)
        for a, b in zip(fit.model.forest_state.trees, state.trees):
            for k in (*STRUCTURE, 'value', 'impurity'):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert (state.init, state.learning_rate, state.n_features) == (
            fit.model.forest_state.init, 0.1, 5)
        served = port_main(_argv('gbdt', 'npz-serve', '--load', run,
                                 '--no_train'))
    for name, values in fit.last_metrics.items():
        np.testing.assert_allclose(served.last_metrics[name], values,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize('model', JAX_RUNS)
def test_jax_tree_pkl_serves_jax_metrics_and_predictions(model, workdir,
                                                         jax_runs):
    """``--load`` of the JAX run itself (``tree.pkl`` and ``best.pkl``, no
    ``forest.npz``) restores the JAX fit's trees and serves its metrics
    and ``predictions.tsv`` bytes."""
    from textgcn_tpu_torch.cli import main as port_main
    jt, jax_dir = jax_runs[model]
    assert os.path.exists(os.path.join(jax_dir, 'tree.pkl'))
    assert not os.path.exists(os.path.join(jax_dir, 'forest.npz'))
    want = {m: v[-1] for m, v in jt.inner.metrics_logger.items()}
    with _cpu_run_in(workdir):
        pt = port_main(_argv(model, f'tree-pkl-{model}', '--load', jax_dir,
                             '--no_train', '--predict'))
    carried = forest_from_estimator(jt.model.tree)
    for a, b in zip(pt.model.forest_state.trees, carried.trees):
        for k in (*STRUCTURE, 'value', 'impurity'):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for name, values in want.items():
        np.testing.assert_allclose(pt.last_metrics[name], values, rtol=0,
                                   atol=1e-6, err_msg=name)
    with open(os.path.join(jax_dir, 'predictions.tsv'), 'rb') as f:
        jax_bytes = f.read()
    with open(os.path.join(workdir, pt.cfg.save_path, 'predictions.tsv'),
              'rb') as f:
        assert f.read() == jax_bytes


def test_serving_without_a_forest_raises(workdir):
    pt = _port_loaded(workdir, 'gbdt', 'no-forest')
    with pytest.raises(RuntimeError, match='no fitted forest'):
        pt.predict([0, 1])


@pytest.mark.parametrize('model', BOOSTED)
def test_cli_needs_cuda_unless_the_cpu_is_asked_for(model, monkeypatch):
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.delenv('TEXTGCN_TPU_PLATFORM', raising=False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        port_main(['--model', model, '--data', 'dummy'])


@pytest.mark.parametrize('model', BOOSTED)
def test_heads_warn_as_jax_does(model, workdir):
    """``xgboost``, ``xgboost_pop`` and ``marcus`` log that they fit the
    least-squares ensemble; ``gbdt`` and ``gbdt_pop`` do not."""
    from textgcn_tpu_torch.data.text import load_ltr_data
    from textgcn_tpu_torch.registry import get_class
    cfg = tconfig.Config(model=model, data=str(workdir / 'dummy'),
                         emb_size=D, save=False).finalize()
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.WARNING)
    try:
        _, cls = get_class(model)
        m = cls(cfg, load_ltr_data(cfg), device='cpu')
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    warned = [r for r in records if 'xgboost not available' in r.getMessage()]
    assert len(warned) == (model != 'gbdt' and model != 'gbdt_pop')
    assert m.n_features == (7 if model.endswith('_pop') else 5)
    assert not m.supports_fused_sharded_topk


@pytest.mark.parametrize('model', tconfig.MODEL_CHOICES)
def test_registry_maps_every_model_as_jax_does(model):
    from textgcn_tpu.registry import get_class as jax_get_class
    from textgcn_tpu_torch.registry import get_class
    jl, jc = jax_get_class(model)
    pl, pc = get_class(model)
    assert (pl.__name__, pc.__name__) == (jl.__name__, jc.__name__)


def test_registry_refuses_an_unknown_model():
    from textgcn_tpu_torch.registry import get_class
    with pytest.raises(ValueError, match='unknown model'):
        get_class('xgb')


def test_forest_predict_is_the_served_score(workdir, jax_runs):
    """The served top-k's values are the forest's scores of those items."""
    jt, _ = jax_runs['gbdt']
    pt = _port_loaded(workdir, 'gbdt', 'scores')
    pt.model.forest_state = forest_from_estimator(jt.model.tree)
    m = pt.model
    users = torch.arange(m.n_users)
    with torch.no_grad():
        reprs = m.scoring_reprs()
        v, i = m.topk_for_users(reprs, users, 5)
        feats = m.batch_features(reprs, users)
    scores = trees.forest_predict(m.forest, feats.reshape(-1, 5)).reshape(
        m.n_users, m.n_items)
    picked = scores.gather(1, i)
    finite = torch.isfinite(v)
    assert torch.equal(v[finite], picked[finite])
