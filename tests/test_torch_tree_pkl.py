"""The boosted heads' ``tree.pkl`` read without scikit-learn:
``weights.forest_from_tree_pkl`` (a restricted unpickler of inert
stand-ins) against ``weights.forest_from_estimator`` of the estimator that
``pickle.load`` makes with scikit-learn, on the CPU.

* Warm-started ``GradientBoostingRegressor``s (the JAX package's head:
  ``warm_start=True``, more trees fitted on a second batch) of 1 to 30
  trees, depth 1 to 5, with the ``DummyRegressor`` initial estimator and
  with ``init='zero'``: every tree's arrays, the initial prediction, the
  learning rate and the feature count equal;
* the committed JAX ``gbdt`` run (``tests/fixtures/jax_runs/gbdt``,
  ``tests/helpers/make_jax_runs.py``) served by the port's CLI from its
  ``tree.pkl`` equals the same run served from a converted
  ``forest.npz``: metrics and ``predictions.tsv`` bytes;
* in an interpreter where scikit-learn cannot be imported, the same
  forest is read;
* a pickle naming ``os.system`` is refused before anything in it is built
  or run, and an ``XGBRanker`` global is refused by name.
"""

import contextlib
import logging
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
from sklearn.ensemble import GradientBoostingRegressor

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch import weights
from textgcn_tpu_torch.train.checkpoint import save_forest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'jax_runs', 'gbdt')
FIELDS = ('children_left', 'children_right', 'feature', 'threshold',
          'value', 'impurity', 'n_node_samples')


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def _same_forest(a, b):
    assert (a.init, a.learning_rate, a.n_features) == (
        b.init, b.learning_rate, b.n_features)
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        for f in FIELDS:
            x, y = getattr(ta, f), getattr(tb, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize('init', [None, 'zero'], ids=['dummy', 'zero'])
@pytest.mark.parametrize('depth', [1, 3, 5])
@pytest.mark.parametrize('n_trees', [1, 7, 30])
def test_tree_pkl_equals_the_estimator(n_trees, depth, init, tmp_path):
    rng = np.random.default_rng(n_trees * 10 + depth)
    x = rng.standard_normal((300, 6)).astype(np.float32)
    y = x[:, 0] - 2 * x[:, 3] ** 2 + 0.1 * rng.standard_normal(300)
    est = GradientBoostingRegressor(warm_start=True, max_depth=depth,
                                    n_estimators=max(1, n_trees // 2),
                                    init=init).fit(x[:150], y[:150])
    est.n_estimators = n_trees
    est.fit(x[150:], y[150:])
    path = tmp_path / 'tree.pkl'
    with open(path, 'wb') as f:
        pickle.dump(est, f)
    with open(path, 'rb') as f:
        want = weights.forest_from_estimator(pickle.load(f))
    got = weights.forest_from_tree_pkl(str(path))
    assert len(got.trees) == n_trees
    _same_forest(got, want)


@contextlib.contextmanager
def _cpu_run_in(path):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(path)
        mp.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
        mp.setenv('TEXTGCN_TPU_TEXT_ENCODER', 'stub')
        yield


@pytest.fixture(scope='module')
def served(tmp_path_factory, dummy_dir):
    """The fixture run served by the port's CLI from its ``tree.pkl`` and
    from a copy whose ensemble is a converted ``forest.npz``."""
    from textgcn_tpu_torch.cli import main as port_main
    root = tmp_path_factory.mktemp('tree_pkl')
    shutil.copytree(dummy_dir, root / 'dummy')
    npz = root / 'npz_run'
    npz.mkdir()
    shutil.copyfile(os.path.join(FIXTURE, 'best.pkl'), npz / 'best.pkl')
    with open(os.path.join(FIXTURE, 'tree.pkl'), 'rb') as f:
        save_forest(str(npz), weights.forest_from_estimator(pickle.load(f)))
    out = {}
    with _cpu_run_in(root):
        for name, run in (('tree_pkl', FIXTURE), ('forest_npz', str(npz))):
            trainer = port_main([
                '--model', 'gbdt', '--data', 'dummy', '--emb_size', '64',
                '-k', '3', '5', '--batch_size', '16', '--uid', name,
                '--quiet', '--load', run, '--no_train', '--predict'])
            with open(root / trainer.cfg.save_path / 'predictions.tsv',
                      'rb') as f:
                out[name] = (trainer, f.read())
    return out


def test_jax_gbdt_run_serves_as_its_converted_forest_npz(served):
    (a, pa), (b, pb) = served['tree_pkl'], served['forest_npz']
    _same_forest(a.model.forest_state, b.model.forest_state)
    assert a.last_metrics == b.last_metrics
    assert pa == pb
    assert all(np.isfinite(v).all() for v in a.last_metrics.values())


def test_read_without_scikit_learn():
    code = ('import sys; sys.modules["sklearn"] = None; '
            f'sys.path.insert(0, {REPO!r}); import numpy as np; '
            'from textgcn_tpu_torch.weights import forest_from_tree_pkl; '
            f'f = forest_from_tree_pkl({os.path.join(FIXTURE, "tree.pkl")!r});'
            ' assert "sklearn" not in [m.split(".")[0] for m in sys.modules '
            'if sys.modules[m] is not None]; '
            'print(len(f.trees), repr(f.init), '
            'sum(float(np.abs(t.value).sum()) for t in f.trees))')
    run = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    with open(os.path.join(FIXTURE, 'tree.pkl'), 'rb') as f:
        want = weights.forest_from_estimator(pickle.load(f))
    n, init, total = run.stdout.split()
    assert int(n) == len(want.trees) and float(init) == want.init
    assert float(total) == sum(float(np.abs(t.value).sum())
                               for t in want.trees)


class _System:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f'touch {self.marker}',)


def test_a_pickle_naming_os_system_is_refused_unrun(tmp_path, monkeypatch):
    marker = tmp_path / 'ran'
    path = tmp_path / 'tree.pkl'
    est = GradientBoostingRegressor(n_estimators=2).fit(
        np.eye(4, dtype=np.float32), np.arange(4.0))
    built = []
    new = weights._Inert.__new__
    monkeypatch.setattr(weights._Inert, '__new__', lambda cls, *a, **k: (
        built.append(cls.__name__), new(cls, *a, **k))[1])
    with open(path, 'wb') as f:
        pickle.dump(est, f)
    weights.forest_from_tree_pkl(str(path))
    assert 'GradientBoostingRegressor' in built     # the count sees builds
    built.clear()
    with open(path, 'wb') as f:
        pickle.dump({'head': est, 'payload': _System(marker)}, f)
    with pytest.raises(pickle.UnpicklingError, match=r'refers to '
                       r'(posix|nt|os)\.system: a tree\.pkl may name numpy '
                       'arrays and the classes of a scikit-learn'):
        weights.forest_from_tree_pkl(str(path))
    assert not marker.exists()
    assert built == []


def test_an_xgbranker_global_is_refused_by_name(tmp_path):
    path = tmp_path / 'tree.pkl'
    # protocol 2: GLOBAL xgboost.sklearn XGBRanker, EMPTY_TUPLE, NEWOBJ
    path.write_bytes(b'\x80\x02cxgboost.sklearn\nXGBRanker\n)\x81.')
    with pytest.raises(pickle.UnpicklingError,
                       match=r'xgboost model \(xgboost\.sklearn\.XGBRanker\)'):
        weights.forest_from_tree_pkl(str(path))


def test_another_estimator_is_refused(tmp_path):
    """A pickle of admitted globals that is not a gradient-boosted
    ensemble: a lone ``DummyRegressor``."""
    from sklearn.dummy import DummyRegressor
    path = tmp_path / 'tree.pkl'
    with open(path, 'wb') as f:
        pickle.dump(DummyRegressor().fit(np.ones((3, 2)), np.ones(3)), f)
    with pytest.raises(ValueError, match='holds a DummyRegressor, not a '
                       'GradientBoostingRegressor'):
        weights.forest_from_tree_pkl(str(path))
