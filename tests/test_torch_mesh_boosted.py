"""The boosted heads on the port's mesh (``gbdt``, ``gbdt_pop``,
``xgboost``, ``xgboost_pop``, ``marcus`` with ``--mesh``: the tables on
K2's source shards, the fit replicated from the gathered tables, each
rank scoring its own catalogue rows through the forest and the ranks'
candidates merged with ties to the lower index) against the port's
single process and the JAX package, on the CPU.

Ranks are gloo processes at W = 2 and W = 4, started once per W for the
five heads (``tests/helpers/torch_mesh_conv_worker.py``, kind
``boosted``); the single process and the JAX package's mesh runs are
made here while they run.  A copy of ``data/dummy`` (stub text), d = 16,
a random base in the JAX pickle format.

* Each head's CLI run with ``--load_base --predict --mesh 1xW`` fits on
  every rank the single process's forest (every array bit-equal), serves
  every user's top-5 exactly as it does (values and indices, ties
  included), measures its metrics, and writes the same
  ``predictions.tsv`` bytes and ``forest.npz`` from rank 0;
  ``--load RUN --no_train --mesh 1xW`` re-serves the metrics.
* Forests whose scores tie across the shards (a constant forest, a stump)
  give the single process's top-2 on every rank: ties to the lower index,
  also where ``torch.topk`` breaks its ties to the higher index (as a CUDA
  one may; the CPU's keeps the lower).
* The ranks' forests are compared by one all-reduce of their digest: a
  rank whose forest differs makes every rank raise.
* ``gbdt_pop`` and ``marcus`` on a JAX mesh of the same size, their
  scikit-learn forests carried across by ``weights.forest_from_estimator``,
  serve the JAX package's metrics (1e-6) and ``predictions.tsv`` bytes
  through the port's mesh.
"""

import contextlib
import logging
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_mesh_conv import HELPERS, _join
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.ops.trees import GBRTState, Tree
from textgcn_tpu_torch.weights import forest_from_estimator

D = 16
HEADS = ('gbdt_pop', 'xgboost', 'xgboost_pop', 'marcus', 'gbdt')
JAX_HEADS = ('gbdt_pop', 'marcus')
WORLDS = (2, 4)
TIES = ('constant', 'stump')
# fewer than a shard's rows at W = 2 and 4 (5 and 3 of dummy's 10 items):
# each rank's own top-k then chooses among its tied columns
TIE_K = 2
SPAWN_TIMEOUT = 480


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@contextlib.contextmanager
def _cpu_run_in(path):
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.chdir(path)
        mpatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
        yield


def _leaf(value):
    return Tree(children_left=np.array([-1]), children_right=np.array([-1]),
                feature=np.array([-2]), threshold=np.array([-2.0]),
                value=np.array([value]), impurity=np.array([0.0]),
                n_node_samples=np.array([1]))


def _tie_forests(n_features):
    """A constant forest (every item ties) and a stump on the dot-product
    feature at 0 (two tied groups)."""
    stump = Tree(children_left=np.array([1, -1, -1]),
                 children_right=np.array([2, -1, -1]),
                 feature=np.array([0, -2, -2]),
                 threshold=np.array([0.0, -2.0, -2.0]),
                 value=np.array([0.5, -1.0, 2.0]),
                 impurity=np.array([1.0, 0.0, 0.0]),
                 n_node_samples=np.array([2, 1, 1]))
    return [GBRTState([_leaf(0.25)], 0.5, 0.1, n_features),
            GBRTState([stump], 0.0, 0.5, n_features)]


def _argv(data):
    return ['--data', data, '--emb_size', str(D), '-k', '3', '5',
            '--batch_size', '16', '--neg_samples', '2', '--quiet']


@pytest.fixture(scope='module')
def workdir(tmp_path_factory, dummy_dir):
    """A copy of data/dummy and an ``lgcn`` base pickle in the JAX
    package's format."""
    root = tmp_path_factory.mktemp('mesh_boosted')
    shutil.copytree(dummy_dir, root / 'dummy')
    data = load_interactions(str(root / 'dummy'))
    rng = np.random.RandomState(8)
    params = {name: (0.3 * rng.randn(n, D)).astype(np.float32)
              for name, n in (('user_emb', data.n_users),
                              ('item_emb', data.n_items))}
    with open(root / 'base.pkl', 'wb') as f:
        pickle.dump({'params': params, 'epoch': 3, 'model': 'lgcn'}, f)
    return root


def _single_runs(root, data, base, n_users):
    """The port's single process: each head fitted, its forest, every
    user's top-5, metrics, ``predictions.tsv`` bytes and the re-served
    metrics; the tie forests' top-5 through the last head."""
    from textgcn_tpu_torch.cli import main as port_main
    out = {}
    users = np.arange(n_users)
    with _cpu_run_in(root):
        for model in HEADS:
            trainer = port_main(['--model', model, *_argv(data),
                                 '--load_base', base, '--predict', '--uid',
                                 f'single-{model}'])
            idx, vals = trainer._predict_users(users)
            run = os.path.join(root, trainer.cfg.save_path)
            served = port_main(['--model', model, *_argv(data), '--load',
                                run, '--no_train', '--uid',
                                f'single-{model}-serve'])
            with open(os.path.join(run, 'predictions.tsv'), 'rb') as f:
                tsv = f.read()
            out[model] = {'forest': trainer.model.forest_state,
                          'metrics': trainer.last_metrics,
                          'served_metrics': served.last_metrics,
                          'topk': (vals, idx), 'predictions': tsv}
        model = trainer.model
        ties = []
        for state in _tie_forests(model.n_features):
            model.forest_state = state
            with torch.no_grad():
                vals, idx = model.topk_for_users(
                    model.scoring_reprs(), torch.from_numpy(users), TIE_K)
            ties.append((vals.numpy(), idx.numpy()))
        out['ties'] = ties
    return out


def _jax_mesh_runs(root, data, base, world):
    """``{model: (JAX trainer, run dir)}`` of the JAX CLI with
    ``--load_base --predict --mesh 1xW``."""
    from textgcn_tpu.cli import main as jax_main
    out = {}
    with _cpu_run_in(root):
        for model in JAX_HEADS:
            trainer = jax_main(['--model', model, *_argv(data),
                                '--load_base', base, '--predict', '--mesh',
                                f'1x{world}', '--uid', f'jax-{model}-{world}'])
            out[model] = (trainer, os.path.join(root, trainer.cfg.save_path))
    return out


@pytest.fixture(scope='module')
def ranks(workdir, tmp_path_factory):
    sys.path.insert(0, HELPERS)
    import torch_mesh_conv_worker
    data = str(workdir / 'dummy')
    base = str(workdir / 'base.pkl')
    n_users = load_interactions(data).n_users
    inp = {'kind': 'boosted', 'heads': HEADS, 'argv': _argv(data),
           'base': base, 'n_users': n_users, 'jax_timeout': SPAWN_TIMEOUT,
           'tie_forests': _tie_forests(5), 'tie_k': TIE_K}
    dirs = {w: tmp_path_factory.mktemp(f'mesh_boosted{w}') for w in WORLDS}
    for d in dirs.values():
        with open(d / 'inputs.pkl', 'wb') as f:
            pickle.dump(inp, f)
    contexts = [mp.start_processes(torch_mesh_conv_worker.run,
                                   args=(w, str(d)), nprocs=w, join=False,
                                   start_method='spawn')
                for w, d in dirs.items()]
    out = {'dirs': dirs, 'jax': {}}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for w, d in dirs.items():
            out['jax'][w] = _jax_mesh_runs(workdir, data, base, w)
            carried = {m: forest_from_estimator(t.model.tree)
                       for m, (t, _) in out['jax'][w].items()}
            with open(d / 'jax.pkl.tmp', 'wb') as f:
                pickle.dump(carried, f)
            os.replace(d / 'jax.pkl.tmp', d / 'jax.pkl')
        out['single'] = _single_runs(workdir, data, base, n_users)
    finally:
        torch.set_num_threads(threads)
        _join(contexts, SPAWN_TIMEOUT)
    for w, d in dirs.items():
        out[w] = []
        for r in range(w):
            with open(d / f'rank{r}.pkl', 'rb') as f:
                out[w].append(pickle.load(f)['boosted'])
    return out


def _same_forest(a: GBRTState, b: GBRTState) -> bool:
    return ((a.init, a.learning_rate, a.n_features)
            == (b.init, b.learning_rate, b.n_features)
            and len(a.trees) == len(b.trees)
            and all(np.asarray(getattr(x, f)).tobytes()
                    == np.asarray(getattr(y, f)).tobytes()
                    and np.asarray(getattr(x, f)).dtype
                    == np.asarray(getattr(y, f)).dtype
                    for x, y in zip(a.trees, b.trees)
                    for f in Tree.__dataclass_fields__))


@pytest.mark.parametrize('model', HEADS)
def test_every_rank_fits_the_single_process_forest(ranks, model):
    want = ranks['single'][model]['forest']
    assert len(want.trees) == 10 and want.digest()
    for w in WORLDS:
        for got in ranks[w]:
            assert _same_forest(got[model]['forest'], want)
            assert got[model]['forest'].digest() == want.digest()


@pytest.mark.parametrize('model', HEADS)
def test_served_topk_and_metrics_equal_the_single_process(ranks, model):
    want = ranks['single'][model]
    vals, idx = want['topk']
    for w in WORLDS:
        for got in ranks[w]:
            g_vals, g_idx = got[model]['topk']
            np.testing.assert_array_equal(g_vals, vals)
            np.testing.assert_array_equal(g_idx, idx)
            for name, v in want['metrics'].items():
                np.testing.assert_array_equal(got[model]['metrics'][name], v)
                np.testing.assert_array_equal(
                    got[model]['served_metrics'][name], v)


@pytest.mark.parametrize('model', HEADS)
def test_rank_0_writes_the_single_process_files(ranks, model):
    """``forest.npz`` round-trips to the single process's forest and
    ``predictions.tsv`` holds its bytes; both files of the run come from
    rank 0 alone, in the directory the ranks share."""
    from textgcn_tpu_torch.train.checkpoint import load_forest
    want = ranks['single'][model]
    for w, d in ranks['dirs'].items():
        run = d / 'runs' / 'dummy' / f'mesh-{model}'
        assert _same_forest(load_forest(str(run)), want['forest'])
        assert (run / 'predictions.tsv').read_bytes() == want['predictions']
        assert {'forest.npz', 'best.pkl', 'latest_checkpoint.pkl',
                'resume_state.pkl', 'log.log'} <= set(os.listdir(run))


@pytest.mark.parametrize('case', range(len(TIES)), ids=TIES)
def test_tied_scores_across_shards_go_to_the_lower_index(ranks, case):
    vals, idx = ranks['single']['ties'][case]
    # each user's top-2 ties, and a shard holds more tied items than that
    assert all(len(set(v)) == 1 for v in vals)
    for w in WORLDS:
        for got in ranks[w]:
            for name in ('ties', 'ties_high_first'):
                g_vals, g_idx = got[name][case]
                np.testing.assert_array_equal(g_vals, vals)
                np.testing.assert_array_equal(g_idx, idx)


def test_a_rank_with_another_forest_makes_every_rank_raise(ranks):
    for w in WORLDS:
        for got in ranks[w]:
            assert got['agree'] == (True, False)
            assert 'diverged' in got['diverged']


@pytest.mark.parametrize('model', JAX_HEADS)
def test_carried_jax_mesh_forest_serves_jax_metrics_and_predictions(
        ranks, model):
    for w, d in ranks['dirs'].items():
        jt, jax_dir = ranks['jax'][w][model]
        want = {m: v[-1] for m, v in jt.inner.metrics_logger.items()}
        for got in ranks[w]:
            for name, values in want.items():
                np.testing.assert_allclose(got['carried'][model][name],
                                           values, rtol=0, atol=1e-6,
                                           err_msg=name)
        port = d / 'runs' / 'dummy' / f'carried-{model}' / 'predictions.tsv'
        with open(os.path.join(jax_dir, 'predictions.tsv'), 'rb') as f:
            assert port.read_bytes() == f.read()
