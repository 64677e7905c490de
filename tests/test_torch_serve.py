"""The port's serving path against the JAX package's, on the CPU.

Propagation, retrieval, metrics and the whole ``--no_train --load
--predict`` slice, from the same inputs (made with numpy from a seed) to
the same outputs, within stated tolerances.  Also: nothing falls back to
the CPU unless the CPU is asked for.
"""

import csv
import logging
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu.ops import metrics as jax_metrics
from textgcn_tpu.ops.propagate import propagate_rest as jax_rest
from textgcn_tpu.ops.propagate import representation as jax_repr
from textgcn_tpu.ops.retrieval import score_and_topk as jax_topk
from textgcn_tpu.ops.spmm import BipartiteGraphOp
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.ops import metrics as port_metrics
from textgcn_tpu_torch.ops.propagate import propagate_rest, representation
from textgcn_tpu_torch.ops.retrieval import mask_train_items, score_and_topk
from textgcn_tpu_torch.ops.spmm import GraphOp, spmm_dropout_cuda
from textgcn_tpu_torch.train.checkpoint import make_checkpointer
from textgcn_tpu_torch.weights import params_from_jax

D = 16
ATOL = 1e-5   # f32 sums in another order over <= 3 layers


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@pytest.fixture(scope='module')
def dummy(dummy_dir):
    data = load_interactions(dummy_dir)
    g = data.graph
    rng = np.random.RandomState(0)
    ue = rng.randn(data.n_users, D).astype(np.float32)
    ie = rng.randn(data.n_items, D).astype(np.float32)
    jax_op = BipartiteGraphOp(g.edge_user, g.edge_item, g.edge_weight,
                              data.n_users, data.n_items)
    port_op = GraphOp(g.edge_user, g.edge_item, g.edge_weight, data.n_users,
                      data.n_items, 'cpu')
    return data, ue, ie, jax_op, port_op


def assert_topk_equal_up_to_ties(vals_a, idx_a, vals_b, idx_b, tol):
    """Values agree position by position within ``tol`` (-inf == -inf);
    indices agree wherever the value is finite and apart from every other
    value of its row by more than ``2 * tol``."""
    va, vb = np.asarray(vals_a, np.float64), np.asarray(vals_b, np.float64)
    assert va.shape == vb.shape
    inf = np.isneginf(va) & np.isneginf(vb)
    with np.errstate(invalid='ignore'):
        assert (inf | (np.abs(va - vb) <= tol)).all()
    ia, ib = np.asarray(idx_a), np.asarray(idx_b)
    for row, v in enumerate(va):
        for j, x in enumerate(v):
            if np.isfinite(x) and (np.abs(np.delete(v, j) - x) > 2 * tol).all():
                assert ia[row, j] == ib[row, j], (row, j)


@pytest.mark.parametrize('single', [False, True])
@pytest.mark.parametrize('n_layers', [1, 3])
def test_representation_matches_jax(dummy, single, n_layers):
    _, ue, ie, jax_op, port_op = dummy
    ju, ji = jax_repr({'user_emb': jnp.asarray(ue), 'item_emb':
                       jnp.asarray(ie)}, jax_op, n_layers, single=single)
    pu, pi = representation(torch.from_numpy(ue), torch.from_numpy(ie),
                            port_op, n_layers, single=single)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), atol=ATOL, rtol=0)


def test_propagate_rest_matches_jax(dummy):
    _, ue, ie, jax_op, port_op = dummy
    ju, ji = jax_rest({'user_emb': jnp.asarray(ue), 'item_emb':
                       jnp.asarray(ie)}, jax_op, 3)
    pu, pi = propagate_rest(torch.from_numpy(ue), torch.from_numpy(ie),
                            port_op, 3)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), atol=ATOL, rtol=0)


@pytest.mark.parametrize('k', [1, 5, 9])
def test_score_and_topk_matches_jax(dummy, k):
    data, ue, ie, _, _ = dummy
    users = np.arange(data.n_users)
    pos = data.pos_padded[users]
    jv, ji = jax_topk(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(pos),
                      k=k, n_items=data.n_items)
    pv, pi = score_and_topk(torch.from_numpy(ue), torch.from_numpy(ie),
                            torch.from_numpy(pos), k=k, n_items=data.n_items)
    assert pv.shape == pi.shape == (data.n_users, k)
    assert_topk_equal_up_to_ties(pv.numpy(), pi.numpy(), np.asarray(jv),
                                 np.asarray(ji), 1e-5)


def test_mask_train_items_masks_exactly_the_positives(dummy):
    data, *_ = dummy
    scores = torch.zeros(data.n_users, data.n_items + 3)
    masked = mask_train_items(scores, torch.from_numpy(data.pos_padded),
                              data.n_items)
    assert masked.shape == (data.n_users, data.n_items)
    want = np.zeros((data.n_users, data.n_items), bool)
    want[data.graph.edge_user, data.graph.edge_item] = True
    np.testing.assert_array_equal(torch.isneginf(masked).numpy(), want)
    assert (masked[~torch.from_numpy(want)] == 0).all()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_calculate_metrics_equal(seed):
    rng = np.random.RandomState(seed)
    n, n_items, ks = 50, 30, (3, 5, 10)
    y_pred = np.stack([rng.permutation(n_items)[:10] for _ in range(n)])
    y_true = [list(rng.choice(n_items, rng.randint(1, 6), replace=False))
              for _ in range(n)]
    assert port_metrics.METRICS == jax_metrics.METRICS
    assert port_metrics.calculate_metrics(y_pred, y_true, ks) == \
        jax_metrics.calculate_metrics(y_pred, y_true, ks)
    hist = {m: rng.rand(4, 3) for m in port_metrics.METRICS}
    assert port_metrics.early_stop(hist) == jax_metrics.early_stop(hist)


def _write_padded_checkpoint(path, n_users, n_items, seed=7):
    """A JAX-format pickle with tables padded to 4096 rows."""
    rng = np.random.RandomState(seed)
    state = {'params': {
        'user_emb': (0.1 * rng.randn(4096, D)).astype(np.float32),
        'item_emb': (0.1 * rng.randn(4096, D)).astype(np.float32)},
        'epoch': 5, 'model': 'lgcn'}
    with open(path, 'wb') as f:
        pickle.dump(state, f)
    return state


def _read_predictions(path):
    with open(path, newline='') as f:
        rows = list(csv.reader(f, delimiter='\t'))
    return rows[0], rows[1:]


@pytest.mark.parametrize('single', [False, True])
def test_whole_slice_matches_jax(tmp_path, monkeypatch, dummy_dir, single):
    """Load a padded JAX checkpoint, evaluate, predict and export through
    both CLIs: equal metrics (1e-6), predictions up to ties, reprs 1e-5."""
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    data = load_interactions(dummy_dir)
    ck = str(tmp_path / 'ck.pkl')
    _write_padded_checkpoint(ck, data.n_users, data.n_items)
    argv = ['--model', 'lgcn', '--data', dummy_dir, '--no_train', '--load',
            ck, '--predict', '--export_reprs', '--emb_size', str(D),
            '--batch_size', '8', '-k', '3', '5', '--n_layers', '3']
    if single:
        argv.append('--single')
    jt = jax_main(argv + ['--uid', 'jax'])
    pt = port_main(argv + ['--uid', 'port'])
    assert spmm_dropout_cuda.launches == 0
    jm, pm = jt.evaluate(), pt.evaluate()
    assert pm.keys() == jm.keys()
    for name in jm:
        np.testing.assert_allclose(pm[name], jm[name], atol=1e-6, rtol=0)
    np.testing.assert_allclose(pt.last_metrics['recall'], jm['recall'],
                               atol=1e-6, rtol=0)

    jh, jrows = _read_predictions(tmp_path / 'runs/dummy/jax/predictions.tsv')
    ph, prows = _read_predictions(tmp_path / 'runs/dummy/port/predictions.tsv')
    assert jh == ph == ['user_id', 'y_pred', 'scores']
    assert len(prows) == data.n_users
    assert [r[0] for r in prows] == [r[0] for r in jrows]

    def parse(rows):
        items = [eval(r[1]) for r in rows]  # noqa: S307 - our own file
        vals = [[float(s) for s in r[2][1:-1].split(',')] for r in rows]
        return vals, items

    jv, ji = parse(jrows)
    pv, pi = parse(prows)
    assert_topk_equal_up_to_ties(pv, pi, jv, ji, 2e-4)   # 4-decimal cells
    for name in ('users_repr', 'items_repr'):
        np.testing.assert_allclose(
            np.load(tmp_path / f'runs/dummy/port/{name}.npy'),
            np.load(tmp_path / f'runs/dummy/jax/{name}.npy'),
            atol=ATOL, rtol=0)


def test_predictions_tsv_bytes_match_pandas(tmp_path, monkeypatch,
                                            dummy_dir):
    """The same rows written by pandas (as the JAX package does) and by the
    port give the same bytes."""
    import pandas as pd
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    data = load_interactions(dummy_dir)
    ck = str(tmp_path / 'ck.pkl')
    _write_padded_checkpoint(ck, data.n_users, data.n_items)
    pt = port_main(['--model', 'lgcn', '--data', dummy_dir, '--no_train',
                    '--load', ck, '--emb_size', str(D), '-k', '3', '7',
                    '--uid', 'p', '--quiet'])
    users = list(range(data.n_users))
    preds, scores = pt.predict(users, save=True, with_scores=True)
    out = tmp_path / 'pandas.tsv'
    pd.DataFrame({
        'user_id': [data.user_id_map[u] for u in users],
        'y_pred': [[data.item_id_map[i] for i in row] for row in preds],
        'scores': scores}).to_csv(out, sep='\t', index=False)
    assert (tmp_path / 'runs/dummy/p/predictions.tsv').read_bytes() == \
        out.read_bytes()


def test_params_from_jax_slices_phantom_rows():
    rng = np.random.RandomState(0)
    params = {'user_emb': rng.randn(4096, 4).astype(np.float32),
              'item_emb': rng.randn(8192, 4).astype(np.float64),
              'head_w': np.zeros(3)}
    out = params_from_jax(params, 10, 4100)
    assert set(out) == {'user_emb', 'item_emb'}
    np.testing.assert_array_equal(out['user_emb'].numpy(),
                                  params['user_emb'][:10])
    assert out['item_emb'].dtype == torch.float32
    assert out['item_emb'].shape == (4100, 4)
    with pytest.raises(ValueError, match='rows'):
        params_from_jax(params, 5000, 10)
    with pytest.raises(KeyError):
        params_from_jax({'user_emb': params['user_emb']}, 10, 10)


def test_checkpoint_loader_reads_jax_files_and_refuses_code(tmp_path):
    state = _write_padded_checkpoint(tmp_path / 'best.pkl', 1, 1)
    ck = make_checkpointer('pickle')
    got = ck.load(str(tmp_path))                         # run dir -> best.pkl
    assert got['epoch'] == 5 and got['model'] == 'lgcn'
    np.testing.assert_array_equal(got['params']['user_emb'],
                                  state['params']['user_emb'])
    with open(tmp_path / 'evil.pkl', 'wb') as f:
        pickle.dump({'params': os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match='only numpy arrays'):
        ck.load(str(tmp_path / 'evil.pkl'))
    with pytest.raises(ValueError, match='unknown checkpoint backend'):
        make_checkpointer('tensorstore')


def test_no_cuda_means_an_error_not_a_cpu_run(tmp_path, monkeypatch,
                                              dummy_dir):
    from textgcn_tpu_torch.cli import main as port_main
    from textgcn_tpu_torch.models.lightgcn import LightGCN
    if torch.cuda.is_available():
        pytest.skip('this host has a GPU: CUDA is what it would run on')
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv('TEXTGCN_TPU_PLATFORM', raising=False)
    argv = ['--model', 'lgcn', '--data', dummy_dir, '--no_train', '--uid',
            'x']
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        port_main(argv)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'tpu')
    with pytest.raises(ValueError, match='TEXTGCN_TPU_PLATFORM'):
        port_main(argv)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tconfig.resolve_device('cuda')
    cfg = tconfig.Config(data=dummy_dir, emb_size=D).finalize()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        LightGCN(cfg, load_interactions(dummy_dir))
    assert tconfig.resolve_device('cpu') == torch.device('cpu')


def test_cli_requires_no_train(tmp_path, monkeypatch, dummy_dir):
    """``--no_train`` skips training: the loaded tables are served as they
    are and nothing is checkpointed; without it the CLI trains, and
    ``--resume`` continues that run."""
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    data = load_interactions(dummy_dir)
    ck = str(tmp_path / 'ck.pkl')
    state = _write_padded_checkpoint(ck, data.n_users, data.n_items)
    argv = ['--model', 'lgcn', '--data', dummy_dir, '--load', ck,
            '--emb_size', str(D), '-k', '3', '--epochs', '1', '--quiet']
    served = port_main(argv + ['--no_train', '--uid', 'x'])
    np.testing.assert_array_equal(
        served.model.user_emb.detach().numpy(),
        state['params']['user_emb'][:data.n_users])
    assert served.loss_history == []
    assert not (tmp_path / 'runs/dummy/x/latest_checkpoint.pkl').exists()
    trained = port_main(argv + ['--uid', 'y'])
    assert len(trained.loss_history) == 1
    assert (tmp_path / 'runs/dummy/y/best.pkl').exists()
    resumed = port_main(['--model', 'lgcn', '--data', dummy_dir,
                         '--emb_size', str(D), '-k', '3', '--quiet',
                         '--epochs', '2', '--evaluate_every', '1',
                         '--resume', 'runs/dummy/y', '--uid', 'z'])
    assert len(resumed.loss_history) == 1
    assert (tmp_path / 'runs/dummy/z/latest_checkpoint.pkl').exists()


def test_model_init_is_seeded_normal(dummy_dir):
    from textgcn_tpu_torch.models.lightgcn import LightGCN
    data = load_interactions(dummy_dir)
    cfg = tconfig.Config(data=dummy_dir, emb_size=D, seed=3).finalize()
    a = LightGCN(cfg, data, device='cpu')
    b = LightGCN(cfg, data, device='cpu')
    assert a.user_emb.shape == (data.n_users, D)
    assert a.item_emb.shape == (data.n_items, D)
    assert torch.equal(a.user_emb, b.user_emb)
    big = torch.randn(100_000, generator=torch.Generator().manual_seed(3))
    assert abs(float((0.1 * big).std()) - 0.1) < 1e-3
    assert 0.05 < float(a.item_emb.detach().std()) < 0.15
