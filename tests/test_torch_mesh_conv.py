"""The conv family on the port's mesh (``--mesh``: ``gcn``, ``graphsage``
mean|sum|max, ``gat``, ``gatv2`` over ``parallel/sharded_conv.MeshConvOp``)
against the JAX package and the port's single card, on the CPU.

Ranks are gloo processes started with ``torch.multiprocessing`` over a
``file://`` store, once at W = 2 and once at W = 4, each running
``tests/helpers/torch_mesh_conv_worker.py``; the JAX side runs here
while they do.  Both sides take the same tables, layers, batch and
dropout salts, made here with numpy, on ``data/dummy`` padded to 16 rows
(2 layers, d = 8).

* With the salts, every rank's whole representation (1e-5), loss and
  gradients of the tables and conv layers (1e-4) equal the JAX package's
  exact-f32 single-device ``ConvModel`` with the hash masks injected; at
  dropout 0 they also equal the JAX package's own mesh path
  (``shard_model`` on a (1, 4) CPU mesh, GSPMD).
* Phantom rows (padding) reach no real row, no loss and no score.
* ``MeshConvOp``'s masks and kept degrees are the single card's, bit for
  bit.
* ``gat --mesh 2x2`` through the CLI repeats the single-process run
  (loss sums 1e-5 relative, metrics 1e-6); rank 0 alone writes, and its
  ``best.pkl`` serves through the non-mesh CLI and the JAX CLI; a
  ``--resume``d ``gcn --mesh 1x2`` run is bit-equal to the uninterrupted
  one; ``--mesh 1x1`` in-process repeats the single card; every model
  takes ``--mesh``, and ``--help`` names no model beside it.
"""

import logging
import os
import pickle
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data.core import load_interactions as jax_load
from textgcn_tpu.models.conv import ConvModel as JaxConvModel
from textgcn_tpu.models.conv import conv_layer as jax_conv_layer
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu.parallel.mesh import make_mesh as jax_mesh
from textgcn_tpu.parallel.mesh import shard_model as jax_shard_model
from textgcn_tpu.parallel.mesh import shard_params
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.ops import gat
from textgcn_tpu_torch.ops.spmm import GraphOp, edge_mask, kept_degree
from textgcn_tpu_torch.parallel import multihost
from textgcn_tpu_torch.parallel.mesh import Mesh
from textgcn_tpu_torch.parallel.sharded_conv import MeshConvOp
from textgcn_tpu_torch.parallel.sharded_spmm import MeshGraphOp

HELPERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'helpers')
SALT = 0x9E3779B9
KEEP = float(np.float32(1.0 - 0.4))
PAIRS = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))
PAD = 16          # dummy's 12 users and 10 items, padded for W = 2 and 4
D = 8
REG, LR = 1e-3, 1e-2
CONVS = [('gcn', 'mean'), ('graphsage', 'mean'), ('graphsage', 'sum'),
         ('graphsage', 'max'), ('gat', 'mean'), ('gatv2', 'mean')]
CONV_IDS = [f'{c}-{a}' for c, a in CONVS]
SHAPES = {
    'gcn': {'w': 2, 'b': 1},
    'graphsage': {'w_nbr': 2, 'w_root': 2, 'b': 1},
    'gat': {'w': 2, 'a_src': 1, 'a_dst': 1, 'b': 1},
    'gatv2': {'w_src': 2, 'w_dst': 2, 'a': 1, 'b': 1},
}
SPAWN_TIMEOUT = 240
EPOCHS = 4


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def _inputs(dummy_dir):
    rng = np.random.RandomState(14)
    data = load_interactions(dummy_dir)
    nu, ni = data.n_users, data.n_items
    f = lambda *s: (0.3 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    params = {conv: {'user_emb': f(nu, D), 'item_emb': f(ni, D),
                     'convs': [{k: f(*(D,) * n)
                                for k, n in SHAPES[conv].items()}
                               for _ in range(2)]}
              for conv in SHAPES}
    b = 13
    users = rng.randint(0, nu, b)
    pos = np.array([data.pos_padded[u][rng.randint(data.pos_degree[u])]
                    for u in users])
    common = ['--data', dummy_dir, '--evaluate_every', '2', '--batch_size',
              '16', '--emb_size', '16', '-k', '3', '5', '--quiet']
    return {
        'kind': 'conv', 'dummy': dummy_dir, 'pad': PAD, 'd': D, 'reg': REG,
        'lr': LR, 'pairs': PAIRS, 'convs': CONVS, 'params': params,
        'batch': (users, pos, rng.randint(0, ni, (b, 2))),
        'cli_argv': ['--model', 'gat', '--aggr', 'mean', '--epochs', '4',
                     '--predict', *common],
        'resume_argv': ['--model', 'gcn', '--aggr', 'mean', *common],
        'epochs': EPOCHS,
    }


def _mask01(eu, ei, salt):
    return (jax_scale(jnp.asarray(eu), jnp.asarray(ei), jnp.uint32(salt),
                      jnp.float32(KEEP)) > 0).astype(jnp.float32)


def _jax_cfg(dummy_dir, conv, aggr, dropout):
    return JaxConfig(model=conv, aggr=aggr, data=dummy_dir, emb_size=D,
                     lr=LR, reg_lambda=REG, dropout=dropout, n_layers=2,
                     save_path='/nonexistent').finalize()


def _jax_batch(inp):
    users, pos, negs = (jnp.asarray(a, jnp.int32) for a in inp['batch'])
    return users, pos, negs, jnp.ones(users.shape[0], bool)


def _jax_hashed(inp, conv, aggr):
    """The JAX package's exact-f32 single-device ``ConvModel`` with the
    hash masks of ``PAIRS`` injected: representation, loss, gradients."""
    jm = JaxConvModel(_jax_cfg(inp['dummy'], conv, aggr, 0.4),
                      jax_load(inp['dummy']))
    e = jm.conv_edges
    m_u, m_i = (_mask01(e['edge_user'], e['edge_item'], s)
                for s, _ in PAIRS)

    def hashed(params, *, training=False, dropout_key=None):
        return jm._layer_combine(params, lambda lp, u, i: jax_conv_layer(
            lp, conv, aggr, u, i, e['edge_user'], e['edge_item'], m_u, m_i,
            e['edge_weight']))

    jm.representation = hashed
    jp = jax.tree.map(jnp.asarray, inp['params'][conv])
    u, i = hashed(jp, training=True)
    (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, _jax_batch(inp), jax.random.key(0))
    return {'u': np.asarray(u), 'i': np.asarray(i), 'loss': float(loss),
            'grads': jax.tree.map(np.asarray, grads)}


def _jax_mesh(inp, conv, aggr, n_ranks):
    """The JAX package's own mesh path at dropout 0 (``shard_model``:
    GSPMD over row-sharded tables) on a (1, n_ranks) CPU mesh."""
    mesh = jax_mesh((1, n_ranks))
    jm = JaxConvModel(_jax_cfg(inp['dummy'], conv, aggr, 0.0),
                      jax_load(inp['dummy']).padded_to(PAD))
    assert (jm.n_users_t, jm.n_items_t) == (PAD, PAD)
    jax_shard_model(mesh, jm)
    params = dict(inp['params'][conv])
    for name in ('user_emb', 'item_emb'):
        t = np.zeros((PAD, D), np.float32)
        t[:len(params[name])] = params[name]
        params[name] = t
    jp = shard_params(mesh, jax.tree.map(jnp.asarray, params))

    def f(p):
        loss, _ = jm.loss(p, _jax_batch(inp), jax.random.key(0))
        return loss, jm.representation(p, training=True)

    (loss, (u, i)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jp)
    grads = jax.tree.map(np.asarray, grads)
    data = jax_load(inp['dummy'])
    grads['user_emb'] = grads['user_emb'][:data.n_users]
    grads['item_emb'] = grads['item_emb'][:data.n_items]
    return {'u': np.asarray(u)[:data.n_users],
            'i': np.asarray(i)[:data.n_items],
            'loss': float(loss), 'grads': grads}


def _join(contexts, timeout):
    deadline = time.monotonic() + timeout
    try:
        for ctx in contexts:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f'mesh ranks still running after '
                                       f'{timeout} s')
    finally:
        for ctx in contexts:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, dummy_dir):
    """``{W: [rank 0's results, ...]}`` for W = 2 and 4, the inputs, the
    directories, and the JAX side's results (made while the ranks run)."""
    sys.path.insert(0, HELPERS)
    import torch_mesh_conv_worker
    inp = _inputs(dummy_dir)
    dirs = {w: tmp_path_factory.mktemp(f'mesh_conv{w}') for w in (2, 4)}
    for d in dirs.values():
        with open(d / 'inputs.pkl', 'wb') as f:
            pickle.dump(inp, f)
    contexts = [mp.start_processes(torch_mesh_conv_worker.run,
                                   args=(w, str(d)), nprocs=w, join=False,
                                   start_method='spawn')
                for w, d in dirs.items()]
    try:
        jax_out = {(c, a): {'hashed': _jax_hashed(inp, c, a),
                            'mesh': _jax_mesh(inp, c, a, 4)}
                   for c, a in CONVS}
    finally:
        _join(contexts, SPAWN_TIMEOUT)
    out = {'inputs': inp, 'dirs': dirs, 'jax': jax_out}
    for w, d in dirs.items():
        out[w] = []
        for r in range(w):
            with open(d / f'rank{r}.pkl', 'rb') as f:
                out[w].append(pickle.load(f))
    return out


def _assert_matches(got, want):
    np.testing.assert_allclose(got['u'], want['u'], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got['i'], want['i'], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4,
                               atol=1e-6)
    g, w = got['grads'], want['grads']
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(g[name], w[name], atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    for lg, lw in zip(g['convs'], w['convs']):
        assert sorted(lg) == sorted(lw)
        for k in lg:
            np.testing.assert_allclose(lg[k], lw[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)


# --- the layers against the JAX package ---------------------------------------

@pytest.mark.parametrize('conv, aggr', CONVS, ids=CONV_IDS)
def test_mesh_conv_matches_jax_with_the_hash_masks(ranks, conv, aggr):
    """Every rank at W = 2 and 4, at keep 0.6: representation 1e-5, loss
    and the gradients of both tables and every conv layer 1e-4."""
    want = ranks['jax'][conv, aggr]['hashed']
    for w in (2, 4):
        for got in ranks[w]:
            _assert_matches(got['conv'][conv, aggr, 0.4], want)


@pytest.mark.parametrize('conv, aggr', CONVS, ids=CONV_IDS)
def test_mesh_conv_at_dropout_0_matches_the_jax_mesh_path(ranks, conv,
                                                          aggr):
    want = ranks['jax'][conv, aggr]['mesh']
    for got in ranks[4]:
        _assert_matches(got['conv'][conv, aggr, 0.0], want)


@pytest.mark.parametrize('conv, aggr', CONVS, ids=CONV_IDS)
def test_phantom_rows_reach_no_real_row_loss_or_score(ranks, conv, aggr):
    """The padded rows' values set to 100 x N(0, 1): the real rows of the
    representation, the loss and the top-5 of every user are unchanged,
    bit for bit."""
    for w in (2, 4):
        for got in ranks[w]:
            for name, (before, after) in got['conv'][
                    conv, aggr, 0.4]['phantom'].items():
                np.testing.assert_array_equal(after, before, err_msg=name)


# --- MeshConvOp ------------------------------------------------------------------

@pytest.mark.parametrize('n_ranks', [2, 4])
def test_mesh_conv_op_masks_and_degrees_are_the_single_cards(ranks,
                                                             dummy_dir,
                                                             n_ranks):
    """Each rank's shards hold exactly the single card's edges into its
    rows, with the same hash masks; its kept degrees on its rows, and the
    whole ones it gathers, are the single card's, bit for bit."""
    g = load_interactions(dummy_dir).graph
    single = GraphOp(g.edge_user, g.edge_item, np.ones(g.n_edges,
                                                       np.float32),
                     PAD, PAD, 'cpu')
    for direction, (salt, keep) in zip(('to_user', 'to_item'), PAIRS):
        fwd, bwd = single.csr_pair(direction)
        rows, col, kept = edge_mask(fwd, salt, keep)
        t_rows, t_col, t_kept = edge_mask(bwd, salt, keep)
        want_deg = kept_degree(fwd, salt, keep)
        degs = []
        for r in range(n_ranks):
            mesh = Mesh((1, n_ranks), r, torch.device('cpu'))
            op = MeshConvOp(g.edge_user, g.edge_item, PAD, PAD, mesh)
            own = mesh.rows(PAD)
            s_fwd, s_bwd = op.csr_pair(direction)
            assert s_fwd.n_dst == s_bwd.n_src == PAD
            sel = (rows >= own.start) & (rows < own.stop)
            got = edge_mask(s_fwd, salt, keep)
            for a, b in zip(got, (rows[sel], col[sel], kept[sel])):
                assert torch.equal(a, b)
            # the shard's own transpose: the same edges, by source row
            t_sel = (t_col >= own.start) & (t_col < own.stop)
            got_t = edge_mask(s_bwd, salt, keep)
            for a, b in zip(got_t, (t_rows[t_sel], t_col[t_sel],
                                    t_kept[t_sel])):
                assert torch.equal(a, b)
            deg = kept_degree(s_fwd, salt, keep)
            assert not deg[:own.start].any() and not deg[own.stop:].any()
            degs.append(deg[own])
        assert torch.equal(torch.cat(degs), want_deg)
    want = [kept_degree(single.csr_pair(d)[0], s, k).numpy()
            for d, (s, k) in zip(('to_user', 'to_item'), PAIRS)]
    for got in ranks[n_ranks]:
        for a, b in zip(got['conv']['degrees'], want):
            np.testing.assert_array_equal(a, b)


def test_source_shards_refuse_an_attention_layer(dummy_dir):
    g = load_interactions(dummy_dir).graph
    op = MeshGraphOp(g.edge_user, g.edge_item, g.edge_weight, PAD, PAD,
                     Mesh((1, 2), 0, torch.device('cpu')))
    with pytest.raises(NotImplementedError, match='MeshConvOp'):
        gat.gat_direction(op, 'to_user', torch.zeros(PAD, D),
                          torch.zeros(PAD, D), torch.zeros(PAD),
                          torch.zeros(PAD), torch.zeros(PAD), 0, 1.0)


# --- the CLI ----------------------------------------------------------------------

def test_mesh_conv_cli_matches_the_single_process_run(ranks, tmp_path,
                                                      monkeypatch):
    """``gat --mesh 2x2`` on 4 gloo ranks against the port's single-process
    run: loss sums 1e-5 relative, metrics 1e-6; rank 0 alone wrote files,
    and its ``best.pkl`` serves its epoch's metrics through the non-mesh
    port CLI and through the JAX CLI."""
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    argv = ranks['inputs']['cli_argv']
    single = port_main(argv + ['--uid', 'single'])
    want_loss = [h['loss'] for h in single.loss_history]
    for got in ranks[4]:
        got = got['cli']
        np.testing.assert_allclose([h['loss'] for h in got['loss_history']],
                                   want_loss, rtol=1e-5, atol=0)
        for name, v in single.last_metrics.items():
            np.testing.assert_allclose(got['metrics'][name], v, atol=1e-6,
                                       rtol=0)
    mesh_dir = ranks['dirs'][4]
    run = mesh_dir / 'cwd0' / 'runs' / 'dummy' / 'mesh'
    assert sorted(p.name for p in run.iterdir()) == sorted(
        p.name for p in (tmp_path / 'runs' / 'dummy' / 'single').iterdir())
    for r in (1, 2, 3):
        assert not (mesh_dir / f'cwd{r}' / 'runs').exists()
    logger = ranks[4][0]['cli']['metrics_logger']
    best = max(i for i, v in enumerate(logger['recall'][:, 0])
               if v >= logger['recall'][:, 0].max())
    serve = ['--model', 'gat', '--aggr', 'mean', '--data',
             ranks['inputs']['dummy'], '--emb_size', '16', '-k', '3', '5',
             '--batch_size', '16', '--quiet', '--no_train', '--load',
             str(run)]
    served = port_main(serve + ['--uid', 'served'])
    jax_served = jax_main(serve + ['--uid', 'jax']).evaluate()
    for name, v in served.last_metrics.items():
        np.testing.assert_allclose(v, logger[name][best], atol=1e-6, rtol=0)
        np.testing.assert_allclose(jax_served[name], logger[name][best],
                                   atol=1e-6, rtol=0)


def test_resume_of_a_gcn_mesh_run_at_w2_is_bit_equal(ranks):
    for got in ranks[2]:
        full, half, resumed = (got['resume'][k]
                               for k in ('full', 'half', 'resumed'))
        assert len(full['loss_history']) == EPOCHS
        assert half['loss_history'] == full['loss_history'][:EPOCHS // 2]
        assert resumed['loss_history'] == full['loss_history'][EPOCHS // 2:]
        for name, rows in full['metrics_logger'].items():
            np.testing.assert_array_equal(resumed['metrics_logger'][name],
                                          rows)
        for name in ('user_emb', 'item_emb'):
            np.testing.assert_array_equal(resumed['params'][name],
                                          full['params'][name])
        for a, b in zip(resumed['params']['convs'], full['params']['convs']):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(half['params']['convs'][0]['w'],
                                  full['params']['convs'][0]['w'])
    a, b = ranks[2]
    for x, y in zip(a['resume']['full']['params']['convs'],
                    b['resume']['full']['params']['convs']):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize('conv, aggr', [('gcn', 'mean'), ('graphsage', 'max'),
                                        ('gat', 'mean'), ('gatv2', 'mean')])
def test_mesh_1x1_in_process_equals_the_single_card_run(
        tmp_path, monkeypatch, dummy_dir, conv, aggr):
    """``--mesh 1x1`` starts a one-rank group in-process: a rank's shards
    are the whole graph, so the run repeats the single card's (loss sums
    1e-5 relative, as at W = 4: a table's gradient adds its parts in
    another order through the gathers; metrics 1e-6)."""
    import torch.distributed as dist

    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    common = ['--model', conv, '--aggr', aggr, '--data', dummy_dir,
              '--epochs', '2', '--batch_size', '16', '--emb_size', '16',
              '-k', '3', '--quiet', '--evaluate_every', '1']
    single = port_main(common + ['--uid', 'single'])
    mesh = port_main(common + ['--uid', 'mesh', '--mesh', '1x1'])
    assert not dist.is_initialized()
    assert isinstance(mesh.model.graph_op, MeshConvOp)
    np.testing.assert_allclose([h['loss'] for h in mesh.loss_history],
                               [h['loss'] for h in single.loss_history],
                               rtol=1e-5, atol=0)
    for name, v in single.last_metrics.items():
        np.testing.assert_allclose(mesh.last_metrics[name], v, atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize('model', tconfig.MODEL_CHOICES)
def test_mesh_parses_for_every_model(model, capsys):
    """Every registry model takes ``--mesh``, and ``--help`` names none of
    them beside it (the JAX package's words)."""
    extra = {'gcn': ['--aggr', 'mean'], 'graphsage': ['--aggr', 'max'],
             'gat': ['--aggr', 'mean'], 'gatv2': ['--aggr', 'mean'],
             'ltr_simple': ['--load_base', 'base']}.get(model, [])
    cfg = tconfig.parse_args(['--model', model, '--mesh', '2x2', *extra])
    assert cfg.mesh_shape == (2, 2)
    with pytest.raises(SystemExit):
        tconfig.parse_args(['--help'])
    text = capsys.readouterr().out
    start = text.index('\n  --mesh MESH')
    mesh_help = text[start:text.index('\n  --no_pallas', start)]
    assert 'DATAxMODEL' in ' '.join(mesh_help.split())
    words = set(mesh_help.replace(',', ' ').split())
    assert not words & set(tconfig.MODEL_CHOICES), mesh_help
