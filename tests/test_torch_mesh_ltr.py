"""The LTR heads on the port's mesh (``ltr_linear``, ``ltr_pop`` with
``--mesh``: the tables row-sharded over K2's source shards, the tower and
the text and popularity buffers whole) against the JAX package and the
port's single card, on the CPU.

Ranks are gloo processes at W = 2 and W = 4, started once per W for both
heads (``tests/helpers/torch_mesh_conv_worker.py``); the JAX side runs
here while they do.  ``data/dummy`` (a copy, with its embedding caches)
padded to 16 rows, d = 16, 3 layers, a (4,)-wide tower.

* The fused catalogue-sharded top-k (``u_cat`` against each rank's rows
  of ``i_cat``, ``parallel.sharded.sharded_topk``, the bias added) equals
  the single card's ``topk_for_users`` on the same params: values 1e-6,
  indices where the values are distinct and finite; with the head off,
  the plain sharded top-k equals ``lgcn``'s.
* One ``ltr_pop --freeze`` step at W = 4 moves the tower as the JAX
  package's step does (weights 1e-5; not the biases nor the user
  popularity's weights, whose gradients are rounding noise that Adam
  scales to steps of ~lr, as ``tests/test_torch_ltr.py`` says of the
  biases) and leaves the tables bit for bit.
* ``ltr_pop --load_base --freeze --mesh 2x2`` through the CLI repeats the
  single-process run (loss sums 1e-5 relative, metrics 1e-6); ``--mesh
  1x1`` in-process repeats the single card for both heads.
"""

import logging
import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ltr import _base_checkpoint, _jax_hash_weights
from test_torch_mesh_conv import HELPERS, PAD, PAIRS, SPAWN_TIMEOUT, _join
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data import text as jax_text
from textgcn_tpu.models.ltr import LTRLinear as JaxLTRLinear
from textgcn_tpu.models.ltr import LTRLinearWPop as JaxLTRLinearWPop
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data import text
from textgcn_tpu_torch.models.lightgcn import LightGCN
from textgcn_tpu_torch.models.ltr import LTRLinear, LTRLinearWPop
from textgcn_tpu_torch.parallel import mesh as tmesh
from textgcn_tpu_torch.parallel import multihost
from textgcn_tpu_torch.weights import params_from_jax

D = 16
LAYERS = (4,)
REG, LR = 1e-3, 1e-2
# ltr_pop's feature index of the user's popularity
USER_POPULARITY = 5
HEADS = {'ltr_linear': (JaxLTRLinear, LTRLinear),
         'ltr_pop': (JaxLTRLinearWPop, LTRLinearWPop)}


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def _cfgs(data_dir, name):
    common = dict(model=name, data=str(data_dir), emb_size=D, n_layers=3,
                  dropout=0.4, reg_lambda=REG, lr=LR, ltr_layers=LAYERS,
                  freeze=True, save_path='/nonexistent')
    return (JaxConfig(**common).finalize(),
            tconfig.Config(save=False, k=(3,), **common).finalize())


def _inputs(dummy_copy, base):
    rng = np.random.RandomState(15)
    params = {}
    for name, (jcls, _) in HEADS.items():
        jc, _ = _cfgs(dummy_copy, name)
        jm = jcls(jc, jax_text.load_ltr_data(jc))
        p = jax.tree.map(np.asarray, jm.init_params(jax.random.key(4)))
        for t in ('user_emb', 'item_emb'):
            p[t] = (0.3 * rng.randn(*p[t].shape)).astype(np.float32)
        params[name] = p
    data = text.load_ltr_data(_cfgs(dummy_copy, 'ltr_pop')[1])
    b = 13
    users = rng.randint(0, data.n_users, b)
    pos = np.array([data.pos_padded[u][rng.randint(data.pos_degree[u])]
                    for u in users])
    return {
        'kind': 'ltr', 'dummy': dummy_copy, 'pad': PAD, 'd': D, 'reg': REG,
        'lr': LR, 'pairs': PAIRS, 'ltr_layers': LAYERS, 'params': params,
        'batch': (users, pos, rng.randint(0, data.n_items, (b, 2))),
        'cli_argv': ['--model', 'ltr_pop', '--load_base', base, '--freeze',
                     '--data', dummy_copy, '--epochs', '4',
                     '--evaluate_every', '2', '--batch_size', '16',
                     '--emb_size', str(D), '-k', '3', '5', '--quiet',
                     '--predict', '--export_reprs'],
    }


def _jax_freeze_step(inp):
    """One ``ltr_pop --freeze`` step of the JAX package with the hash
    weights of ``PAIRS``: ``optax.multi_transform`` of adam on the tower
    and ``set_to_zero`` on the tables."""
    jc, _ = _cfgs(inp['dummy'], 'ltr_pop')
    jm = JaxLTRLinearWPop(jc, jax_text.load_ltr_data(jc))
    plain = jm.graph_op.weights
    jm.graph_op.weights = lambda key, dropout: (
        _jax_hash_weights(jm.graph_op, PAIRS) if dropout > 0
        else plain(key, dropout))
    jp = jax.tree.map(jnp.asarray, inp['params']['ltr_pop'])
    labels = jax.tree.map(lambda t: 'train' if t else 'frozen',
                          jm.trainable_mask(jp))
    opt = optax.multi_transform({'train': optax.adam(LR),
                                 'frozen': optax.set_to_zero()}, labels)
    users, pos, negs = (jnp.asarray(a, jnp.int32) for a in inp['batch'])
    grads = jax.grad(lambda p: jm.loss(p, (
        users, pos, negs, jnp.ones(users.shape[0], bool)),
        jax.random.key(0))[0])(jp)
    updates, _ = opt.update(grads, opt.init(jp), jp)
    return jax.tree.map(np.asarray, optax.apply_updates(jp, updates))


@pytest.fixture(scope='module')
def dummy_copy(tmp_path_factory, dummy_dir):
    out = tmp_path_factory.mktemp('mesh_ltr') / 'dummy'
    shutil.copytree(dummy_dir, out)
    return str(out)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, dummy_copy):
    sys.path.insert(0, HELPERS)
    import torch_mesh_conv_worker
    base = str(tmp_path_factory.mktemp('mesh_ltr_base') / 'base.pkl')
    _base_checkpoint(base, text.load_ltr_data(
        _cfgs(dummy_copy, 'ltr_pop')[1]))
    inp = _inputs(dummy_copy, base)
    dirs = {w: tmp_path_factory.mktemp(f'mesh_ltr{w}') for w in (2, 4)}
    for d in dirs.values():
        with open(d / 'inputs.pkl', 'wb') as f:
            pickle.dump(inp, f)
    contexts = [mp.start_processes(torch_mesh_conv_worker.run,
                                   args=(w, str(d)), nprocs=w, join=False,
                                   start_method='spawn')
                for w, d in dirs.items()]
    try:
        step = _jax_freeze_step(inp)
    finally:
        _join(contexts, SPAWN_TIMEOUT)
    out = {'inputs': inp, 'dirs': dirs, 'jax_step': step}
    for w, d in dirs.items():
        out[w] = []
        for r in range(w):
            with open(d / f'rank{r}.pkl', 'rb') as f:
                out[w].append(pickle.load(f))
    return out


def _single(inp, name):
    """The port's single-card head on the same params."""
    _, tc = _cfgs(inp['dummy'], name)
    data = text.load_ltr_data(tc)
    model = HEADS[name][1](tc, data, device='cpu')
    model.load_params(params_from_jax(inp['params'][name], data.n_users,
                                      data.n_items))
    return model


def _assert_same_topk(got, want):
    got_v, got_i = got
    want_v, want_i = (t.numpy() for t in want)
    np.testing.assert_allclose(got_v, want_v, atol=1e-6, rtol=0)
    distinct = np.array([[np.isfinite(v) and np.sum(row == v) == 1
                          for v in row] for row in want_v])
    assert distinct.any()
    assert (got_i[distinct] == want_i[distinct]).all()


@pytest.mark.parametrize('name', list(HEADS))
def test_fused_sharded_topk_equals_the_single_card_head(ranks, name):
    model = _single(ranks['inputs'], name)
    users = torch.arange(model.n_users)
    with torch.no_grad():
        reprs = model.scoring_reprs()
        want = model.topk_for_users(reprs, users, 5)
        model.score_with_head = False
        want_plain = LightGCN.topk_for_users(model, reprs, users, 5)
    for w in (2, 4):
        for got in ranks[w]:
            _assert_same_topk(got['ltr'][name]['head'], want)
            _assert_same_topk(got['ltr'][name]['plain'], want_plain)


@pytest.mark.parametrize('name', list(HEADS))
def test_fused_sharded_topk_on_one_rank_is_topk_for_users(ranks, name):
    """In a one-rank group the fused sharded path gives the values of the
    unsharded head's ``topk_for_users`` (1e-6) and its indices."""
    inp = ranks['inputs']
    single = _single(inp, name)
    _, tc = _cfgs(inp['dummy'], name)
    data = text.load_ltr_data(tc).padded_to(1)
    mesh, created = tmesh.make_mesh((1, 1), 'cpu')
    try:
        model = tmesh.shard_model(mesh, HEADS[name][1](tc, data,
                                                       device='cpu'), data)
        model.load_params(params_from_jax(inp['params'][name], data.n_users,
                                          data.n_items))
        users = torch.arange(data.n_users)
        with torch.no_grad():
            got = model.topk_for_users(model.scoring_reprs(), users, 5)
    finally:
        if created:
            dist.destroy_process_group()
    with torch.no_grad():
        want = single.topk_for_users(single.scoring_reprs(), users, 5)
    _assert_same_topk([t.numpy() for t in got], want)


def test_one_ltr_pop_freeze_step_at_w4_matches_jax(ranks):
    want = ranks['jax_step']
    base = ranks['inputs']['params']['ltr_pop']
    for got in ranks[4]:
        got = got['ltr']['ltr_pop']['after_step']
        for t in ('user_emb', 'item_emb'):
            np.testing.assert_array_equal(got[t], base[t])
        # the first layer's row of the user's popularity is left out with
        # the biases: the feature adds the same to a positive's and a
        # negative's score, so its weights' gradients are rounding noise
        first = np.arange(len(want['tower'][0]['w'])) != USER_POPULARITY
        for layer, (g, w, b) in enumerate(zip(got['tower'], want['tower'],
                                              base['tower'])):
            rows = first if layer == 0 else slice(None)
            np.testing.assert_allclose(g['w'][rows], w['w'][rows],
                                       atol=1e-5, rtol=0)
            assert not np.array_equal(g['w'], b['w'])


def test_ltr_pop_mesh_cli_matches_the_single_process_run(ranks, tmp_path,
                                                         monkeypatch):
    """``ltr_pop --load_base --freeze --mesh 2x2`` on 4 gloo ranks against
    the port's single-process run: the base's evaluation, the loss sums
    (1e-5 relative) and the metrics (1e-6); rank 0 alone wrote, its
    exported factors are the single run's (1e-6), and its ``best.pkl``
    serves its epoch's metrics through the non-mesh port CLI and the JAX
    CLI."""
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    single = port_main(ranks['inputs']['cli_argv'] + ['--uid', 'single'])
    for got in ranks[4]:
        got = got['cli']
        np.testing.assert_allclose(
            [h['loss'] for h in got['loss_history']],
            [h['loss'] for h in single.loss_history], rtol=1e-5, atol=0)
        for name, v in single.last_metrics.items():
            np.testing.assert_allclose(got['metrics'][name], v, atol=1e-6,
                                       rtol=0)
    mesh_dir = ranks['dirs'][4]
    run = mesh_dir / 'cwd0' / 'runs' / 'dummy' / 'mesh'
    want = tmp_path / 'runs' / 'dummy' / 'single'
    assert sorted(p.name for p in run.iterdir()) == sorted(
        p.name for p in want.iterdir())
    for r in (1, 2, 3):
        assert not (mesh_dir / f'cwd{r}' / 'runs').exists()
    for name in ('ltr_user_factors', 'ltr_item_factors', 'ltr_bias',
                 'users_repr', 'items_repr'):
        np.testing.assert_allclose(np.load(run / f'{name}.npy'),
                                   np.load(want / f'{name}.npy'), atol=1e-6,
                                   rtol=0, err_msg=name)
    logger = ranks[4][0]['cli']['metrics_logger']
    best = max(i for i, v in enumerate(logger['recall'][:, 0])
               if v >= logger['recall'][:, 0].max())
    serve = ['--model', 'ltr_pop', '--data', ranks['inputs']['dummy'],
             '--emb_size', str(D), '-k', '3', '5', '--batch_size', '16',
             '--quiet', '--no_train', '--load', str(run)]
    served = port_main(serve + ['--uid', 'served'])
    jax_served = jax_main(serve + ['--uid', 'jax']).evaluate()
    for name, v in served.last_metrics.items():
        np.testing.assert_allclose(v, logger[name][best], atol=1e-6, rtol=0)
        np.testing.assert_allclose(jax_served[name], logger[name][best],
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize('name', list(HEADS))
def test_mesh_1x1_in_process_equals_the_single_card_run(
        ranks, tmp_path, monkeypatch, name):
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    argv = [a if a != 'ltr_pop' else name
            for a in ranks['inputs']['cli_argv']]
    argv = [*argv[:argv.index('--freeze')], *argv[argv.index('--freeze')
                                                   + 1:]]   # unfrozen
    single = port_main(argv + ['--uid', 'single'])
    mesh = port_main(argv + ['--uid', 'mesh', '--mesh', '1x1'])
    assert not dist.is_initialized()
    assert mesh.model.mesh.shape == (1, 1)
    np.testing.assert_allclose([h['loss'] for h in mesh.loss_history],
                               [h['loss'] for h in single.loss_history],
                               rtol=1e-5, atol=0)
    for k, v in single.last_metrics.items():
        np.testing.assert_allclose(mesh.last_metrics[k], v, atol=1e-6,
                                   rtol=0)
