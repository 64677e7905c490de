"""The text-loss models, the concat scorers and the probes on the port's
mesh (``text --pos user``, ``kg``, ``reviews``, ``ltr_reviews``,
``ltr_kg``, ``text_probe``, ``ltr_simple`` with ``--mesh``: the tables
row-sharded over K2's source shards, the text buffers and the (item,
user) review table whole on every rank) against the JAX package and the
port's single card, on the CPU.

Ranks are gloo processes at W = 2 and W = 4, started once per W
(``tests/helpers/torch_mesh_conv_worker.py``); the JAX side (its
exact-f32 XLA op with the hash weights) runs here while they do.
``data/dummy`` (a copy, with its embedding caches) padded to 16 rows, d =
16, 3 layers, ``--weight '(p-n)' --distance 'selu(g-b)'``.

* One step from the same tables, batch and salts: the ranks' losses and
  their ``bpr``, ``sem`` and ``reg`` terms sum to the single process's and
  the JAX package's (1e-5 relative), the gradients of both tables agree
  (1e-5).
* The concat scorers' fused catalogue-sharded top-5 of every user equals
  the single card's (values 1e-6, indices where the values are distinct
  and finite); with the head off, the plain sharded top-5.
* ``text_probe`` and ``ltr_simple --load_base`` at ``--mesh 1x2`` and
  ``2x2``: every metric of every probe equals the single process's
  (1e-6).
* ``text --pos user``, ``ltr_kg`` and ``reviews`` through the CLI repeat
  the single-process runs (loss sums and their ``sem`` 1e-5 relative,
  metrics 1e-6); rank 0 alone writes, and ``ltr_kg``'s exported concat
  factors are the single run's (1e-6); ``--mesh 1x1`` in-process repeats
  the single card.
"""

import logging
import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ltr import _base_checkpoint, _batch, _jax_hash_weights
from test_torch_mesh_conv import HELPERS, PAD, SPAWN_TIMEOUT, _join
from test_torch_mesh_ltr import _assert_same_topk
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data import text as jax_text
from textgcn_tpu.models import ltr_concat as jax_lc
from textgcn_tpu.models import text_loss as jax_tl
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data import text
from textgcn_tpu_torch.models.lightgcn import LightGCN
from textgcn_tpu_torch.parallel import multihost
from textgcn_tpu_torch.registry import get_class
from textgcn_tpu_torch.weights import params_from_jax

D = 16
REG, LR = 1e-3, 1e-2
SALT = 0x9E3779B9
KEEP = float(np.float32(1.0 - 0.4))
PAIRS = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))
FORMULAS = {'weight': '(p-n)', 'distance': 'selu(g-b)'}
# name: (model, its flags), and the JAX class
MODELS = {'text_user': ('text', {'pos': 'user'}, jax_tl.TextModel),
          'kg': ('kg', {}, jax_tl.TextModelKG),
          'reviews': ('reviews', {}, jax_tl.TextModelReviews),
          'ltr_reviews': ('ltr_reviews', {}, jax_lc.LTRCosine),
          'ltr_kg': ('ltr_kg', {}, jax_lc.LTRCosine)}
CONCAT = ('ltr_reviews', 'ltr_kg')
WORLDS = (2, 4)
# the ranks also train through the CLI: twice the conv file's limit
RANKS_TIMEOUT = 2 * SPAWN_TIMEOUT
PROBES = ('text_probe', 'ltr_simple')
# the training runs through the CLI: uid, flags, the W and mesh shape
TRAINED = {'text_user': (['--model', 'text', '--pos', 'user'], 4, '2x2'),
           'ltr_kg': (['--model', 'ltr_kg', '--predict', '--export_reprs'],
                      4, '2x2'),
           'reviews': (['--model', 'reviews'], 2, '2x1')}


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def _configs(dummy_copy, name):
    model, kw, _ = MODELS[name]
    common = dict(model=model, data=dummy_copy, emb_size=D, n_layers=3,
                  dropout=0.4, reg_lambda=REG, lr=LR, k=(3, 5),
                  save_path='/nonexistent', **FORMULAS, **kw)
    return (JaxConfig(**common).finalize(),
            tconfig.Config(save=False, **common).finalize())


def _common(dummy_copy):
    return ['--data', dummy_copy, '--evaluate_every', '2', '--batch_size',
            '16', '--emb_size', str(D), '-k', '3', '5', '--quiet',
            '--weight', FORMULAS['weight'], '--distance',
            FORMULAS['distance']]


def _inputs(dummy_copy, base):
    rng = np.random.RandomState(17)
    data = text.load_ltr_data(_configs(dummy_copy, 'kg')[1])
    f = lambda *s: (0.3 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    params = {name: {'user_emb': f(data.n_users, D),
                     'item_emb': f(data.n_items, D)} for name in MODELS}
    common = _common(dummy_copy)
    cli_runs = [('text_probe', ['--model', 'text_probe', *common],
                 {2: '1x2', 4: '2x2'}),
                ('ltr_simple', ['--model', 'ltr_simple', '--load_base', base,
                                *common], {2: '1x2', 4: '2x2'})]
    cli_runs += [(uid, [*flags, '--epochs', '4', *common], {w: shape})
                 for uid, (flags, w, shape) in TRAINED.items()]
    return {
        'kind': 'text', 'dummy': dummy_copy, 'pad': PAD, 'd': D, 'reg': REG,
        'lr': LR, 'pairs': PAIRS, 'formulas': FORMULAS, 'params': params,
        'text_models': {n: (m, kw) for n, (m, kw, _) in MODELS.items()},
        'batch': _batch(data, seed=18, b=13), 'cli_runs': cli_runs,
    }


def _jax_steps(inp):
    """Each model's JAX loss, components and gradients with the hash
    weights of ``PAIRS``."""
    jd = jax_text.load_ltr_data(_configs(inp['dummy'], 'kg')[0])
    users, pos, negs = (jnp.asarray(a, jnp.int32) for a in inp['batch'])
    out = {}
    for name, (_, _, jcls) in MODELS.items():
        jm = jcls(_configs(inp['dummy'], name)[0], jd)
        jm.graph_op.weights = lambda key, dropout, op=jm.graph_op: (
            _jax_hash_weights(op, PAIRS))
        jp = jax.tree.map(jnp.asarray, inp['params'][name])
        (loss, aux), grads = jax.value_and_grad(jm.loss, has_aux=True)(
            jp, (users, pos, negs, jnp.ones(users.shape[0], bool)),
            jax.random.key(0))
        out[name] = {'loss': float(loss),
                     'aux': {c: float(v) for c, v in aux.items()},
                     'grads': {n: np.asarray(g) for n, g in grads.items()}}
    return out


@pytest.fixture(scope='module')
def dummy_copy(tmp_path_factory, dummy_dir):
    out = tmp_path_factory.mktemp('mesh_text') / 'dummy'
    shutil.copytree(dummy_dir, out)
    return str(out)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, dummy_copy):
    sys.path.insert(0, HELPERS)
    import torch_mesh_conv_worker
    base = str(tmp_path_factory.mktemp('mesh_text_base') / 'base.pkl')
    _base_checkpoint(base, text.load_ltr_data(_configs(dummy_copy,
                                                       'kg')[1]))
    inp = _inputs(dummy_copy, base)
    dirs = {w: tmp_path_factory.mktemp(f'mesh_text{w}') for w in WORLDS}
    for d in dirs.values():
        with open(d / 'inputs.pkl', 'wb') as f:
            pickle.dump(inp, f)
    contexts = [mp.start_processes(torch_mesh_conv_worker.run,
                                   args=(w, str(d)), nprocs=w, join=False,
                                   start_method='spawn')
                for w, d in dirs.items()]
    try:
        jax_out = _jax_steps(inp)
    finally:
        _join(contexts, RANKS_TIMEOUT)
    out = {'inputs': inp, 'dirs': dirs, 'jax': jax_out}
    for w, d in dirs.items():
        out[w] = []
        for r in range(w):
            with open(d / f'rank{r}.pkl', 'rb') as f:
                out[w].append(pickle.load(f))
    return out


def _single(inp, name):
    """The port's single-process model on the same params."""
    tc = _configs(inp['dummy'], name)[1]
    data = text.load_ltr_data(tc)
    model = get_class(tc.model)[1](tc, data, device='cpu')
    model.load_params(params_from_jax(inp['params'][name], data.n_users,
                                      data.n_items))
    return model


@pytest.fixture(scope='module')
def single_steps(ranks):
    out = {}
    for name in MODELS:
        model = _single(ranks['inputs'], name)
        loss, aux = model.loss(tuple(torch.from_numpy(a.astype(np.int64))
                                     for a in ranks['inputs']['batch']),
                               w_pairs=PAIRS)
        loss.backward()
        out[name] = {'loss': float(loss.detach()),
                     'aux': {c: float(v.detach()) for c, v in aux.items()},
                     'grads': {n: getattr(model, n).grad.numpy()
                               for n in ('user_emb', 'item_emb')}}
    return out


def _assert_step(got, want):
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5, atol=0)
    assert sorted(got['aux']) == sorted(want['aux'])
    for c, v in want['aux'].items():
        np.testing.assert_allclose(got['aux'][c], v, rtol=1e-5, atol=1e-9,
                                   err_msg=c)
    for n in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(got['grads'][n], want['grads'][n],
                                   atol=1e-5, rtol=0, err_msg=n)


@pytest.mark.parametrize('w', WORLDS)
@pytest.mark.parametrize('name', list(MODELS))
def test_mesh_step_matches_the_single_process(ranks, single_steps, name, w):
    for got in ranks[w]:
        _assert_step(got['text'][name], single_steps[name])


@pytest.mark.parametrize('name', list(MODELS))
def test_mesh_step_matches_jax(ranks, name):
    want = ranks['jax'][name]
    if name in CONCAT:
        assert sorted(want['aux']) == ['bpr', 'reg']
    else:
        assert abs(want['aux']['sem']) > 1e-3     # the term is in play
    for w in WORLDS:
        for got in ranks[w]:
            _assert_step(got['text'][name], want)


@pytest.mark.parametrize('name', CONCAT)
def test_fused_sharded_topk_equals_the_single_card_scorer(ranks, name):
    model = _single(ranks['inputs'], name)
    users = torch.arange(model.n_users)
    with torch.no_grad():
        reprs = model.scoring_reprs()
        want = model.topk_for_users(reprs, users, 5)
        want_plain = LightGCN.topk_for_users(model, reprs, users, 5)
    for w in WORLDS:
        for got in ranks[w]:
            _assert_same_topk(got['text'][name]['head'], want)
            _assert_same_topk(got['text'][name]['plain'], want_plain)


@pytest.mark.parametrize('w', WORLDS)
def test_text_probe_scores_each_ranks_rows_of_the_text(ranks, w):
    """Each probe's representation is this rank's rows of the padded text
    tables, as a propagation's would be: each rank scores its own items."""
    for got in ranks[w]:
        assert got['text']['probe_rows'] == {
            combo: (PAD // w, PAD // w) for combo in
            ('rev_rev', 'kg_kg', 'rev_kg', 'kg_rev')}


@pytest.fixture(scope='module')
def single_runs(ranks, tmp_path_factory):
    """The single-process CLI runs of ``inp['cli_runs']``, in a directory
    of their own."""
    from textgcn_tpu_torch.cli import main as port_main
    cwd = tmp_path_factory.mktemp('mesh_text_single')
    old = os.getcwd()
    prev = os.environ.get('TEXTGCN_TPU_PLATFORM')
    os.chdir(cwd)
    os.environ['TEXTGCN_TPU_PLATFORM'] = 'cpu'
    try:
        runs = {uid: port_main([*argv, '--uid', uid])
                for uid, argv, _ in ranks['inputs']['cli_runs']}
    finally:
        os.chdir(old)
        if prev is None:
            del os.environ['TEXTGCN_TPU_PLATFORM']
        else:
            os.environ['TEXTGCN_TPU_PLATFORM'] = prev
        _close_logger()
    return cwd, runs


def _close_logger():
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@pytest.mark.parametrize('w', WORLDS)
@pytest.mark.parametrize('probe', PROBES)
def test_probe_metrics_on_a_mesh_are_the_single_process(ranks, single_runs,
                                                        probe, w):
    """``text_probe``'s four metric sets (its representation is each
    rank's rows of the padded text tables) and ``ltr_simple``'s two."""
    want = single_runs[1][probe].metrics_logger
    assert len(want['recall']) == (4 if probe == 'text_probe' else 2)
    for got in ranks[w]:
        got = got['cli'][probe]['metrics_logger']
        for name, rows in want.items():
            np.testing.assert_allclose(got[name], rows, atol=1e-6, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize('uid', list(TRAINED))
def test_text_mesh_cli_matches_the_single_process_run(ranks, single_runs,
                                                      uid):
    """Loss sums with their components (1e-5 relative) and every
    evaluation's metrics (1e-6); rank 0 alone wrote, the files the single
    run wrote."""
    w = TRAINED[uid][1]
    single = single_runs[1][uid]
    for got in ranks[w]:
        got = got['cli'][uid]
        for c in ('loss', *single.model.loss_components):
            np.testing.assert_allclose(
                [h[c] for h in got['loss_history']],
                [h[c] for h in single.loss_history], rtol=1e-5, atol=0,
                err_msg=c)
        for name, rows in single.metrics_logger.items():
            np.testing.assert_allclose(got['metrics_logger'][name], rows,
                                       atol=1e-6, rtol=0, err_msg=name)
    run = ranks['dirs'][w] / 'cwd0' / 'runs' / 'dummy' / uid
    want = single_runs[0] / 'runs' / 'dummy' / uid
    assert sorted(p.name for p in run.iterdir()) == sorted(
        p.name for p in want.iterdir())
    for r in range(1, w):
        assert not (ranks['dirs'][w] / f'cwd{r}' / 'runs').exists()
    if uid == 'ltr_kg':
        for name in ('ltr_user_factors', 'ltr_item_factors', 'ltr_bias',
                     'users_repr', 'items_repr'):
            np.testing.assert_allclose(np.load(run / f'{name}.npy'),
                                       np.load(want / f'{name}.npy'),
                                       atol=1e-6, rtol=0, err_msg=name)


def test_text_mesh_1x1_in_process_equals_the_single_card_run(
        ranks, single_runs, tmp_path, monkeypatch):
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    argv = next(a for uid, a, _ in ranks['inputs']['cli_runs']
                if uid == 'text_user')
    single = single_runs[1]['text_user']
    mesh = port_main([*argv, '--uid', 'mesh', '--mesh', '1x1'])
    assert not dist.is_initialized()
    assert mesh.model.mesh.shape == (1, 1)
    for c in ('loss', 'sem'):
        np.testing.assert_allclose([h[c] for h in mesh.loss_history],
                                   [h[c] for h in single.loss_history],
                                   rtol=1e-5, atol=0)
    for name, v in single.last_metrics.items():
        np.testing.assert_allclose(mesh.last_metrics[name], v, atol=1e-6,
                                   rtol=0)
