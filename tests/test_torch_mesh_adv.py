"""``adv_sampling`` on the port's mesh (``--mesh``: the tables row-sharded
over K2's source shards, each rank mining its own users' rows against the
gathered item table) against the JAX package and the port's single card,
on the CPU.

Ranks are gloo processes at W = 2 and W = 4, started once per W
(``tests/helpers/torch_mesh_conv_worker.py``); the JAX side
(``TEXTGCN_TPU_ADV_TOPK=exact``, its exact-f32 XLA op with the hash
weights) runs here while they do.  ``data/dummy`` padded to 16 rows, d =
16, 3 layers, k = (3, 5): 5 hard negatives mined from a keep-0.6
candidate mask, so some rows have fewer valid ones.

* One step from the same tables, users, candidate mask, positive draws
  and salts: the ranks' losses sum to the single process's and the JAX
  package's (1e-5 relative), the gradients of both tables agree (1e-5),
  and the hard negatives are the single process's and the JAX package's
  in every row whose bf16 scores are distinct (the valid masks in every
  row).
* One ``Trainer.train_step`` that draws from the model's own generator:
  the mesh's draws are the single card's (loss 1e-5 relative, tables
  after Adam 1e-5).
* ``adv_sampling --mesh 2x2`` through the CLI repeats the single-process
  run (loss sums 1e-5 relative, metrics 1e-6, the model's generator bit
  for bit on every rank); ``--mesh 2x1`` resumed at W = 2 is bit-equal
  to the uninterrupted run; ``--mesh 1x1`` in-process repeats the single
  card.
"""

import logging
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_adv import (PAIRS, PAIRS_2, _draws, _jax_loss_given, _models,
                            _t)
from test_torch_mesh_conv import HELPERS, PAD, SPAWN_TIMEOUT, _join
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.ops import retrieval
from textgcn_tpu_torch.ops.retrieval import catalog_scores, mask_train_items
from textgcn_tpu_torch.parallel import multihost
from textgcn_tpu_torch.train.trainer import Trainer
from textgcn_tpu_torch.weights import params_to_jax

D = 16
K = (3, 5)
REG, LR = 1e-3, 1e-2
EPOCHS = 4
WORLDS = (2, 4)
# the ranks also train through the CLI: twice the conv file's limit
RANKS_TIMEOUT = 2 * SPAWN_TIMEOUT


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def _cli_argv(dummy_dir):
    return ['--model', 'adv_sampling', '--data', dummy_dir,
            '--evaluate_every', '2', '--batch_size', '16', '--emb_size',
            str(D), '-k', *map(str, K), '--quiet']


def _inputs(dummy_dir):
    _, jp, tm = _models(dummy_dir, K, seed=15)
    users, keep, ridx = _draws(np.random.RandomState(16), tm.n_users,
                               tm.n_items, 0.6)
    argv = _cli_argv(dummy_dir)
    return {
        'kind': 'adv', 'dummy': dummy_dir, 'pad': PAD, 'd': D, 'k': K,
        'reg': REG, 'lr': LR, 'w_pairs': (PAIRS, PAIRS_2),
        'params': jax.tree.map(np.asarray, jp),
        'draws': (users.astype(np.int64), keep, ridx.astype(np.int64)),
        'cli_runs': [('mesh', [*argv, '--epochs', str(EPOCHS)],
                      {4: '2x2'})],
        'resume_argv': argv, 'resume_mesh': '{w}x1', 'resume_worlds': (2,),
        'epochs': EPOCHS,
    }


def _single(inp):
    """The port's single-process model on the same params (lr 1e-2, reg
    1e-3, dropout 0.4, 3 layers) and the JAX model with its params."""
    jm, jp, tm = _models(inp['dummy'], K, seed=15)
    assert all(np.array_equal(np.asarray(jp[n]), inp['params'][n])
               for n in jp)
    return jm, jp, tm


def _jax_side(inp):
    jm, jp, _ = _single(inp)
    prev = os.environ.get(retrieval.ADV_TOPK_ENV)
    os.environ[retrieval.ADV_TOPK_ENV] = 'exact'
    try:
        loss, aux, grads, (negs, valid) = _jax_loss_given(
            jm, jp, *(np.asarray(a) for a in inp['draws']),
            *inp['w_pairs'])
    finally:
        if prev is None:
            del os.environ[retrieval.ADV_TOPK_ENV]
        else:
            os.environ[retrieval.ADV_TOPK_ENV] = prev
    return {'loss': float(loss), 'aux': {c: float(v) for c, v in aux.items()},
            'grads': {n: np.asarray(g) for n, g in grads.items()},
            'negs': np.asarray(negs), 'valid': np.asarray(valid)}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, dummy_dir):
    sys.path.insert(0, HELPERS)
    import torch_mesh_conv_worker
    inp = _inputs(dummy_dir)
    dirs = {w: tmp_path_factory.mktemp(f'mesh_adv{w}') for w in WORLDS}
    for d in dirs.values():
        with open(d / 'inputs.pkl', 'wb') as f:
            pickle.dump(inp, f)
    contexts = [mp.start_processes(torch_mesh_conv_worker.run,
                                   args=(w, str(d)), nprocs=w, join=False,
                                   start_method='spawn')
                for w, d in dirs.items()]
    try:
        jax_out = _jax_side(inp)
    finally:
        _join(contexts, RANKS_TIMEOUT)
    out = {'inputs': inp, 'dirs': dirs, 'jax': jax_out}
    for w, d in dirs.items():
        out[w] = []
        for r in range(w):
            with open(d / f'rank{r}.pkl', 'rb') as f:
                out[w].append(pickle.load(f))
    return out


@pytest.fixture(scope='module')
def single_step(ranks):
    """The single process's ``loss_given`` on the inputs: loss, its
    components, gradients, hard negatives, and the distinct rows (every
    finite masked bf16 score of the row distinct)."""
    inp = ranks['inputs']
    _, _, tm = _single(inp)
    users, keep, ridx = (_t(a, torch.bool if a.dtype == bool else torch.int64)
                         for a in inp['draws'])
    w_rank, w_loss = inp['w_pairs']
    with torch.no_grad():
        ur, ir = tm.representation(training=True, w_pairs=w_rank)
        negs, valid = tm.hard_negatives(ur, ir, users, keep)
        scores = mask_train_items(
            catalog_scores(ur[users], ir).to(torch.bfloat16),
            tm.pos_padded[users], tm.n_items).masked_fill(~keep, -torch.inf)
    scores = scores.float().numpy()
    distinct = np.array([len(set(r[np.isfinite(r)])) == np.isfinite(r).sum()
                         for r in scores])
    loss, aux = tm.loss_given(users, keep, ridx, w_rank, w_loss)
    loss.backward()
    return {'loss': float(loss.detach()),
            'aux': {c: float(v.detach()) for c, v in aux.items()},
            'grads': {n: getattr(tm, n).grad.numpy() for n in
                      ('user_emb', 'item_emb')},
            'negs': negs.numpy(), 'valid': valid.numpy(),
            'distinct': distinct}


def _assert_step(got, want):
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5, atol=0)
    for c in ('bpr', 'reg'):
        np.testing.assert_allclose(got['aux'][c], want['aux'][c], rtol=1e-5,
                                   atol=1e-9, err_msg=c)
    for n in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(got['grads'][n], want['grads'][n],
                                   atol=1e-5, rtol=0, err_msg=n)


def _mined(rows):
    """The whole batch's hard negatives from each rank's rows, in rank
    order (the ``tensor_split`` of the batch)."""
    return (np.concatenate([r['adv']['negs'] for r in rows]),
            np.concatenate([r['adv']['valid'] for r in rows]))


@pytest.mark.parametrize('w', WORLDS)
def test_mesh_adv_step_matches_the_single_process(ranks, single_step, w):
    for got in ranks[w]:
        _assert_step(got['adv'], single_step)


@pytest.mark.parametrize('w', WORLDS)
def test_mesh_adv_step_matches_jax(ranks, w):
    for got in ranks[w]:
        _assert_step(got['adv'], ranks['jax'])


@pytest.mark.parametrize('w', WORLDS)
def test_each_rank_mines_its_users_as_the_single_process(ranks, single_step,
                                                         w):
    negs, valid = _mined(ranks[w])
    assert negs.shape == single_step['negs'].shape
    np.testing.assert_array_equal(valid, single_step['valid'])
    assert 0 < valid.sum() < valid.size        # some rows run short
    distinct = single_step['distinct']
    assert distinct.mean() > 0.5
    np.testing.assert_array_equal(
        np.where(valid, negs, -1)[distinct],
        np.where(valid, single_step['negs'], -1)[distinct])
    # W rows of ranks, each its own share of the batch
    assert [len(r['adv']['negs']) for r in ranks[w]] == [
        len(s) for s in np.array_split(negs, w)]


@pytest.mark.parametrize('w', WORLDS)
def test_each_rank_mines_its_users_as_jax(ranks, single_step, w):
    negs, valid = _mined(ranks[w])
    want = ranks['jax']
    np.testing.assert_array_equal(valid, want['valid'])
    distinct = single_step['distinct']
    np.testing.assert_array_equal(np.where(valid, negs, -1)[distinct],
                                  np.where(valid, want['negs'], -1)[distinct])


@pytest.mark.parametrize('w', WORLDS)
def test_a_mesh_train_step_draws_what_the_single_card_draws(ranks, w):
    """``Trainer.train_step`` draws the candidate mask and the positives
    from the model's generator: every rank draws the whole batch's."""
    from textgcn_tpu_torch.data.core import load_interactions
    inp = ranks['inputs']
    _, _, tm = _single(inp)
    trainer = Trainer(tm.cfg, tm, load_interactions(inp['dummy']))
    want_loss, _ = trainer.train_step((_t(inp['draws'][0]),),
                                      inp['w_pairs'])
    want = params_to_jax(tm.param_tree())
    for got in ranks[w]:
        step = got['adv']['train_step']
        np.testing.assert_allclose(step['loss'], float(want_loss), rtol=1e-5,
                                   atol=0)
        for n in ('user_emb', 'item_emb'):
            np.testing.assert_allclose(step['params'][n], want[n], atol=1e-5,
                                       rtol=0, err_msg=n)


def test_adv_mesh_cli_matches_the_single_process_run(ranks, tmp_path,
                                                     monkeypatch):
    """``--mesh 2x2`` on 4 gloo ranks: the loss sums (1e-5 relative) and
    the metrics of every evaluation (1e-6) of the single-process run, the
    model's generator the single run's on every rank; rank 0 alone
    wrote."""
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    single = port_main([*_cli_argv(ranks['inputs']['dummy']), '--epochs',
                        str(EPOCHS), '--uid', 'single'])
    for got in ranks[4]:
        got = got['cli']['mesh']
        np.testing.assert_allclose([h['loss'] for h in got['loss_history']],
                                   [h['loss'] for h in single.loss_history],
                                   rtol=1e-5, atol=0)
        for name, rows in single.metrics_logger.items():
            np.testing.assert_allclose(got['metrics_logger'][name], rows,
                                       atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got['generator'],
                                      single.model.generator.get_state())
    mesh_dir = ranks['dirs'][4]
    run = mesh_dir / 'cwd0' / 'runs' / 'dummy' / 'mesh'
    want = tmp_path / 'runs' / 'dummy' / 'single'
    assert sorted(p.name for p in run.iterdir()) == sorted(
        p.name for p in want.iterdir())
    for r in (1, 2, 3):
        assert not (mesh_dir / f'cwd{r}' / 'runs').exists()


def test_resume_of_an_adv_mesh_run_at_w2_is_bit_equal(ranks):
    """``--mesh 2x1``: the resumed run restores the model's generator from
    rank 0's ``resume_state.pkl`` and goes on bit for bit."""
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
            assert not np.array_equal(half['params'][name],
                                      full['params'][name])


def test_adv_mesh_1x1_in_process_equals_the_single_card_run(
        tmp_path, monkeypatch, dummy_dir):
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    argv = [*_cli_argv(dummy_dir), '--epochs', '2']
    single = port_main(argv + ['--uid', 'single'])
    mesh = port_main(argv + ['--uid', 'mesh', '--mesh', '1x1'])
    assert not dist.is_initialized()
    assert mesh.model.mesh.shape == (1, 1)
    np.testing.assert_allclose([h['loss'] for h in mesh.loss_history],
                               [h['loss'] for h in single.loss_history],
                               rtol=1e-5, atol=0)
    for name, v in single.last_metrics.items():
        np.testing.assert_allclose(mesh.last_metrics[name], v, atol=1e-6,
                                   rtol=0)
