"""The port's SIGTERM stop and ``--refresh_every``, on the CPU.

* A SIGTERM sent from inside an epoch stops ``fit`` at that epoch's end
  with both files written; the resume then equals the uninterrupted run.
* ``--refresh_every``: a refresh step and a stale step against the JAX
  package's ``propagate_rest`` + ``with_cached_rest`` + ``loss`` on the
  same params, batch and salts (the JAX side through its exact-f32 XLA
  op with the hash weights): loss and ego gradients within 1e-5.  The
  schedule (steps 0, N, 2N, ... of every epoch, no backward through the
  propagation) by the SpMM calls, and the refusals.

``--resume`` itself is ``tests/test_torch_resume.py``'s.  Every test
trains on one torch thread.
"""

import logging
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_resume import D, EPOCHS, PAIRS, _assert_same_state, _run_dir
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data.core import load_interactions as jax_load
from textgcn_tpu.models.lightgcn import LightGCN as JaxLightGCN
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.cli import main as port_main
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.models.lightgcn import LightGCN
from textgcn_tpu_torch.ops import spmm as spmm_mod
from textgcn_tpu_torch.train.checkpoint import make_checkpointer
from textgcn_tpu_torch.train.trainer import Trainer
from textgcn_tpu_torch.weights import params_from_jax


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the tensors are tiny, and the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def cli(tmp_path, monkeypatch, dummy_dir):
    """``port_main`` on data/dummy from ``tmp_path`` on the CPU."""
    import shutil
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    data = str(tmp_path / 'dummy')
    shutil.copytree(dummy_dir, data)
    common = ['--data', data, '--emb_size', str(D), '--batch_size', '16',
              '-k', '3', '5', '--quiet', '--evaluate_every', '2']
    return lambda argv: port_main(common + argv)


# --- SIGTERM ------------------------------------------------------------------

def test_sigterm_stops_at_the_epoch_end_and_resumes_bit_for_bit(
        cli, monkeypatch):
    """SIGTERM at the third step of epoch 2: the epoch runs to its end,
    ``latest_checkpoint.pkl`` and ``resume_state.pkl`` of epoch 2 are
    written, ``fit`` returns, and the handler before ``fit`` is back."""
    flags = ['--model', 'lgcn', '--epochs', str(EPOCHS)]
    full = cli(flags + ['--uid', 'full'])
    calls = {'steps': 0}
    step = Trainer.train_step
    n_batches = full.model.num_batches(16)

    def train_step(self, batch, w_pairs):
        calls['steps'] += 1
        if calls['steps'] == n_batches + 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(self, batch, w_pairs)

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(Trainer, 'train_step', train_step)
    stopped = cli(flags + ['--uid', 'stopped'])
    monkeypatch.setattr(Trainer, 'train_step', step)
    assert signal.getsignal(signal.SIGTERM) is before
    assert calls['steps'] == 2 * n_batches
    assert stopped.loss_history == full.loss_history[:2]
    ck = make_checkpointer()
    assert ck.load(os.path.join(_run_dir('stopped'),
                                'latest_checkpoint.pkl'))['epoch'] == 2
    assert int(ck.load_resume(_run_dir('stopped'))['epoch']) == 2
    resumed = cli(flags + ['--uid', 'resumed', '--resume',
                           _run_dir('stopped')])
    assert resumed.loss_history == full.loss_history[2:]
    _assert_same_state(full, resumed)
    for name, v in full.last_metrics.items():
        assert resumed.last_metrics[name] == v


def test_the_handler_is_a_no_op_outside_the_main_thread(dummy_dir):
    data = load_interactions(dummy_dir)
    cfg = tconfig.Config(data=dummy_dir, emb_size=D, k=(3,),
                         save=False).finalize()
    tr = Trainer(cfg, LightGCN(cfg, data, device='cpu'), data)
    before = signal.getsignal(signal.SIGTERM)
    got = []
    t = threading.Thread(target=lambda: got.append(
        tr._install_preemption_handler()))
    t.start()
    t.join()
    assert signal.getsignal(signal.SIGTERM) is before
    got[0]()
    assert signal.getsignal(signal.SIGTERM) is before


# --- --refresh_every ------------------------------------------------------------

def _jax_hash_weights(op, w_pairs):
    out = []
    for salt, keep in w_pairs:
        w = op.w_u * jax_scale(op.eu_u, op.ei_u, jnp.uint32(salt),
                               jnp.float32(keep))
        out.append((w, w[op.perm_u2i]))
    (wu1, wi1), (wu2, wi2) = out
    return (wu1, wi1), (wi2, wu2)


def test_refresh_and_stale_steps_match_jax(dummy_dir):
    """Step 1 refreshes the rest at the step's salts and takes the loss on
    it; step 2 moves the tables and keeps that rest.  Loss and gradients
    of the layer-0 tables within 1e-5 of the JAX package's."""
    data = load_interactions(dummy_dir)
    jcfg = JaxConfig(model='lgcn', data=dummy_dir, emb_size=D,
                     reg_lambda=1e-3, dropout=0.4, n_layers=3,
                     refresh_every=4, save_path='/nonexistent').finalize()
    jm = JaxLightGCN(jcfg, jax_load(dummy_dir))
    jm.graph_op.weights = lambda key, dropout: _jax_hash_weights(
        jm.graph_op, PAIRS)
    cfg = tconfig.Config(model='lgcn', data=dummy_dir, emb_size=D,
                         reg_lambda=1e-3, dropout=0.4, n_layers=3,
                         refresh_every=4, save=False).finalize()
    tm = LightGCN(cfg, data, device='cpu')
    rng = np.random.RandomState(8)
    params = {'user_emb': (0.3 * rng.randn(data.n_users, D)).astype(
        np.float32), 'item_emb': (0.3 * rng.randn(data.n_items, D)).astype(
        np.float32)}
    tm.load_params(params_from_jax(params, data.n_users, data.n_items))
    jp = jax.tree.map(jnp.asarray, params)
    users = rng.randint(0, data.n_users, 9)
    pos = np.array([data.pos_padded[u][rng.randint(data.pos_degree[u])]
                    for u in users])
    negs = rng.randint(0, data.n_items, (9, 2))
    jb = tuple(jnp.asarray(a, jnp.int32) for a in (users, pos, negs)) + (
        jnp.ones(9, bool),)
    tb = tuple(torch.from_numpy(a.astype(np.int64))
               for a in (users, pos, negs))
    j_rest = jm.propagate_rest(jp, jax.random.key(0))
    with torch.no_grad():
        tm.cached_rest = tm.propagate_rest(w_pairs=PAIRS)
    for r_j, r_t in zip(j_rest, tm.cached_rest):
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-5,
                                   rtol=1e-5)
    delta = rng.randn(data.n_users, D).astype(np.float32) * 0.05
    for step in ('refresh', 'stale'):
        with jm.with_cached_rest(j_rest):
            (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
                jp, jb, jax.random.key(0))
        tm.zero_grad(set_to_none=True)
        t_loss, _ = tm.loss(tb, w_pairs=PAIRS)
        t_loss.backward()
        np.testing.assert_allclose(float(t_loss.detach()), float(loss),
                                   rtol=1e-5, atol=1e-6, err_msg=step)
        for name in ('user_emb', 'item_emb'):
            np.testing.assert_allclose(
                getattr(tm, name).grad.numpy(), np.asarray(grads[name]),
                atol=1e-5, rtol=1e-5, err_msg=f'{step} {name}')
        # the next step: the tables move, the rest stays
        jp = dict(jp, user_emb=jp['user_emb'] + delta)
        with torch.no_grad():
            tm.user_emb += torch.from_numpy(delta)
    tm.cached_rest = None
    exact, _ = tm.loss(tb, w_pairs=PAIRS)
    assert float(exact.detach()) != float(t_loss.detach())


@pytest.mark.parametrize('every', [1, 3, 5])
def test_refresh_schedule_and_no_propagation_backward(dummy_dir, monkeypatch,
                                                      every):
    """The SpMM runs forward only, 2 x 3 launches at steps 0, N, 2N, ... of
    each epoch and 6 per evaluation; the losses are finite."""
    data = load_interactions(dummy_dir)
    cfg = tconfig.Config(model='lgcn', data=dummy_dir, emb_size=D, k=(3,),
                         batch_size=8, epochs=2, evaluate_every=1,
                         refresh_every=every, save=False).finalize()
    model = LightGCN(cfg, data, device='cpu')
    tr = Trainer(cfg, model, data)
    calls = []
    spmm = spmm_mod.spmm
    monkeypatch.setattr(spmm_mod, 'spmm', lambda *a: calls.append(
        torch.is_grad_enabled()) or spmm(*a))
    done, refreshes = [], []
    rest, step = model.propagate_rest, tr.train_step
    monkeypatch.setattr(model, 'propagate_rest', lambda **kw: (
        refreshes.append(len(done)), rest(**kw))[1])
    monkeypatch.setattr(tr, 'train_step', lambda *a: (
        done.append(1), step(*a))[1])
    history = tr.fit()
    steps = model.num_batches(8)
    assert steps == 8 and len(done) == 2 * steps
    # the global step index of each refresh: 0, N, 2N, ... in each epoch
    assert refreshes == [e * steps + k for e in range(2)
                         for k in range(0, steps, every)]
    assert len(calls) == (len(refreshes) + 2) * 6
    assert not any(calls)        # no graph kept for a backward
    assert all(np.isfinite(h['loss']) for h in history)


def test_refresh_refusals(dummy_dir):
    with pytest.raises(ValueError, match='--single'):
        tconfig.parse_args(['--model', 'lgcn', '--refresh_every', '4',
                            '--single'])
    with pytest.raises(ValueError, match='>= 0'):
        tconfig.parse_args(['--model', 'lgcn', '--refresh_every', '-1'])
    data = load_interactions(dummy_dir)
    from textgcn_tpu_torch.models.conv import ConvModel
    cfg = tconfig.Config(model='gat', aggr='mean', data=dummy_dir,
                         emb_size=D, k=(3,), refresh_every=2,
                         save=False).finalize()
    tr = Trainer(cfg, ConvModel(cfg, data, device='cpu'), data)
    with pytest.raises(ValueError, match='not supported by model'):
        tr.fit()
    single = tconfig.Config(model='lgcn', data=dummy_dir, emb_size=D,
                            k=(3,), refresh_every=2, single=True,
                            save=False).finalize()
    tr = Trainer(single, LightGCN(single, data, device='cpu'), data)
    with pytest.raises(ValueError, match='layer-mean'):
        tr.fit()
