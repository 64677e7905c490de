"""The port's ``adv_sampling`` against the JAX package's, on the CPU.

Both sides take the same tables, users, candidate masks ``keep``,
positive draws ``ridx`` and dropout salts (the JAX side through its
exact-f32 XLA op with the hash weights, its rank pass's salts first);
the JAX package runs with ``TEXTGCN_TPU_ADV_TOPK=exact``.

Tolerances: ``mining_top_k``'s indices exactly (ties to the lower index);
``expanded_loss`` 1e-5 and its gradients 1e-5 absolute / 1e-4 relative;
``loss_given`` and a 10-step Adam trajectory 1e-4 (the hard-negative
sets exactly: bf16 scores of tables that agree to ~1e-7 fall in the same
bf16 bin here); a served JAX checkpoint's metrics 1e-6.  A resumed run
equals the uninterrupted one bit for bit.
"""

import dataclasses
import logging
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data.core import load_interactions as jax_load
from textgcn_tpu.models.adv_sampling import AdvSamplModel as JaxAdv
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.cli import main as port_main
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.models.adv_sampling import AdvSamplModel
from textgcn_tpu_torch.ops import retrieval
from textgcn_tpu_torch.ops import spmm as spmm_mod
from textgcn_tpu_torch.train.checkpoint import make_checkpointer
from textgcn_tpu_torch.train.trainer import Trainer
from textgcn_tpu_torch.weights import params_from_jax

SALT = 0x9E3779B9                      # high bit set
KEEP = float(np.float32(1.0 - 0.4))
PAIRS = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))
PAIRS_2 = ((SALT ^ 0x1234567, KEEP), (SALT ^ 0x7654321, KEEP))
D = 16
B = 16


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@pytest.fixture(scope='module')
def synthetic_dir(tmp_path_factory):
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, 'tools'))
    from make_synthetic import generate
    out = str(tmp_path_factory.mktemp('synth') / 'data')
    generate(out, n_users=80, n_items=50, k_clusters=5, seed=7)
    return out


def _jax_hash_weights(op, w_pairs):
    out = []
    for salt, keep in w_pairs:
        w = op.w_u * jax_scale(op.eu_u, op.ei_u, jnp.uint32(salt),
                               jnp.float32(keep))
        out.append((w, w[op.perm_u2i]))
    (wu1, wi1), (wu2, wi2) = out
    return (wu1, wi1), (wi2, wu2)


def _models(data_dir, k, seed=2):
    """(JAX model, its params, port model loaded from them): lr 1e-2,
    reg 1e-3, dropout 0.4, 3 layers."""
    common = dict(model='adv_sampling', data=data_dir, emb_size=D,
                  n_layers=3, dropout=0.4, reg_lambda=1e-3, batch_size=B,
                  k=k, lr=1e-2, save_path='/nonexistent')
    jm = JaxAdv(JaxConfig(**common).finalize(), jax_load(data_dir))
    tcfg = tconfig.Config(save=False, **common).finalize()
    tm = AdvSamplModel(tcfg, load_interactions(data_dir), device='cpu')
    rng = np.random.RandomState(seed)
    params = {'user_emb': (0.3 * rng.randn(tm.n_users, D)).astype(
        np.float32), 'item_emb': (0.3 * rng.randn(tm.n_items, D)).astype(
        np.float32)}
    tm.load_params(params_from_jax(params, tm.n_users, tm.n_items))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _jax_loss_given(jm, params, users, keep, ridx, w_rank, w_loss):
    """JAX ``_loss_given`` with the rank pass's salts, then the loss
    pass's, injected: ``(loss, aux, grads, negs)``."""
    pairs = iter([w_rank, w_loss])
    jm.graph_op.weights = lambda key, dropout: _jax_hash_weights(
        jm.graph_op, next(pairs))
    users = jnp.asarray(users, jnp.int32)
    mask = jnp.ones(users.shape[0], bool)
    negs = []
    mine = jm._expanded_loss

    def spy(params, ur, ir, users, pos, n, mask, valid):
        negs.append((n, valid))
        return mine(params, ur, ir, users, pos, n, mask, valid)

    jm._expanded_loss = spy
    try:
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jm._loss_given(p, users, mask, jnp.asarray(keep),
                                     jnp.asarray(ridx), None, None),
            has_aux=True)(params)
    finally:
        del jm._expanded_loss
    return loss, aux, grads, negs[0]


def _draws(rng, n_users, n_items, p):
    users = rng.randint(0, n_users, B)
    keep = rng.random_sample((B, n_items)) < p
    ridx = rng.randint(0, 1 << 30, (B, 5)).astype(np.int32)
    return users, keep, ridx


def _t(a, dtype=torch.int64):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# --- mining ------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('k', [1, 7, 40])
@pytest.mark.parametrize('n', [300, 65536, 70000])
def test_mining_top_k_equals_lax_top_k_on_ties(dtype, k, n):
    """Scores with many ties (a few bf16 values, -inf, signed zeros): the
    same indices as ``lax.top_k``, whose ties go to the lower index; bf16
    keys are int32 up to 65,536 items, int64 past it and for float32."""
    rng = np.random.RandomState(k)
    x = rng.randint(-3, 4, (16, n)).astype(np.float32) * 0.375
    x[rng.random_sample(x.shape) < 0.3] = -np.inf
    x[:4] = 0.0
    x[:4, ::3] = -0.0
    jdt = getattr(jnp, dtype)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x).astype(jdt), k)
    got_v, got_i = retrieval.mining_top_k(
        torch.from_numpy(x).to(getattr(torch, dtype)), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.float().numpy(),
                                  np.asarray(want_v).astype(np.float32))


def test_approximate_mining_is_refused(monkeypatch, caplog):
    """No longer refused: a ``TEXTGCN_TPU_ADV_TOPK`` recall target (or a
    value the JAX package reads as 0.95) mines exactly, as an empty or
    ``exact`` value does, and says so once a value."""
    import logging
    # a CLI run earlier in the process stops the port's logger propagating
    monkeypatch.setattr(logging.getLogger(tconfig.LOGGER_NAME), 'propagate',
                        True)
    caplog.set_level(logging.INFO, logger=tconfig.LOGGER_NAME)
    monkeypatch.setattr(retrieval, '_logged_adv_targets', set())
    rng = np.random.RandomState(3)
    scores = torch.from_numpy(rng.randint(-3, 4, (6, 50)).astype(np.float32))
    want_v, want_i = retrieval.top_k_lower_index(scores, 7)
    for env, target in (('', None), ('exact', None), ('0.95', 0.95),
                        ('0.5', 0.5), ('1.5', 0.95), ('0', 0.95),
                        ('nope', 0.95), ('0.95', 0.95)):
        monkeypatch.setenv(retrieval.ADV_TOPK_ENV, env)
        assert retrieval.adv_recall_target() == target
        got_v, got_i = retrieval.mining_top_k(scores, 7)
        assert torch.equal(got_i, want_i) and torch.equal(got_v, want_v)
    said = [r.getMessage() for r in caplog.records
            if 'mined exactly' in r.getMessage()]
    assert len(said) == 5 and 'TEXTGCN_TPU_ADV_TOPK=0.95' in said[0]


# --- the loss ----------------------------------------------------------------

def test_expanded_loss_and_gradients_match_jax(synthetic_dir):
    jm, jp, tm = _models(synthetic_dir, (5, 10))
    rng = np.random.RandomState(3)
    users = rng.randint(0, tm.n_users, B)
    pos = rng.randint(0, tm.n_items, (B, 5))
    negs = rng.randint(0, tm.n_items, (B, 10))
    valid = rng.random_sample((B, 10)) < 0.7
    valid[0] = False                          # a user with no negative

    def jax_parts(p):
        ur, ir = jm.representation(p, training=False)
        return jm._expanded_loss(
            p, ur, ir, jnp.asarray(users), jnp.asarray(pos),
            jnp.asarray(negs), jnp.ones(B, bool), jnp.asarray(valid))

    jb, jr = jax_parts(jp)
    grads = jax.grad(lambda p: sum(jax_parts(p)))(jp)
    ur, ir = tm.representation()
    tb, tr = tm.expanded_loss(ur, ir, _t(users), _t(pos), _t(negs),
                              _t(valid, torch.bool))
    (tb + tr).backward()
    np.testing.assert_allclose(float(tb.detach()), float(jb), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(tr.detach()), float(jr), rtol=1e-5,
                               atol=1e-9)
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(getattr(tm, name).grad.numpy(),
                                   np.asarray(grads[name]), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize('which', ['dummy', 'synthetic'])
def test_loss_given_and_hard_negatives_match_jax(which, dummy_dir,
                                                 synthetic_dir, monkeypatch):
    """``dummy``: every item a candidate (p = 1) and ``n_hard_negs`` (9)
    covering every non-positive; ``synthetic``: a keep-0.6 mask and bf16
    scores with ties, 10 of 50 items mined."""
    monkeypatch.setenv(retrieval.ADV_TOPK_ENV, 'exact')
    data_dir, k = ((dummy_dir, (3, 9)) if which == 'dummy'
                   else (synthetic_dir, (5, 10)))
    jm, jp, tm = _models(data_dir, k)
    p = 1.0 if which == 'dummy' else 0.6
    users, keep, ridx = _draws(np.random.RandomState(4), tm.n_users,
                               tm.n_items, p)
    loss, aux, grads, (jnegs, jvalid) = _jax_loss_given(
        jm, jp, users, keep, ridx, PAIRS, PAIRS_2)
    with torch.no_grad():
        ur, ir = tm.representation(training=True, w_pairs=PAIRS)
        negs, valid = tm.hard_negatives(ur, ir, _t(users),
                                        _t(keep, torch.bool))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(negs.numpy()[valid.numpy()],
                                  np.asarray(jnegs)[np.asarray(jvalid)])
    if which == 'dummy':
        assert (valid.sum(1).numpy()
                == tm.n_items - tm.pos_degree[_t(users)].numpy()).all()
    t_loss, t_aux = tm.loss_given(_t(users), _t(keep, torch.bool),
                                  _t(ridx), PAIRS, PAIRS_2)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-4,
                               atol=1e-6)
    for c in ('bpr', 'reg'):
        np.testing.assert_allclose(float(t_aux[c]), float(aux[c]),
                                   rtol=1e-4, atol=1e-7)
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(getattr(tm, name).grad.numpy(),
                                   np.asarray(grads[name]), atol=1e-5,
                                   rtol=1e-4)


def test_ten_step_adam_trajectory_matches_jax(synthetic_dir, monkeypatch):
    monkeypatch.setenv(retrieval.ADV_TOPK_ENV, 'exact')
    jm, jp, tm = _models(synthetic_dir, (5, 10), seed=5)
    opt = optax.adam(1e-2)
    state = opt.init(jp)
    topt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    rng = np.random.RandomState(6)
    for step in range(10):
        users, keep, ridx = _draws(rng, tm.n_users, tm.n_items, 0.6)
        pairs = (PAIRS, PAIRS_2) if step % 2 else (PAIRS_2, PAIRS)
        loss, _, grads, _ = _jax_loss_given(jm, jp, users, keep, ridx,
                                            *pairs)
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.zero_grad()
        t_loss, _ = tm.loss_given(_t(users), _t(keep, torch.bool),
                                  _t(ridx), *pairs)
        t_loss.backward()
        topt.step()
        np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-4,
                                   atol=1e-6)
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   np.asarray(jp[name]), atol=1e-4,
                                   rtol=1e-4)


# --- the trainer -------------------------------------------------------------

def _trainer(data_dir, **kw):
    cfg = tconfig.Config(model='adv_sampling', data=data_dir, emb_size=D,
                         k=(3, 5), batch_size=8, epochs=2,
                         evaluate_every=1, save=False, **kw).finalize()
    data = load_interactions(data_dir)
    return Trainer(cfg, AdvSamplModel(cfg, data, device='cpu'), data)


def test_two_salt_pairs_a_step_and_lgcn_keeps_its_stream(dummy_dir):
    """adv draws the rank pass's pair, then the loss pass's; ``lgcn``'s
    stream is one pair a step, as before."""
    from textgcn_tpu_torch.models.lightgcn import LightGCN
    adv = _trainer(dummy_dir)
    cfg = dataclasses.replace(adv.cfg, model='lgcn')
    lgcn = Trainer(cfg, LightGCN(cfg, adv.data, device='cpu'), adv.data)
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    ref = [adv.model.graph_op.weights(gen, cfg.dropout) for _ in range(6)]
    assert [lgcn.step_salts() for _ in range(2)] == ref[:2]
    assert [adv.step_salts() for _ in range(2)] == [tuple(ref[:2]),
                                                   tuple(ref[2:4])]


@pytest.mark.parametrize('refresh', [0, 2])
def test_spmm_calls_a_step(dummy_dir, monkeypatch, refresh):
    """A step runs the SpMM 18 times (the rank pass 6 forward, the loss
    pass 6 forward and 6 backward) and the rank pass keeps no graph; under
    ``--refresh_every`` both passes read the cached rest, so only the
    refresh steps propagate (6 each, forward only)."""
    tr = _trainer(dummy_dir, refresh_every=refresh)
    batches = tr.model.sample_batches(tr.generator, 8)
    assert [tuple(b[0].shape) for b in batches] == [(8,)] * 7 + [(4,)]
    calls, ranked = [], []
    spmm = spmm_mod.spmm
    monkeypatch.setattr(spmm_mod, 'spmm', lambda *a: calls.append(1)
                        or spmm(*a))
    mine = tr.model.hard_negatives
    monkeypatch.setattr(tr.model, 'hard_negatives', lambda ur, *a: (
        ranked.append(ur.requires_grad), mine(ur, *a))[1])
    for step, batch in enumerate(batches[:4]):
        loss, aux = tr.epoch_step(step, batch)
        assert np.isfinite(float(loss))
    tr.model.cached_rest = None
    assert len(calls) == (12 if refresh else 4 * 18)
    assert ranked == [False] * 4


def test_resume_continues_bit_for_bit(tmp_path, monkeypatch, dummy_dir):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    data = str(tmp_path / 'dummy')
    shutil.copytree(dummy_dir, data)
    common = ['--model', 'adv_sampling', '--data', data, '--emb_size',
              str(D), '--batch_size', '16', '-k', '3', '5', '--quiet',
              '--evaluate_every', '2']
    full = port_main(common + ['--epochs', '4', '--uid', 'full'])
    port_main(common + ['--epochs', '2', '--uid', 'half'])
    state = make_checkpointer().load_resume(os.path.join('runs', 'dummy',
                                                         'half'))
    assert set(state['generators']) == {'sampler', 'salt', 'model'}
    resumed = port_main(common + ['--epochs', '4', '--uid', 'resumed',
                                  '--resume', 'runs/dummy/half'])
    assert resumed.loss_history == full.loss_history[2:]
    for name, rows in full.metrics_logger.items():
        np.testing.assert_array_equal(resumed.metrics_logger[name], rows)
    for (name, p), (_, q) in zip(full.model.named_parameters(),
                                 resumed.model.named_parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(full.model.generator.get_state(),
                       resumed.model.generator.get_state())


def test_a_jax_checkpoint_serves_the_same_metrics(tmp_path, monkeypatch,
                                                  dummy_dir):
    from textgcn_tpu.cli import main as jax_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    data = load_interactions(dummy_dir)
    rng = np.random.RandomState(8)
    ck = str(tmp_path / 'adv.pkl')
    with open(ck, 'wb') as f:
        pickle.dump({'params': {
            'user_emb': (0.3 * rng.randn(data.n_users, D)).astype(
                np.float32),
            'item_emb': (0.3 * rng.randn(data.n_items, D)).astype(
                np.float32)}, 'epoch': 2, 'model': 'adv_sampling'}, f)
    argv = ['--model', 'adv_sampling', '--data', dummy_dir, '--emb_size',
            str(D), '-k', '3', '5', '--no_train', '--load', ck, '--quiet']
    got = port_main(argv + ['--uid', 'p']).last_metrics
    want = jax_main(argv + ['--uid', 'j']).evaluate()
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, atol=1e-6, rtol=0)
