"""The port's training path for ``lgcn`` against the JAX package's, on the
CPU.

K1's gradient (the plain SpMM on the transpose CSR), the BPR + L2 losses,
one Adam step and a 20-step trajectory are compared with the JAX package
on the same tables, batches and dropout salts: the JAX side takes the
hash-dropout weights ``edge_weight * edge_dropout_scale(...)`` through its
exact-f32 XLA op, since its CPU graph op would draw Bernoulli masks.  The
sampler is checked by its properties (``torch.Generator`` and
``jax.random`` give other numbers), and the CLI by a run on data/dummy
whose checkpoint the JAX package loads.
"""

import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data.core import load_interactions as jax_load
from textgcn_tpu.models import losses as jax_losses
from textgcn_tpu.models.lightgcn import LightGCN as JaxLightGCN
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu.ops.spmm import BipartiteGraphOp
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.models import losses
from textgcn_tpu_torch.models.lightgcn import LightGCN
from textgcn_tpu_torch.ops import sampling
from textgcn_tpu_torch.ops.spmm import GraphOp, spmm_dropout_cuda
from textgcn_tpu_torch.train.checkpoint import make_checkpointer
from textgcn_tpu_torch.train.trainer import Trainer
from textgcn_tpu_torch.weights import params_from_jax, params_to_jax

SALT = 0x9E3779B9                      # high bit set
KEEP = float(np.float32(1.0 - 0.4))
D = 16
ATOL = 1e-5    # f32 sums of a few terms in another order


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def jax_hash_weights(op: BipartiteGraphOp, w_pairs):
    """``BipartiteGraphOp.weights`` with the hash mask in place of its
    Bernoulli draws: per direction (w_fwd, w_bwd) = edge_weight * scale."""
    out = []
    for salt, keep in w_pairs:
        w = op.w_u * jax_scale(op.eu_u, op.ei_u, jnp.uint32(salt),
                               jnp.float32(keep))
        out.append((w, w[op.perm_u2i]))
    (wu1, wi1), (wu2, wi2) = out
    return (wu1, wi1), (wi2, wu2)


# --- K1's gradient ----------------------------------------------------------

@pytest.mark.parametrize('direction', ['to_user', 'to_item'])
@pytest.mark.parametrize('keep', [1.0, KEEP])
def test_spmm_gradient_matches_jax_grad(dummy_dir, direction, keep):
    data = load_interactions(dummy_dir)
    g = data.graph
    jop = BipartiteGraphOp(g.edge_user, g.edge_item, g.edge_weight,
                           data.n_users, data.n_items)
    pop = GraphOp(g.edge_user, g.edge_item, g.edge_weight, data.n_users,
                  data.n_items, 'cpu')
    n_src, n_dst = ((data.n_items, data.n_users) if direction == 'to_user'
                    else (data.n_users, data.n_items))
    rng = np.random.RandomState(3)
    x = rng.randn(n_src, D).astype(np.float32)
    cot = rng.randn(n_dst, D).astype(np.float32)
    pairs = ((SALT, keep), (SALT ^ 0xFFFF, keep))
    w_to_user, w_to_item = jax_hash_weights(jop, pairs)
    w = w_to_user if direction == 'to_user' else w_to_item
    want = jax.grad(lambda v: (getattr(jop, direction)(v, w)
                               * cot).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    pair = pairs[0] if direction == 'to_user' else pairs[1]
    out = getattr(pop, direction)(xt, pair)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)
    assert spmm_dropout_cuda.launches == 0


# --- losses -----------------------------------------------------------------

@pytest.mark.parametrize('n_real', [8, 5])
def test_losses_match_jax_padded_and_ragged(n_real):
    rng = np.random.RandomState(n_real)
    b, n_neg = 8, 3
    ue = rng.randn(20, D).astype(np.float32)
    ie = rng.randn(15, D).astype(np.float32)
    users = rng.randint(0, 20, b)
    pos = rng.randint(0, 15, b)
    negs = rng.randint(0, 15, (b, n_neg))
    ps = rng.randn(b).astype(np.float32)
    ns = rng.randn(b, n_neg).astype(np.float32)
    mask = np.arange(b) < n_real
    want_bpr = float(jax_losses.bpr_loss(ps, ns, mask))
    want_reg = float(jax_losses.reg_loss(ue, ie, users, pos, negs, mask,
                                         1e-3))
    t = torch.from_numpy
    # padded batch with its mask, and the ragged batch of the real rows
    got_bpr = float(losses.bpr_loss(t(ps), t(ns), t(mask)))
    got_reg = float(losses.reg_loss(t(ue), t(ie), t(users), t(pos),
                                    t(negs), 1e-3, t(mask)))
    r = slice(0, n_real)
    rag_bpr = float(losses.bpr_loss(t(ps[r]), t(ns[r])))
    rag_reg = float(losses.reg_loss(t(ue), t(ie), t(users[r]), t(pos[r]),
                                    t(negs[r]), 1e-3))
    for got in (got_bpr, rag_bpr):
        np.testing.assert_allclose(got, want_bpr, rtol=1e-6, atol=1e-7)
    for got in (got_reg, rag_reg):
        np.testing.assert_allclose(got, want_reg, rtol=1e-6, atol=1e-9)


# --- sampling ---------------------------------------------------------------

def _heavy_tables(n_items=50):
    """User 0 owns all items but 2 (forces the bisection), user 1 a
    contiguous run, user 2 one item, user 3 two scattered items."""
    rows = [[i for i in range(n_items) if i not in (7, 31)],
            list(range(10, 35)), [4], [0, n_items - 1]]
    width = max(len(r) for r in rows)
    pos_padded = np.full((len(rows), width), n_items, np.int32)
    for u, r in enumerate(rows):
        pos_padded[u, :len(r)] = sorted(r)
    return rows, torch.from_numpy(pos_padded), torch.tensor(
        [len(r) for r in rows], dtype=torch.int32)


def test_sample_epoch_shapes_and_bucket_len(dummy_dir):
    data = load_interactions(dummy_dir)
    cfg = tconfig.Config(data=dummy_dir, emb_size=D,
                         neg_samples=2).finalize()
    model = LightGCN(cfg, data, device='cpu')
    assert model.bucket_len == data.n_train // data.n_users
    gen = torch.Generator().manual_seed(0)
    users, pos, negs = sampling.sample_epoch(
        gen, model.pos_padded, model.pos_degree,
        bucket_len=model.bucket_len, neg_samples=2, n_items=data.n_items)
    n = data.n_users * model.bucket_len
    assert users.shape == pos.shape == (n,) and negs.shape == (n, 2)
    assert np.array_equal(np.bincount(users.numpy(),
                                      minlength=data.n_users),
                          np.full(data.n_users, model.bucket_len))
    train = set(zip(data.graph.edge_user.tolist(),
                    data.graph.edge_item.tolist()))
    assert all((u, p) in train for u, p in zip(users.tolist(),
                                                 pos.tolist()))
    batches = model.sample_batches(gen, 16)
    assert len(batches) == model.num_batches(16) == -(-n // 16)
    assert [len(b[0]) for b in batches] == [16] * (n // 16) + (
        [n % 16] if n % 16 else [])


def test_negatives_are_never_positives_even_for_heavy_users():
    rows, pos_padded, deg = _heavy_tables()
    gen = torch.Generator().manual_seed(1)
    users, pos, negs = sampling.sample_epoch(
        gen, pos_padded, deg, bucket_len=400, neg_samples=3, n_items=50)
    for u, p, ns in zip(users.tolist(), pos.tolist(), negs.tolist()):
        assert p in rows[u]
        assert not set(ns) & set(rows[u]), (u, ns)
        assert all(0 <= x < 50 for x in ns)
    # user 0 draws from its two free items, both of them
    heavy = set(negs[users == 0].reshape(-1).tolist())
    assert heavy == {7, 31}


@pytest.mark.parametrize('seed', [0, 1])
def test_complement_bisection_is_the_rth_free_item(seed):
    rows, pos_padded, deg = _heavy_tables()
    n_items = 50
    keys = sampling.positive_keys(pos_padded, n_items)
    rng = np.random.RandomState(seed)
    users = torch.from_numpy(rng.randint(0, len(rows), 200))
    free = [np.setdiff1d(np.arange(n_items), r) for r in rows]
    r = torch.tensor([[rng.randint(len(free[u]))]
                      for u in users.tolist()])
    got = sampling.complement_rank(keys, pos_padded.shape[1], users, r,
                                   n_items)
    want = [free[u][k] for u, k in zip(users.tolist(), r[:, 0].tolist())]
    assert got[:, 0].tolist() == want


def test_is_positive_matches_sets():
    rows, pos_padded, _ = _heavy_tables()
    keys = sampling.positive_keys(pos_padded, 50)
    users = torch.arange(4).repeat_interleave(50)
    cand = torch.arange(50).repeat(4)[:, None]
    got = sampling.is_positive(keys, users, cand, 50)[:, 0].tolist()
    assert got == [c in rows[u] for u, c in zip(users.tolist(),
                                                cand[:, 0].tolist())]


# --- one Adam step and a trajectory against the JAX package ---------------

def _jax_lgcn(dummy_dir, lr=1e-2, reg=1e-3, single=False):
    cfg = JaxConfig(model='lgcn', data=dummy_dir, emb_size=D, lr=lr,
                    reg_lambda=reg, dropout=0.4, n_layers=3, single=single,
                    save_path='/nonexistent').finalize()
    return JaxLightGCN(cfg, jax_load(dummy_dir))


def _port_lgcn(dummy_dir, params, lr=1e-2, reg=1e-3, single=False):
    data = load_interactions(dummy_dir)
    cfg = tconfig.Config(model='lgcn', data=dummy_dir, emb_size=D, lr=lr,
                         reg_lambda=reg, dropout=0.4, n_layers=3,
                         single=single, save=False, k=(3,),
                         save_path='/nonexistent').finalize()
    model = LightGCN(cfg, data, device='cpu')
    model.load_params(params_from_jax(params, data.n_users, data.n_items))
    return Trainer(cfg, model, data)


def _batch(rng, data, b=8, n_neg=2):
    users = rng.randint(0, data.n_users, b)
    pos = np.array([data.pos_padded[u][rng.randint(data.pos_degree[u])]
                    for u in users])
    negs = rng.randint(0, data.n_items, (b, n_neg))
    return users, pos, negs


def _jax_step(jm, opt, state, params, batch, w_pairs):
    jm.graph_op.weights = lambda key, dropout: jax_hash_weights(
        jm.graph_op, w_pairs)
    users, pos, negs = (jnp.asarray(a, jnp.int32) for a in batch)
    mask = jnp.ones(users.shape[0], bool)
    (loss, aux), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, (users, pos, negs, mask), jax.random.key(0))
    updates, state = opt.update(grads, state, params)
    return loss, aux, grads, optax.apply_updates(params, updates), state


@pytest.mark.parametrize('single', [False, True])
def test_one_lgcn_step_matches_jax(dummy_dir, single):
    jm = _jax_lgcn(dummy_dir, single=single)
    rng = np.random.RandomState(5)
    params = {'user_emb': (0.1 * rng.randn(jm.n_users, D)).astype(
        np.float32), 'item_emb': (0.1 * rng.randn(jm.n_items, D)).astype(
        np.float32)}
    batch = _batch(rng, load_interactions(dummy_dir))
    w_pairs = ((SALT, KEEP), (SALT + 12345, KEEP))
    opt = optax.adam(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    loss, aux, grads, new, _ = _jax_step(jm, opt, opt.init(jp), jp, batch,
                                         w_pairs)

    tr = _port_lgcn(dummy_dir, params, single=single)
    tb = tuple(torch.from_numpy(a.astype(np.int64)) for a in batch)
    t_loss, t_aux = tr.train_step(tb, w_pairs)
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-5,
                               atol=1e-6)
    for c in ('bpr', 'reg'):
        np.testing.assert_allclose(float(t_aux[c]), float(aux[c]),
                                   rtol=1e-5, atol=1e-7)
    m = tr.model
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(getattr(m, name).grad.numpy(),
                                   np.asarray(grads[name]), atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(getattr(m, name).detach().numpy(),
                                   np.asarray(new[name]), atol=1e-5,
                                   rtol=0)


def test_lgcn_trajectory_of_20_steps_matches_jax(dummy_dir):
    jm = _jax_lgcn(dummy_dir)
    data = load_interactions(dummy_dir)
    rng = np.random.RandomState(9)
    params = {'user_emb': (0.1 * rng.randn(jm.n_users, D)).astype(
        np.float32), 'item_emb': (0.1 * rng.randn(jm.n_items, D)).astype(
        np.float32)}
    opt = optax.adam(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    tr = _port_lgcn(dummy_dir, params)
    for step in range(20):
        batch = _batch(rng, data)
        w_pairs = ((int(rng.randint(2**32, dtype=np.uint64)), KEEP),
                   (int(rng.randint(2**32, dtype=np.uint64)), KEEP))
        _, _, _, jp, state = _jax_step(jm, opt, state, jp, batch, w_pairs)
        tr.train_step(tuple(torch.from_numpy(a.astype(np.int64))
                            for a in batch), w_pairs)
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(getattr(tr.model, name).detach().numpy(),
                                   np.asarray(jp[name]), atol=1e-4, rtol=0)


# --- the trainer ------------------------------------------------------------

def test_fit_checkpoints_in_the_jax_format(tmp_path, monkeypatch,
                                           dummy_dir):
    """``lgcn`` trains through the CLI on the CPU; ``best.pkl`` loads into
    the JAX package with the port's metrics, and the port serves it
    again with the same metrics."""
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    common = ['--model', 'lgcn', '--data', dummy_dir, '--emb_size', str(D),
              '--batch_size', '16', '-k', '3', '5', '--quiet']
    pt = port_main(common + ['--epochs', '4', '--evaluate_every', '4',
                             '--uid', 'port'])
    run = tmp_path / 'runs/dummy/port'
    assert sorted(p.name for p in run.iterdir()) == [
        'best.pkl', 'latest_checkpoint.pkl', 'log.log', 'resume_state.pkl']
    assert len(pt.loss_history) == 4
    assert all(np.isfinite(h['loss']) for h in pt.loss_history)
    with open(run / 'best.pkl', 'rb') as f:
        state = pickle.load(f)
    assert state['epoch'] == 4 and state['model'] == 'lgcn'
    assert set(state['params']) == {'user_emb', 'item_emb'}
    jt = jax_main(common + ['--no_train', '--load', str(run), '--uid',
                            'jax'])
    again = port_main(common + ['--no_train', '--load', str(run), '--uid',
                                'again'])
    jm = jt.evaluate()
    for name, want in pt.last_metrics.items():
        np.testing.assert_allclose(jm[name], want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(again.last_metrics[name], want,
                                   atol=1e-6, rtol=0)


def test_load_warm_starts_training(tmp_path, monkeypatch, dummy_dir):
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    data = load_interactions(dummy_dir)
    rng = np.random.RandomState(2)
    params = {'user_emb': rng.randn(data.n_users, D).astype(np.float32),
              'item_emb': rng.randn(data.n_items, D).astype(np.float32)}
    with open(tmp_path / 'ck.pkl', 'wb') as f:
        pickle.dump({'params': params, 'epoch': 1, 'model': 'lgcn'}, f)
    argv = ['--model', 'lgcn', '--data', dummy_dir, '--emb_size', str(D),
            '-k', '3', '--quiet', '--load', str(tmp_path / 'ck.pkl'),
            '--epochs', '1', '--lr', '0', '--no_save']
    pt = port_main(argv + ['--uid', 'warm'])
    np.testing.assert_allclose(pt.model.user_emb.detach().numpy(),
                               params['user_emb'], atol=1e-7)
    assert not os.path.exists(tmp_path / 'runs/dummy/warm/best.pkl')


def test_nan_loss_stops_training(dummy_dir):
    data = load_interactions(dummy_dir)
    cfg = tconfig.Config(data=dummy_dir, emb_size=D, k=(3,), epochs=2,
                         save=False, save_path='/nonexistent').finalize()
    model = LightGCN(cfg, data, device='cpu')
    with torch.no_grad():
        model.user_emb[0] = float('nan')
    with pytest.raises(FloatingPointError, match='NA at epoch 1'):
        Trainer(cfg, model, data).fit()


def test_best_is_promoted_only_after_an_eval(tmp_path, dummy_dir):
    data = load_interactions(dummy_dir)
    cfg = tconfig.Config(data=dummy_dir, emb_size=D, k=(3,),
                         save_path=str(tmp_path)).finalize()
    tr = Trainer(cfg, LightGCN(cfg, data, device='cpu'), data)
    tr.checkpoint(1)
    assert not (tmp_path / 'best.pkl').exists()
    tr.evaluate(2)
    tr.checkpoint(2)
    assert (tmp_path / 'best.pkl').exists()
    assert make_checkpointer().load(str(tmp_path))['epoch'] == 2


def test_params_round_trip_through_the_jax_tree():
    rng = np.random.RandomState(0)
    tree = {'user_emb': rng.randn(5, 4).astype(np.float32),
            'item_emb': rng.randn(3, 4).astype(np.float32),
            'convs': [{'w': rng.randn(4, 4).astype(np.float32),
                       'a_src': rng.randn(4).astype(np.float32),
                       'a_dst': rng.randn(4).astype(np.float32),
                       'b': rng.randn(4).astype(np.float32)}]}
    back = params_to_jax(params_from_jax(tree, 5, 3))
    assert back.keys() == tree.keys()
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_array_equal(back[name], tree[name])
    for k, v in tree['convs'][0].items():
        assert back['convs'][0][k].dtype == np.float32
        np.testing.assert_array_equal(back['convs'][0][k], v)
