"""The port's conv family (``models/conv.py``: ``gcn``, ``graphsage`` with
each aggregator, ``gatv2``, and ``gat``) against the JAX package's, on
the CPU.

``gcn`` and ``graphsage`` mean|sum run K1 on the unit-weight graph op,
``gatv2`` K5/K6 and ``gat`` K3/K4; here every one of them takes its plain
version.  Dropout is the hash mask of the given salts on both sides: the
JAX side gets it as injected {0, 1} masks (``conv_layer``'s
``mask_to_user``/``mask_to_item``), since its CPU model would draw
Bernoulli masks.  Tolerances: forward rtol 1e-5; gradients, one Adam
step and the whole representation 1e-4 (f32 sums in another order
through two layers); a checkpoint re-served by the JAX package 1e-6.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data.core import load_interactions as jax_load
from textgcn_tpu.models.conv import ConvModel as JaxConvModel
from textgcn_tpu.models.conv import conv_layer as jax_conv_layer
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.models.conv import ConvModel, conv_layer
from textgcn_tpu_torch.ops import gat
from textgcn_tpu_torch.ops.spmm import GraphOp, spmm_dropout_cuda
from textgcn_tpu_torch.train.trainer import Trainer
from textgcn_tpu_torch.weights import params_from_jax

SALT = 0x9E3779B9
KEEP = float(np.float32(1.0 - 0.4))
D = 16
NU, NI = 60, 45
W_PAIRS = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))
CONVS = [('gcn', 'mean'), ('graphsage', 'mean'), ('graphsage', 'sum'),
         ('graphsage', 'max'), ('gatv2', 'mean'), ('gat', 'mean')]
CONV_IDS = [f'{c}-{a}' for c, a in CONVS]
# per conv: each parameter's shape, from d
SHAPES = {
    'gcn': {'w': 2, 'b': 1},
    'graphsage': {'w_nbr': 2, 'w_root': 2, 'b': 1},
    'gat': {'w': 2, 'a_src': 1, 'a_dst': 1, 'b': 1},
    'gatv2': {'w_src': 2, 'w_dst': 2, 'a': 1, 'b': 1},
}


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def _no_launches():
    return (spmm_dropout_cuda.launches == gat.gat_fwd_cuda.launches
            == gat.gat_bwd_cuda.launches == gat.gatv2_fwd_cuda.launches
            == gat.gatv2_bwd_cuda.launches == 0)


def _layer_params(rng, conv, scale=0.3):
    return {k: (scale * rng.randn(*(D,) * n)).astype(np.float32)
            for k, n in SHAPES[conv].items()}


def _mask01(eu, ei, salt, keep=KEEP):
    return (jax_scale(jnp.asarray(eu), jnp.asarray(ei), jnp.uint32(salt),
                      jnp.float32(keep)) > 0).astype(jnp.float32)


def _graph(seed=0, e=260):
    """Unique random edges over the low ids only: users >= 50 and items
    >= 38 are isolated."""
    rng = np.random.RandomState(seed)
    pairs = np.unique(np.stack([rng.randint(0, NU - 10, e),
                                rng.randint(0, NI - 7, e)], 1), axis=0)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)


@pytest.mark.parametrize('conv, aggr', CONVS, ids=CONV_IDS)
@pytest.mark.parametrize('keep', [1.0, float(np.float32(0.15))])
def test_one_layer_matches_jax_conv_layer(conv, aggr, keep):
    """One layer in both directions, forward and the gradients in both
    tables and every layer parameter, against ``conv_layer`` with the
    hash masks injected.  At keep 0.15 some rows keep no edge."""
    eu, ei = _graph()
    op = GraphOp(eu, ei, np.ones(len(eu), np.float32), NU, NI, 'cpu')
    rng = np.random.RandomState(1)
    lp = _layer_params(rng, conv)
    u = rng.randn(NU, D).astype(np.float32)
    i = rng.randn(NI, D).astype(np.float32)
    cu = rng.randn(NU, D).astype(np.float32)
    ci = rng.randn(NI, D).astype(np.float32)
    pairs = ((SALT, keep), (SALT ^ 0x5A5A5A5A, keep))
    m_u, m_i = (_mask01(eu, ei, s, keep) for s, _ in pairs)

    def jax_fn(lp, u, i):
        return jax_conv_layer(lp, conv, aggr, u, i, jnp.asarray(eu),
                              jnp.asarray(ei), m_u, m_i,
                              jnp.ones(len(eu), jnp.float32))

    (want_u, want_i), vjp = jax.vjp(jax_fn, jax.tree.map(jnp.asarray, lp),
                                    jnp.asarray(u), jnp.asarray(i))
    g_lp, g_u, g_i = vjp((jnp.asarray(cu), jnp.asarray(ci)))

    tlp = {k: torch.from_numpy(v).requires_grad_() for k, v in lp.items()}
    tu = torch.from_numpy(u).requires_grad_()
    ti = torch.from_numpy(i).requires_grad_()
    got_u, got_i = conv_layer(tlp, conv, aggr, op, tu, ti, pairs)
    ((got_u * torch.from_numpy(cu)).sum()
     + (got_i * torch.from_numpy(ci)).sum()).backward()
    for got, want in ((got_u, want_u), (got_i, want_i)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    grads = [('u', tu, g_u), ('i', ti, g_i)] + [
        (k, tlp[k], g_lp[k]) for k in lp]
    for name, t, want in grads:
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    assert _no_launches()


def _configs(dummy_dir, conv, aggr):
    common = dict(model=conv, aggr=aggr, data=dummy_dir, emb_size=D,
                  lr=1e-2, reg_lambda=1e-3, dropout=0.4, n_layers=2,
                  save_path='/nonexistent')
    return (JaxConfig(**common).finalize(),
            tconfig.Config(save=False, k=(3,), **common).finalize())


@pytest.mark.parametrize('conv, aggr', CONVS[:-1], ids=CONV_IDS[:-1])
def test_representation_and_one_step_match_jax(dummy_dir, conv, aggr):
    """The whole two-layer representation (with dropout, and without), then
    the loss, the gradients of every parameter and the parameters after
    one Adam step, against the JAX ``ConvModel`` on the same params, batch
    and hash masks of the same salts."""
    jcfg, tcfg = _configs(dummy_dir, conv, aggr)
    jm = JaxConvModel(jcfg, jax_load(dummy_dir))
    data = load_interactions(dummy_dir)
    rng = np.random.RandomState(7)
    f = lambda *s: (0.3 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    params = {'user_emb': f(data.n_users, D), 'item_emb': f(data.n_items, D),
              'convs': [_layer_params(rng, conv) for _ in range(2)]}
    users = rng.randint(0, data.n_users, 8)
    pos = np.array([data.pos_padded[u][rng.randint(data.pos_degree[u])]
                    for u in users])
    negs = rng.randint(0, data.n_items, (8, 2))

    e = jm.conv_edges
    m_u, m_i = (_mask01(e['edge_user'], e['edge_item'], s)
                for s, _ in W_PAIRS)
    eval_repr = jm.representation

    def hashed(params, *, training=False, dropout_key=None):
        assert training

        def step(lp, u, i):
            return jax_conv_layer(lp, conv, aggr, u, i, e['edge_user'],
                                  e['edge_item'], m_u, m_i,
                                  e['edge_weight'])
        return jm._layer_combine(params, step)

    jm.representation = hashed
    jp = jax.tree.map(jnp.asarray, params)
    model = ConvModel(tcfg, data, device='cpu')
    model.load_params(params_from_jax(params, data.n_users, data.n_items))
    with torch.no_grad():
        for training, want in ((True, hashed(jp, training=True)),
                               (False, eval_repr(jp))):
            got = model.representation(training=training, w_pairs=W_PAIRS)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-4, rtol=1e-4)

    batch = tuple(jnp.asarray(a, jnp.int32) for a in (users, pos, negs))
    (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, (*batch, jnp.ones(8, bool)), jax.random.key(0))

    tr = Trainer(tcfg, model, data)
    t_loss, _ = tr.train_step(tuple(torch.from_numpy(a.astype(np.int64))
                                    for a in (users, pos, negs)), W_PAIRS)
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-5,
                               atol=1e-6)
    tree = model.param_tree()
    t_grads = jax.tree.map(lambda t: jnp.asarray(t.grad.numpy()), tree)
    np.testing.assert_equal(jax.tree.structure(t_grads),
                            jax.tree.structure(grads))
    for (name, g), (_, want) in zip(_leaves(t_grads), _leaves(grads)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(want),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    # Adam's first step is lr * g / (|g| + eps): an entry whose gradient
    # cancels to rounding noise (GATv2's dhd column under an all-positive
    # leaky, GCN's too) moves by noise / eps.  So the step is held against
    # optax on the port's own gradients, which match the JAX ones above.
    opt = optax.adam(1e-2)
    updates, _ = opt.update(t_grads, opt.init(jp), jp)
    new = optax.apply_updates(jp, updates)
    for (name, t), (_, n) in zip(_leaves(tree), _leaves(new)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(n),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert _no_launches()


def _leaves(tree):
    """``[(path, leaf)]`` of a parameter tree, in a fixed order."""
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_conv_family_uses_a_unit_weight_graph_op(dummy_dir):
    """The conv family's op carries unit weights (K1 on it is a masked
    sum); LightGCN's keeps the 1/sqrt(deg_u deg_i) normalisation."""
    from textgcn_tpu_torch.models.lightgcn import LightGCN
    data = load_interactions(dummy_dir)
    _, cfg = _configs(dummy_dir, 'gcn', 'mean')
    conv = ConvModel(cfg, data, device='cpu')
    for csr in (conv.graph_op.l_i2u, conv.graph_op.l_u2i):
        assert (csr.w == 1).all()
    lgcn = LightGCN(tconfig.Config(data=dummy_dir, emb_size=D).finalize(),
                    data, device='cpu')
    assert not (lgcn.graph_op.l_i2u.w == 1).all()
    assert sorted(conv.convs[0].keys()) == ['b', 'w']


@pytest.mark.parametrize('conv, aggr', CONVS[:-1], ids=CONV_IDS[:-1])
def test_cli_trains_and_jax_reserves_it(tmp_path, monkeypatch, dummy_dir,
                                        conv, aggr):
    """``--model <conv> --aggr <aggr>`` trains on data/dummy on the CPU and
    writes ``best.pkl`` with its conv layers; the JAX package's
    ``--no_train --load`` of that file reproduces the port's metrics."""
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    common = ['--model', conv, '--aggr', aggr, '--data', dummy_dir,
              '--emb_size', str(D), '--n_layers', '2', '--batch_size', '16',
              '-k', '3', '5', '--quiet']
    pt = port_main(common + ['--epochs', '2', '--evaluate_every', '2',
                             '--uid', 'port'])
    assert len(pt.loss_history) == 2
    assert all(np.isfinite(h['loss']) for h in pt.loss_history)
    run = tmp_path / 'runs/dummy/port'
    assert (run / 'best.pkl').exists()
    jt = jax_main(common + ['--no_train', '--load', str(run), '--uid',
                            'jax'])
    got = jt.evaluate()
    for name, want in pt.last_metrics.items():
        np.testing.assert_allclose(got[name], want, atol=1e-6, rtol=0)
