"""The port's GAT (``ops/gat.py``, ``models/conv.py``) against the JAX
package's, on the CPU.

K3 and K4 run only on the card, where ``chip_smoke.py`` holds them against
``gat_att_plain``/``gat_bwd_plain``; here the autograd function takes the
plain versions.  The oracle with dropout is the JAX package's segment
softmax (``conv._attention_direction``/``conv_layer``) with {0, 1} masks
from ``edge_dropout_scale``, since its CPU model would draw Bernoulli
masks; once also its Pallas ``gat_direction`` in interpret mode.
Tolerances: forward rtol 1e-5, gradients atol = rtol = 1e-4, as
``tests/test_pallas_gat.py`` states them (f32 sums in another order).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers.torch_native import ensure_jax_native
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu import native
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data.core import load_interactions as jax_load
from textgcn_tpu.models.conv import ConvModel as JaxConvModel
from textgcn_tpu.models.conv import _attention_direction, _leaky, conv_layer
from textgcn_tpu.ops.pallas_spmm import PallasGraphOp
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.models.conv import ConvModel
from textgcn_tpu_torch.ops import gat
from textgcn_tpu_torch.ops.spmm import GraphOp
from textgcn_tpu_torch.train.trainer import Trainer
from textgcn_tpu_torch.weights import params_from_jax

SALT = 0x9E3779B9
KEEP = float(np.float32(1.0 - 0.4))
D = 16


@pytest.fixture(scope='module', autouse=True)
def _jax_native():
    """The JAX oracle lays out its tiles through its native builder
    (``tests/helpers/torch_native.py``), never the numpy fallback."""
    ensure_jax_native(native)


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def _graph(seed=0, nu=60, ni=45, e=260):
    """Unique random edges over the low ids only: users >= 50 and items
    >= 38 are isolated."""
    rng = np.random.RandomState(seed)
    pairs = np.unique(np.stack([rng.randint(0, nu - 10, e),
                                rng.randint(0, ni - 7, e)], 1), axis=0)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)


def _mask01(eu, ei, salt, keep):
    return (jax_scale(jnp.asarray(eu), jnp.asarray(ei), jnp.uint32(salt),
                      jnp.float32(keep)) > 0).astype(jnp.float32)


def _inputs(rng, nu, ni, d=D):
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return f(nu, d), f(ni, d), f(nu), f(ni), f(nu), f(ni)


@pytest.mark.parametrize('direction', ['to_user', 'to_item'])
@pytest.mark.parametrize('keep', [1.0, KEEP, float(np.float32(0.15))])
def test_gat_direction_matches_segment_softmax(direction, keep):
    """Forward and gradients in h (both sides), s (both sides) and d, with
    rows whose edges are all dropped and isolated rows."""
    nu, ni = 60, 45
    eu, ei = _graph()
    op = GraphOp(eu, ei, np.ones(len(eu), np.float32), nu, ni, 'cpu')
    rng = np.random.RandomState(1)
    h_u, h_i, s_u, s_i, d_u, d_i = _inputs(rng, nu, ni)
    mask = _mask01(eu, ei, SALT, keep)
    if direction == 'to_user':
        args = (h_i, h_u, s_i, s_u, d_u)
        src, dst, n_dst = ei, eu, nu
    else:
        args = (h_u, h_i, s_u, s_i, d_i)
        src, dst, n_dst = eu, ei, ni
    cot = rng.randn(n_dst, D).astype(np.float32)
    if keep < 0.5:   # some destinations with edges keep none of them
        kept = np.bincount(dst, weights=np.asarray(mask), minlength=n_dst)
        assert ((np.bincount(dst, minlength=n_dst) > 0) & (kept == 0)).any()

    def jax_out(h_src, h_dst, s_src, s_dst, d_dst):
        return _attention_direction(
            h_src, _leaky(s_src[src] + d_dst[dst]), _leaky(s_dst + d_dst),
            h_dst, src, dst, mask, n_dst)

    want, vjp = jax.vjp(jax_out, *map(jnp.asarray, args))
    want_g = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = gat.gat_direction(op, direction, *targs, SALT, keep)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for t, w in zip(targs, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)
    assert gat.gat_fwd_cuda.launches == gat.gat_bwd_cuda.launches == 0


def test_plain_outputs_at_the_sentinel():
    """A destination without a kept edge: num = 0, den = 0, m = NEG, and
    its backward contributions are exact zeros."""
    eu, ei = _graph(2)
    op = GraphOp(eu, ei, np.ones(len(eu), np.float32), 60, 45, 'cpu')
    rng = np.random.RandomState(0)
    h_u, h_i, s_u, s_i, d_u, _ = map(torch.from_numpy,
                                     _inputs(rng, 60, 45))
    keep = float(np.float32(0.05))
    num, den, m = gat.gat_att_plain(op.l_i2u, h_i, s_i, d_u, SALT, keep)
    empty = m == gat.NEG
    assert empty.sum() > 10 and (~empty).any()
    assert (num[empty] == 0).all() and (den[empty] == 0).all()
    assert (den[~empty] >= 1.0 - 1e-6).all()      # the max edge has e = 1
    g_num = torch.randn(60, D, generator=torch.Generator().manual_seed(1))
    g_den = torch.randn(60, generator=torch.Generator().manual_seed(2))
    dh, ds, dd = gat.gat_bwd_plain(op.l_u2i, h_i, s_i, d_u, m, g_num,
                                   g_den, SALT, keep)
    assert (dd[empty] == 0).all()
    assert torch.isfinite(dh).all() and torch.isfinite(ds).all()


def test_gat_direction_matches_jax_pallas_interpret(monkeypatch):
    """Once against the JAX package's own kernel path: a tiny
    single-split ``PallasGraphOp`` run in interpret mode in f32."""
    from textgcn_tpu.ops.pallas_gat import gat_direction as jax_gat
    monkeypatch.setenv('TEXTGCN_TPU_PALLAS_XDTYPE', 'f32')
    nu, ni, pad = 60, 45, 512
    eu, ei = _graph(3)
    ones = np.ones(len(eu), np.float32)
    jop = PallasGraphOp(eu, ei, ones, pad, pad, D, interpret=True)
    assert len(jop.l_i2u.splits) == 1
    op = GraphOp(eu, ei, ones, nu, ni, 'cpu')
    rng = np.random.RandomState(4)
    h_u, h_i, s_u, s_i, d_u, _ = _inputs(rng, nu, ni)

    def padded(a):
        out = np.zeros((pad,) + a.shape[1:], np.float32)
        out[:len(a)] = a
        return jnp.asarray(out)

    cot = rng.randn(nu, D).astype(np.float32)

    def loss(hi):
        out = jax_gat(jop, 'to_user', hi, padded(h_u), padded(s_i),
                      padded(s_u), padded(d_u), jnp.uint32(SALT),
                      jnp.float32(KEEP), interpret=True)
        return (out[:nu] * cot).sum(), out[:nu]

    (_, want), g_want = jax.value_and_grad(loss, has_aux=True)(padded(h_i))
    hi = torch.from_numpy(h_i).requires_grad_()
    got = gat.gat_direction(op, 'to_user', hi, torch.from_numpy(h_u),
                            torch.from_numpy(s_i), torch.from_numpy(s_u),
                            torch.from_numpy(d_u), SALT, KEEP)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hi.grad.numpy(), np.asarray(g_want)[:ni],
                               atol=1e-4, rtol=1e-4)


def test_kernel_wrappers_refuse_cpu_tensors():
    eu, ei = _graph()
    op = GraphOp(eu, ei, np.ones(len(eu), np.float32), 60, 45, 'cpu')
    h_i, s_i, d_u = torch.randn(45, D), torch.randn(45), torch.randn(60)
    with pytest.raises(ValueError, match='CUDA'):
        gat.gat_fwd_cuda(op.l_i2u, h_i, s_i, d_u, 0, 1.0)
    with pytest.raises(ValueError, match='CUDA'):
        gat.gat_bwd_cuda(op.l_u2i, h_i, s_i, d_u, d_u, torch.randn(60, D),
                         torch.randn(60), 0, 1.0)
    with pytest.raises(ValueError, match='s_src'):
        gat.gat_att_plain(op.l_i2u, h_i, torch.randn(44), d_u, 0, 1.0)
    assert gat.gat_fwd_cuda.launches == gat.gat_bwd_cuda.launches == 0


# --- the model ----------------------------------------------------------------

def _configs(dummy_dir, **kw):
    common = dict(model='gat', aggr='mean', data=dummy_dir, emb_size=D,
                  lr=1e-2, reg_lambda=1e-3, dropout=0.4, n_layers=2,
                  save_path='/nonexistent')
    common.update(kw)
    return (JaxConfig(**common).finalize(),
            tconfig.Config(save=False, k=(3,), **common).finalize())


def _gat_params(rng, n_users, n_items, n_layers):
    f = lambda *s: (0.3 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    return {'user_emb': f(n_users, D), 'item_emb': f(n_items, D),
            'convs': [{'w': f(D, D), 'a_src': f(D), 'a_dst': f(D),
                       'b': f(D)} for _ in range(n_layers)]}


@pytest.mark.parametrize('single', [False, True])
def test_one_gat_step_matches_jax(dummy_dir, single):
    """Loss, gradients of every parameter and the tables after one Adam
    step, against ``ConvModel.loss`` + ``optax.adam`` with the hash
    masks of the same salts."""
    jcfg, tcfg = _configs(dummy_dir, single=single)
    jm = JaxConvModel(jcfg, jax_load(dummy_dir))
    data = load_interactions(dummy_dir)
    rng = np.random.RandomState(7)
    params = _gat_params(rng, data.n_users, data.n_items, 2)
    users = rng.randint(0, data.n_users, 8)
    pos = np.array([data.pos_padded[u][rng.randint(data.pos_degree[u])]
                    for u in users])
    negs = rng.randint(0, data.n_items, (8, 2))
    w_pairs = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))

    e = jm.conv_edges
    m_u = _mask01(e['edge_user'], e['edge_item'], w_pairs[0][0], KEEP)
    m_i = _mask01(e['edge_user'], e['edge_item'], w_pairs[1][0], KEEP)

    def hashed(params, *, training=False, dropout_key=None):
        assert training

        def step(lp, u, i):
            return conv_layer(lp, 'gat', 'mean', u, i, e['edge_user'],
                              e['edge_item'], m_u, m_i, e['edge_weight'])
        return jm._layer_combine(params, step)

    jm.representation = hashed
    jp = jax.tree.map(jnp.asarray, params)
    batch = tuple(jnp.asarray(a, jnp.int32) for a in (users, pos, negs))
    (loss, aux), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, (*batch, jnp.ones(8, bool)), jax.random.key(0))
    opt = optax.adam(1e-2)
    updates, _ = opt.update(grads, opt.init(jp), jp)
    new = optax.apply_updates(jp, updates)

    model = ConvModel(tcfg, data, device='cpu')
    model.load_params(params_from_jax(params, data.n_users, data.n_items))
    tr = Trainer(tcfg, model, data)
    t_loss, _ = tr.train_step(tuple(torch.from_numpy(a.astype(np.int64))
                                    for a in (users, pos, negs)), w_pairs)
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-5,
                               atol=1e-6)
    tree = model.param_tree()
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(tree[name].grad.numpy(),
                                   np.asarray(grads[name]), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(tree[name].detach().numpy(),
                                   np.asarray(new[name]), atol=1e-5, rtol=0)
    for lp, g, n in zip(tree['convs'], grads['convs'], new['convs']):
        for k in ('w', 'a_src', 'a_dst', 'b'):
            np.testing.assert_allclose(lp[k].grad.numpy(), np.asarray(g[k]),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(lp[k].detach().numpy(),
                                       np.asarray(n[k]), atol=1e-5, rtol=0,
                                       err_msg=k)


def test_conv_model_init_and_refusals(dummy_dir):
    data = load_interactions(dummy_dir)
    _, cfg = _configs(dummy_dir, n_layers=3)
    a = ConvModel(cfg, data, device='cpu')
    b = ConvModel(cfg, data, device='cpu')
    assert len(a.convs) == 3
    for la, lb in zip(a.convs, b.convs):
        for k in ('w', 'a_src', 'a_dst', 'b'):
            assert torch.equal(la[k], lb[k])
    w = a.convs[0]['w'].detach()
    assert w.shape == (D, D) and float(w.abs().max()) <= np.sqrt(6 / (2 * D))
    assert float(a.convs[0]['a_src'].detach().abs().max()) <= np.sqrt(
        6 / (D + 1))
    assert (a.convs[0]['b'] == 0).all()
    tree = a.param_tree()
    assert sorted(tree) == ['convs', 'item_emb', 'user_emb']
    bad = tconfig.Config(model='lgcn', aggr='mean', data=dummy_dir)
    with pytest.raises(ValueError, match='not a conv model'):
        ConvModel(bad.finalize(), data, device='cpu')
    no_aggr = tconfig.Config(model='gat', data=dummy_dir)
    with pytest.raises(ValueError, match='--aggr'):
        ConvModel(no_aggr.finalize(), data, device='cpu')
    for name in ('gcn', 'graphsage', 'gat', 'gatv2'):
        with pytest.raises(ValueError, match='--aggr'):
            tconfig.parse_args(['--model', name])
    # serving mode, refused until the port had it, parses
    assert tconfig.parse_args(['--model', 'gbdt', '--approx_topk',
                               '0.9']).approx_topk == 0.9


def test_cli_trains_gat_and_jax_loads_it(tmp_path, monkeypatch, dummy_dir):
    """``--model gat --aggr mean`` trains on data/dummy on the CPU, writes
    ``best.pkl`` with its conv layers, and the JAX package's
    ``Trainer.load`` of that file reproduces the port's metrics."""
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    common = ['--model', 'gat', '--aggr', 'mean', '--data', dummy_dir,
              '--emb_size', str(D), '--batch_size', '16', '-k', '3', '5',
              '--quiet']
    pt = port_main(common + ['--epochs', '3', '--evaluate_every', '3',
                             '--uid', 'port'])
    assert len(pt.loss_history) == 3
    assert all(np.isfinite(h['loss']) for h in pt.loss_history)
    run = tmp_path / 'runs/dummy/port'
    assert (run / 'best.pkl').exists()
    jt = jax_main(common + ['--no_train', '--load', str(run), '--uid',
                            'jax'])
    got = jt.evaluate()
    for name, want in pt.last_metrics.items():
        np.testing.assert_allclose(got[name], want, atol=1e-6, rtol=0)
