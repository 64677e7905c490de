"""The port's ``gat`` over many steps, and the bf16 rounding of
``TEXTGCN_TPU_PALLAS_XDTYPE``, against the JAX package on the CPU.

* A 20-step ``gat --aggr mean`` Adam trajectory on ``data/dummy`` (dropout
  0.4, d = 16, 2 layers): the same tables, batches and hash salts go into
  both packages; the JAX side takes the hash masks through its exact-f32
  ``conv_layer`` (its CPU model would draw Bernoulli masks), under
  ``jax.jit``, with ``optax.adam``.  Every step's loss agrees within 1e-4
  relative and the final parameters within 1e-4.  It would show a fault
  of the port's ``gat`` that one step does not.
* ``TEXTGCN_TPU_PALLAS_XDTYPE=bf16``: K1's (``GraphOp``), K3/K4's
  (``gat_direction``) and K5/K6's (``gatv2_direction``) plain versions
  against the JAX package's Pallas ops built with ``x_dtype=bfloat16``,
  in interpret mode: forward 1e-5 and gradients 1e-4, as the f32 tests
  hold them; the default (f32) differs from the bf16 result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers.torch_native import ensure_jax_native
from textgcn_tpu import native
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data.core import load_interactions as jax_load
from textgcn_tpu.models.conv import ConvModel as JaxConvModel
from textgcn_tpu.models.conv import conv_layer
from textgcn_tpu.ops.pallas_spmm import PallasGraphOp
from textgcn_tpu.ops.pallas_spmm import edge_dropout_scale as jax_scale
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.models.conv import ConvModel
from textgcn_tpu_torch.ops import gat
from textgcn_tpu_torch.ops.spmm import (XDTYPE_ENV, GraphOp,
                                        gathered_dtype, spmm_dropout_cuda)
from textgcn_tpu_torch.train.trainer import Trainer
from textgcn_tpu_torch.weights import params_from_jax

D = 16
STEPS = 20
BATCH = 16
LR = 5e-3
KEEP = float(np.float32(1.0 - 0.4))
SALT = 0x9E3779B9


@pytest.fixture(scope='module', autouse=True)
def _jax_native():
    """The JAX oracle lays out its tiles through its native builder
    (``tests/helpers/torch_native.py``), never the numpy fallback."""
    ensure_jax_native(native)


def _mask01(eu, ei, salt):
    return (jax_scale(eu, ei, jnp.uint32(salt), jnp.float32(KEEP))
            > 0).astype(jnp.float32)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gat_trajectory_of_20_steps_matches_jax(dummy_dir, one_thread):
    common = dict(model='gat', aggr='mean', data=dummy_dir, emb_size=D,
                  lr=LR, reg_lambda=1e-3, dropout=0.4, n_layers=2,
                  save_path='/nonexistent')
    jm = JaxConvModel(JaxConfig(**common).finalize(), jax_load(dummy_dir))
    tcfg = tconfig.Config(save=False, k=(3,), **common).finalize()
    data = load_interactions(dummy_dir)
    rng = np.random.RandomState(20)
    f = lambda *s: (0.3 * rng.randn(*s)).astype(np.float32)  # noqa: E731
    params = {'user_emb': f(data.n_users, D), 'item_emb': f(data.n_items, D),
              'convs': [{'w': f(D, D), 'a_src': f(D), 'a_dst': f(D),
                         'b': np.zeros(D, np.float32)} for _ in range(2)]}
    batches, salts = [], []
    for _ in range(STEPS):
        users = rng.randint(0, data.n_users, BATCH)
        pos = np.array([data.pos_padded[u][rng.randint(data.pos_degree[u])]
                        for u in users])
        batches.append((users, pos, rng.randint(0, data.n_items,
                                                (BATCH, 1))))
        salts.append(tuple(int(s) for s in rng.randint(0, 2**32, 2,
                                                       dtype=np.uint64)))

    e = jm.conv_edges

    def jax_loss(p, batch, m_u, m_i):
        def hashed(p, *, training=False, dropout_key=None):
            assert training
            return jm._layer_combine(p, lambda lp, u, i: conv_layer(
                lp, 'gat', 'mean', u, i, e['edge_user'], e['edge_item'],
                m_u, m_i, e['edge_weight']))
        jm.representation = hashed
        return jm.loss(p, batch, jax.random.key(0))[0]

    grad_fn = jax.jit(jax.value_and_grad(jax_loss))
    opt = optax.adam(LR)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    want_losses = []
    for (users, pos, negs), (s_u, s_i) in zip(batches, salts):
        batch = tuple(jnp.asarray(a, jnp.int32) for a in (users, pos, negs))
        loss, grads = grad_fn(jp, (*batch, jnp.ones(BATCH, bool)),
                              _mask01(e['edge_user'], e['edge_item'], s_u),
                              _mask01(e['edge_user'], e['edge_item'], s_i))
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        want_losses.append(float(loss))

    model = ConvModel(tcfg, data, device='cpu')
    model.load_params(params_from_jax(params, data.n_users, data.n_items))
    tr = Trainer(tcfg, model, data)
    got_losses = []
    for batch, (s_u, s_i) in zip(batches, salts):
        loss, _ = tr.train_step(
            tuple(torch.from_numpy(a.astype(np.int64)) for a in batch),
            ((s_u, KEEP), (s_i, KEEP)))
        got_losses.append(float(loss))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4, atol=0)
    tree = model.param_tree()
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(tree[name].detach().numpy(),
                                   np.asarray(jp[name]), atol=1e-4, rtol=0,
                                   err_msg=name)
    for got, want in zip(tree['convs'], jp['convs']):
        for k in ('w', 'a_src', 'a_dst', 'b'):
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), atol=1e-4,
                                       rtol=0, err_msg=k)
    assert gat.gat_fwd_cuda.launches == gat.gat_bwd_cuda.launches == 0


# --- TEXTGCN_TPU_PALLAS_XDTYPE=bf16 ------------------------------------------

NU, NI, PAD = 60, 45, 512


def _graph():
    rng = np.random.RandomState(3)
    pairs = np.unique(np.stack([rng.randint(0, NU - 10, 260),
                                rng.randint(0, NI - 7, 260)], 1), axis=0)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)


def _padded(a):
    out = np.zeros((PAD,) + a.shape[1:], np.float32)
    out[:len(a)] = a
    return jnp.asarray(out)


def _ops(monkeypatch, dtype):
    """The port's op under ``XDTYPE_ENV=dtype`` and the JAX package's
    single-split Pallas op with the same ``x_dtype``, over one graph."""
    monkeypatch.setenv(XDTYPE_ENV, dtype)
    eu, ei = _graph()
    ones = np.ones(len(eu), np.float32)
    jop = PallasGraphOp(eu, ei, ones, PAD, PAD, D, interpret=True,
                        x_dtype=jnp.bfloat16 if dtype == 'bf16'
                        else jnp.float32)
    assert len(jop.l_i2u.splits) == 1
    return GraphOp(eu, ei, ones, NU, NI, 'cpu'), jop


def _run(kind, op, jop, ins, cot):
    """``kind``'s to_user output and its gradients in the tables in
    ``ins`` (port, JAX)."""
    from textgcn_tpu.ops.pallas_gat import gat_direction as jax_gat
    from textgcn_tpu.ops.pallas_gat import gatv2_direction as jax_gatv2
    salt, keep = jnp.uint32(SALT), jnp.float32(KEEP)
    if kind == 'spmm':
        def jax_fn(x):
            return jop.to_user(x, (salt, keep))[:NU]

        def port_fn(x):
            return op.to_user(x, (SALT, KEEP))
    elif kind == 'gat':
        h_i, h_u, s_i, s_u, d_u = ins

        def jax_fn(h, s, dd):
            return jax_gat(jop, 'to_user', h, _padded(h_u), s, _padded(s_u),
                           dd, salt, keep, interpret=True)[:NU]

        def port_fn(h, s, dd):
            return gat.gat_direction(op, 'to_user', h, torch.from_numpy(h_u),
                                     s, torch.from_numpy(s_u), dd, SALT,
                                     KEEP)
        ins = (h_i, s_i, d_u)
    else:
        hs_i, hs_u, hd_u, a = ins

        def jax_fn(hs, hd, av):
            return jax_gatv2(jop, 'to_user', hs, _padded(hs_u), hd, av,
                             salt, keep, interpret=True)[:NU]

        def port_fn(hs, hd, av):
            return gat.gatv2_direction(op, 'to_user', hs,
                                       torch.from_numpy(hs_u), hd, av, SALT,
                                       KEEP)
        ins = (hs_i, hd_u, a)
    jins = [_padded(x) if x.ndim == 2 or len(x) != D else jnp.asarray(x)
            for x in ins]
    want, vjp = jax.vjp(jax_fn, *jins)
    want_g = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(x).requires_grad_() for x in ins]
    got = port_fn(*targs)
    got.backward(torch.from_numpy(cot))
    return ((got.detach().numpy(), [t.grad.numpy() for t in targs]),
            (np.asarray(want), [np.asarray(g)[:len(x)]
                                for g, x in zip(want_g, ins)]))


@pytest.mark.parametrize('kind', ['spmm', 'gat', 'gatv2'])
def test_bf16_gathered_tables_match_jax_x_dtype(monkeypatch, kind):
    rng = np.random.RandomState(5)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    if kind == 'spmm':
        ins = (f(NI, D),)
    elif kind == 'gat':
        ins = (f(NI, D), f(NU, D), f(NI), f(NU), f(NU))
    else:
        ins = (f(NI, D), f(NU, D), f(NU, D), 0.5 * f(D))
    cot = f(NU, D)
    results = {}
    for dtype in ('bf16', 'f32'):
        op, jop = _ops(monkeypatch, dtype)
        assert gathered_dtype() == (torch.bfloat16 if dtype == 'bf16'
                                    else torch.float32)
        (got, got_g), (want, want_g) = _run(kind, op, jop, ins, cot)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=dtype)
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                       err_msg=f'{dtype} input {i}')
        results[dtype] = got, got_g
    # the rounding is real: bf16 keeps 8 bits of the gathered tables
    assert not np.allclose(results['bf16'][0], results['f32'][0],
                           rtol=1e-5, atol=1e-6)
    assert spmm_dropout_cuda.launches == gat.gat_fwd_cuda.launches == 0


def test_gathered_dtype_refuses_other_values(monkeypatch):
    monkeypatch.delenv(XDTYPE_ENV, raising=False)
    assert gathered_dtype() == torch.float32
    monkeypatch.setenv(XDTYPE_ENV, 'fp8')
    with pytest.raises(ValueError, match=XDTYPE_ENV):
        gathered_dtype()
