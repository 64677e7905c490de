"""The port's concat scorers (``ltr_reviews``, ``ltr_kg``, ``ltr_simple``)
against the JAX package's, on the CPU, and ``lgcn``'s loss through the
``score_pairwise`` hook.

The models take the same params, batches and dropout salts (the JAX side
through its exact-f32 XLA op with the hash weights), on ``data/dummy``
with its checked-in embedding caches (a copy in ``tmp_path``).

Tolerances: one step's loss 1e-4 and gradients 1e-5 absolute / 1e-4
relative; the catalogue scores 1e-5 and the top-k's values 1e-5 (indices
where the values are apart); the probe's and a served JAX checkpoint's
metrics 1e-6; ``lgcn``'s loss and gradients through the hook bit for bit.
"""

import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ltr import (_base_checkpoint, _batch, _configs,
                            _jax_hash_weights)
from textgcn_tpu.data import text as jax_text
from textgcn_tpu.models import ltr_concat as jax_lc
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data import text
from textgcn_tpu_torch.models import ltr_concat as lc
from textgcn_tpu_torch.models.lightgcn import LightGCN
from textgcn_tpu_torch.models.losses import reg_loss
from textgcn_tpu_torch.weights import params_from_jax

SALT = 0x9E3779B9
KEEP = float(np.float32(1.0 - 0.4))
PAIRS = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))
NAMES = ('ltr_reviews', 'ltr_kg')


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@pytest.fixture(scope='module')
def dummy_copy(tmp_path_factory, dummy_dir):
    out = tmp_path_factory.mktemp('concat') / 'dummy'
    shutil.copytree(dummy_dir, out)
    return str(out)


@pytest.fixture(scope='module')
def ltr_data(dummy_copy):
    jc, tc = _configs(dummy_copy)
    return jax_text.load_ltr_data(jc), text.load_ltr_data(tc)


def _pair(data, dummy_copy, name, seed=0):
    jc, tc = _configs(dummy_copy, model=name)
    jd, td = data
    jm = jax_lc.LTRCosine(jc, jd)
    plain = jm.graph_op.weights
    jm.graph_op.weights = lambda key, dropout: (
        _jax_hash_weights(jm.graph_op, PAIRS) if dropout > 0
        else plain(key, dropout))
    rng = np.random.RandomState(seed)
    params = {'user_emb': (0.3 * rng.randn(td.n_users, tc.emb_size)
                           ).astype(np.float32),
              'item_emb': (0.3 * rng.randn(td.n_items, tc.emb_size)
                           ).astype(np.float32)}
    tm = lc.LTRCosine(tc, td, device='cpu')
    tm.load_params(params_from_jax(params, td.n_users, td.n_items))
    return jm, jax.tree.map(jnp.asarray, params), tm


@pytest.mark.parametrize('name', NAMES)
def test_one_step_scores_in_concat_space_as_jax(ltr_data, dummy_copy, name):
    """Training adds ``text_u . text_i`` to every score, as the JAX
    ``loss`` does through ``score_pairwise``."""
    jm, jp, tm = _pair(ltr_data, dummy_copy, name)
    assert tm.items_text_mode == jm.items_text_mode
    batch = _batch(ltr_data[1], seed=4)
    users, pos, negs = (jnp.asarray(a, jnp.int32) for a in batch)
    (loss, aux), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, (users, pos, negs, jnp.ones(users.shape[0], bool)),
        jax.random.key(0))
    tb = tuple(torch.from_numpy(a.astype(np.int64)) for a in batch)
    t_loss, t_aux = tm.loss(tb, w_pairs=PAIRS)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(loss),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(t_aux['bpr'].detach()),
                               float(aux['bpr']), rtol=1e-4, atol=1e-6)
    for n in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(getattr(tm, n).grad.numpy(),
                                   np.asarray(grads[n]), atol=1e-5,
                                   rtol=1e-4)
    # the text term is in it: the plain dot's loss differs
    tm.score_with_head = False
    plain, _ = tm.loss(tb, w_pairs=PAIRS)
    assert abs(float(plain.detach()) - float(t_loss.detach())) > 1e-3


@pytest.mark.parametrize('name', NAMES)
def test_concat_scores_and_topk_match_jax(ltr_data, dummy_copy, name):
    jm, jp, tm = _pair(ltr_data, dummy_copy, name, seed=1)
    n_users = ltr_data[1].n_users
    users = jnp.arange(n_users, dtype=jnp.int32)
    jreprs = jm.representation(jp, training=False)
    want = np.asarray(jm.score_batchwise(jp, jreprs, users))
    want_v, want_i = (np.asarray(a) for a in jm.topk_for_users(
        jp, jreprs, users, 5))
    tu = torch.arange(n_users)
    with torch.no_grad():
        reprs = tm.scoring_reprs()
        got = tm.score_batchwise(reprs, tu).numpy()
        vals, idx = tm.topk_for_users(reprs, tu, 5)
        u_cat, i_cat, bias = tm.fused_catalog_inputs(reprs, tu)
        pairwise = tm.score_pairwise(reprs[0][tu][:, None, :],
                                     reprs[1][None], tu[:, None],
                                     torch.arange(tm.n_items)[None])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pairwise.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose((u_cat @ i_cat.T + bias).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(vals.numpy(), want_v, atol=1e-5, rtol=0)
    apart = np.array([[np.sum(np.abs(row - x) < 1e-4) == 1 for x in row]
                      for row in want_v]) & np.isfinite(want_v)
    assert apart.mean() > 0.5
    assert (idx.numpy()[apart] == want_i[apart]).all()


def test_probe_concat_scoring_matches_jax(ltr_data, dummy_copy):
    from textgcn_tpu.train.trainer import Trainer as JaxTrainer
    from textgcn_tpu_torch.train.trainer import Trainer
    jc, tc = _configs(dummy_copy, model='ltr_simple')
    jd, td = ltr_data
    jm = jax_lc.LTRSimple(jc, jd)
    jt = JaxTrainer(jc, jm, jd)
    tm = lc.LTRSimple(tc, td, device='cpu')
    params = jax.tree.map(np.asarray, jt.params)
    tm.load_params(params_from_jax(params, td.n_users, td.n_items))
    want = jax_lc.probe_concat_scoring(jc, jd, jt)
    got = lc.probe_concat_scoring(Trainer(tc, tm, td))
    assert list(got) == list(want) == ['reviews', 'kg']
    for mode, metrics in want.items():
        for n, v in metrics.items():
            np.testing.assert_allclose(got[mode][n], v, atol=1e-6, rtol=0,
                                       err_msg=f'{mode} {n}')
    assert tm.items_text_mode == 'reviews'
    with pytest.raises(ValueError, match='nope'):
        tm.set_items_text_mode('nope')


@pytest.mark.parametrize('argv', [
    ['--model', 'ltr_kg', '--load'],
    ['--model', 'ltr_simple', '--load_base'],
], ids=['ltr_kg', 'ltr_simple'])
def test_a_jax_checkpoint_serves_the_same_metrics(tmp_path, monkeypatch,
                                                  dummy_copy, ltr_data,
                                                  argv):
    """Every evaluation of the two CLIs on one JAX-format checkpoint:
    ``ltr_kg --load --no_train``'s, and ``ltr_simple --load_base``'s base
    evaluation with plain scoring and its two probes."""
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu.train.trainer import Trainer as JaxTrainer
    from textgcn_tpu_torch.cli import main as port_main
    from textgcn_tpu_torch.train.trainer import Trainer
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    ck = str(tmp_path / 'ck.pkl')
    _base_checkpoint(ck, ltr_data[1], seed=11)
    argv = argv + [ck, '--data', dummy_copy, '--emb_size', '16', '-k', '3',
                   '5', '--no_train', '--quiet']
    seen = {'jax': [], 'port': []}
    for side, cls in (('jax', JaxTrainer), ('port', Trainer)):
        evaluate = cls.evaluate
        monkeypatch.setattr(cls, 'evaluate', lambda self, epoch=None,
                            _e=evaluate, _s=seen[side]: (
                                _s.append(_e(self, epoch)) or _s[-1]))
    jax_main(argv + ['--uid', 'j'])
    port_main(argv + ['--uid', 'p'])
    assert len(seen['port']) == len(seen['jax']) == (
        3 if 'ltr_simple' in argv else 1)
    for got, want in zip(seen['port'], seen['jax']):
        for n, v in want.items():
            np.testing.assert_allclose(got[n], v, atol=1e-6, rtol=0)


def test_export_reprs_gives_the_concat_factors(tmp_path, monkeypatch,
                                               dummy_copy):
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    tr = port_main(['--model', 'ltr_reviews', '--data', dummy_copy,
                    '--emb_size', '16', '-k', '3', '5', '--epochs', '2',
                    '--batch_size', '16', '--export_reprs', '--quiet',
                    '--uid', 'x'])
    run = os.path.join('runs', 'dummy', 'x')
    u, i, b = (np.load(os.path.join(run, f'ltr_{n}.npy'))
               for n in ('user_factors', 'item_factors', 'bias'))
    assert u.shape[1] == 16 + text.STUB_DIM and float(b) == 0.0
    with torch.no_grad():
        want = tr.model.score_batchwise(tr.model.scoring_reprs(),
                                        torch.arange(tr.model.n_users))
    np.testing.assert_allclose(u @ i.T + b, want.numpy(), atol=1e-5)


@pytest.mark.parametrize('masked', [False, True])
def test_lgcn_loss_through_the_hook_keeps_its_bits(dummy_dir, masked):
    """``lgcn``'s loss and gradients through ``score_pairwise`` equal the
    inline dot product's bit for bit."""
    from textgcn_tpu_torch.data.core import load_interactions
    data = load_interactions(dummy_dir)
    cfg = tconfig.Config(model='lgcn', data=dummy_dir, emb_size=16,
                         k=(3,), save=False).finalize()
    model = LightGCN(cfg, data, device='cpu')
    users, pos, negs = (torch.from_numpy(a.astype(np.int64))
                        for a in _batch(data, seed=3, n_neg=3))
    batch = (users, pos, negs)
    if masked:
        batch += (torch.arange(len(users)) % 4 != 0,)
    loss, _ = model.loss(batch, w_pairs=PAIRS)
    got = torch.autograd.grad(loss, [model.user_emb, model.item_emb])
    ur, ir = model.representation(training=True, w_pairs=PAIRS)
    u = ur[users]
    pos_s = (u * ir[pos]).sum(dim=-1)
    neg_s = (u[:, None, :] * ir[negs]).sum(dim=-1)
    mask = batch[3] if masked else None
    diff = F.selu(neg_s - pos_s[:, None])
    if masked:
        diff = torch.where(mask[:, None], diff, 0.0)
        count = mask.float().sum().clamp(min=1.0)
    else:
        count = float(len(users))
    want = (diff.sum(dim=0) / count).mean() + reg_loss(
        model.user_emb, model.item_emb, users, pos, negs, cfg.reg_lambda,
        mask)
    ref = torch.autograd.grad(want, [model.user_emb, model.item_emb])
    assert torch.equal(loss, want)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
