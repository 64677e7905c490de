"""Serving mode (``--approx_topk``) and the mining recall target
(``TEXTGCN_TPU_ADV_TOPK``) of the port against the JAX package, on the
CPU.

In serving mode the JAX package emits bfloat16 catalogue scores and
selects with ``lax.approx_max_k``, which on the CPU returns the exact
top-k values (its ties in no fixed order).  The port rounds its float32
product to bfloat16 and takes the exact top-k, ties to the lower index.

* ``score_and_topk``, the concat scorers and ``lgcn``'s evaluation and
  ``--predict`` on ``data/dummy`` through both CLIs: the port's values are
  its float32 scores rounded to bfloat16, bit for bit, and equal the JAX
  package's bit for bit (the check allows one bfloat16 ulp, where JAX's
  CPU product could round otherwise; none did); indices are equal
  wherever the values are distinct; the metrics are equal where no tie
  crosses the k-th place.
* ``--mesh`` at W = 2 and 4 on gloo (``sharded_topk`` with ``approx``, and
  the CLI's ``lgcn`` and ``ltr_kg`` serve): the one-process port's result
  bit for bit, ties included.
* ``TEXTGCN_TPU_ADV_TOPK=0.95``: one ``adv_sampling`` step mines the hard
  negatives of the unset run (and of the JAX package's step under the
  same target).
* ``--approx_topk 1.0`` and ``-0.1`` are refused, as in the JAX package.
"""

import ast
import csv
import logging
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_adv import (PAIRS, PAIRS_2, _draws, _jax_loss_given,
                            _models, _t, synthetic_dir)  # noqa: F401
from test_torch_concat import NAMES, _pair, dummy_copy, ltr_data  # noqa: F401
from test_torch_ltr import _base_checkpoint
from test_torch_mesh_conv import HELPERS, SPAWN_TIMEOUT, _join
from textgcn_tpu.ops.retrieval import score_and_topk as jax_score_and_topk
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.ops import retrieval

RECALL = 0.95
KS = ('-k', '3', '5')


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@pytest.fixture()
def serving_env(monkeypatch):
    """``TEXTGCN_TPU_APPROX_TOPK=0.95``; JAX reads it when it traces, so
    its caches are cleared before and after."""
    jax.clear_caches()
    monkeypatch.setenv(retrieval.APPROX_TOPK_ENV, str(RECALL))
    yield
    monkeypatch.delenv(retrieval.APPROX_TOPK_ENV)
    jax.clear_caches()


def _bf16_keys(x) -> np.ndarray:
    """Integers in the order of bfloat16-representable float32 values,
    one apart per bfloat16 ulp (-0 and +0 one apart too)."""
    bits = np.asarray(x, np.float32).view(np.int32) >> 16
    return np.where(bits < 0, -(bits & 0x7FFF) - 1, bits).astype(np.int64)


def _is_bf16(x) -> bool:
    x = np.asarray(x, np.float32)
    return (x.view(np.int32) & 0xFFFF == 0).all()


def _assert_serving_topk(got_v, got_i, want_v, want_i, rows):
    """Values within one bfloat16 ulp (-inf equal), returns the share
    that is bit-equal; indices equal wherever the value occurs once in
    its row of ``rows``, the whole masked bfloat16 score matrix."""
    gv, wv = np.asarray(got_v, np.float32), np.asarray(want_v, np.float32)
    rows = np.asarray(rows, np.float32)
    assert gv.shape == wv.shape and _is_bf16(gv) and _is_bf16(wv)
    inf = np.isneginf(gv) & np.isneginf(wv)
    fin = np.isfinite(gv) & np.isfinite(wv)
    assert (inf | fin).all()
    assert (np.abs(_bf16_keys(gv) - _bf16_keys(wv))[fin] <= 1).all()
    checked = 0
    for r, row in enumerate(wv):
        for j, x in enumerate(row):
            if np.isfinite(x) and (rows[r] == x).sum() == 1 \
                    and gv[r, j] == x:
                assert got_i[r, j] == want_i[r, j], (r, j)
                checked += 1
    assert checked > 0
    return float((gv.view(np.int32) == wv.view(np.int32)).mean())


def _tables(seed, n_users=64, n_items=500, d=8, ties=False):
    rng = np.random.RandomState(seed)
    if ties:
        ue = rng.randint(-4, 5, (n_users, d)).astype(np.float32) * 0.25
        ie = rng.randint(-4, 5, (n_items, d)).astype(np.float32) * 0.25
    else:
        ue = rng.randn(n_users, d).astype(np.float32)
        ie = rng.randn(n_items, d).astype(np.float32)
    pos = rng.randint(0, n_items + 40, (n_users, 12)).astype(np.int32)
    return ue, ie, pos


# --- score_and_topk ----------------------------------------------------------

@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('k', [1, 5, 40])
def test_score_and_topk_matches_jax_in_serving_mode(ties, k, monkeypatch):
    ue, ie, pos = _tables(k + 100 * ties, ties=ties)
    n = ie.shape[0]
    want_v, want_i = jax_score_and_topk(
        jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(pos), k=k, n_items=n,
        approx=RECALL)
    tu, ti, tp = (torch.from_numpy(a) for a in (ue, ie, pos))
    got_v, got_i = retrieval.score_and_topk(tu, ti, tp, k=k, n_items=n,
                                            approx=RECALL)
    assert got_v.dtype == torch.float32
    # the float32 product rounded to bfloat16, masked, ties to the lower
    # index
    ref = retrieval.mask_train_items(
        torch.matmul(tu, ti.T).to(torch.bfloat16), tp, n)
    ref_v, ref_i = retrieval.top_k_lower_index(ref, k)
    assert torch.equal(got_v, ref_v.float()) and torch.equal(got_i, ref_i)
    share = _assert_serving_topk(got_v.numpy(), got_i.numpy(),
                                 np.asarray(want_v), np.asarray(want_i),
                                 ref.float().numpy())
    assert share == 1.0
    # the environment's target is the same mode; off is float32 as before
    monkeypatch.setenv(retrieval.APPROX_TOPK_ENV, '0.95')
    env_v, env_i = retrieval.score_and_topk(tu, ti, tp, k=k, n_items=n)
    assert torch.equal(env_v, got_v) and torch.equal(env_i, got_i)
    exact = torch.topk(retrieval.mask_train_items(torch.matmul(tu, ti.T),
                                                  tp, n), k, dim=1).values
    for off in ('0', '1.0', 'nope'):
        monkeypatch.setenv(retrieval.APPROX_TOPK_ENV, off)
        exact_v, _ = retrieval.score_and_topk(tu, ti, tp, k=k, n_items=n)
        assert torch.equal(exact_v, exact)


def test_env_recall_parses_as_jax(monkeypatch):
    from textgcn_tpu.ops.retrieval import env_recall as jax_env_recall
    for env in ('', '0', '0.95', '0.5', '1', 'x', ' 0.9 '):
        monkeypatch.setenv(retrieval.APPROX_TOPK_ENV, env)
        assert retrieval.env_recall() == jax_env_recall()
        assert retrieval.serving_mode(None) == (0 < jax_env_recall() < 1)


# --- the concat scorers ------------------------------------------------------

@pytest.mark.parametrize('name', NAMES)
def test_concat_scorers_serve_as_jax(ltr_data, dummy_copy, name,
                                     serving_env):
    jm, jp, tm = _pair(ltr_data, dummy_copy, name, seed=1)
    n_users = ltr_data[1].n_users
    users = jnp.arange(n_users, dtype=jnp.int32)
    want_v, want_i = (np.asarray(a) for a in jm.topk_for_users(
        jp, jm.representation(jp, training=False), users, 5))
    tu = torch.arange(n_users)
    with torch.no_grad():
        reprs = tm.scoring_reprs()
        vals, idx = tm.topk_for_users(reprs, tu, 5)
        u_cat, i_cat, _ = tm.fused_catalog_inputs(reprs, tu)
        ref = retrieval.mask_train_items(
            torch.matmul(u_cat, i_cat.T).to(torch.bfloat16),
            tm.pos_padded[tu], tm.n_items)
    ref_v, ref_i = retrieval.top_k_lower_index(ref, 5)
    assert torch.equal(vals, ref_v.float()) and torch.equal(idx, ref_i)
    assert _assert_serving_topk(vals.numpy(), idx.numpy(), want_v,
                                want_i, ref.float().numpy()) == 1.0


# --- lgcn through both CLIs --------------------------------------------------

def _read_predictions(path):
    with open(path, newline='') as f:
        rows = list(csv.reader(f, delimiter='\t'))[1:]
    return ([r[0] for r in rows], [ast.literal_eval(r[1]) for r in rows],
            np.array([[float(s) for s in r[2][1:-1].split(',')]
                      for r in rows], np.float32))


def _no_tie_crosses(vals, ks) -> bool:
    """No value at the k-th place equals the one after it."""
    return all((vals[:, k - 1] != vals[:, k]).all() for k in ks
               if k < vals.shape[1])


def test_lgcn_serves_as_jax_through_both_clis(tmp_path, monkeypatch,
                                              dummy_copy, serving_env):
    from textgcn_tpu.cli import main as jax_main
    from textgcn_tpu.train.trainer import Trainer as JaxTrainer
    from textgcn_tpu_torch.cli import main as port_main
    from textgcn_tpu_torch.train.trainer import Trainer
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    monkeypatch.delenv(retrieval.APPROX_TOPK_ENV)   # the flag sets it
    ck = str(tmp_path / 'ck.pkl')
    _base_checkpoint(ck, load_interactions(dummy_copy), seed=5)
    argv = ['--model', 'lgcn', '--data', dummy_copy, '--emb_size', '16',
            *KS, '--batch_size', '16', '--no_train', '--load', ck,
            '--predict', '--quiet', '--approx_topk', str(RECALL)]
    seen = {'jax': [], 'port': []}
    for side, cls in (('jax', JaxTrainer), ('port', Trainer)):
        evaluate = cls.evaluate
        monkeypatch.setattr(cls, 'evaluate', lambda self, epoch=None,
                            _e=evaluate, _s=seen[side]: (
                                _s.append(_e(self, epoch)) or _s[-1]))
    port = port_main(argv + ['--uid', 'p'])
    assert retrieval.APPROX_TOPK_ENV not in os.environ   # restored
    jax_main(argv + ['--uid', 'j'])
    pu, pi, pv = _read_predictions(os.path.join('runs', 'dummy', 'p',
                                                'predictions.tsv'))
    ju, ji, jv = _read_predictions(os.path.join('runs', 'dummy', 'j',
                                                'predictions.tsv'))
    assert pu == ju
    index = {ext: i for i, ext in port.data.item_id_map.items()}
    p_idx = np.array([[index[e] for e in row] for row in pi])
    j_idx = np.array([[index[e] for e in row] for row in ji])
    # the file rounds to 4 decimals: values equal there; bf16 checked on
    # the served values themselves
    np.testing.assert_array_equal(pv, jv)
    users = np.arange(port.data.n_users)
    idx, vals = port._predict_users(users)
    assert _is_bf16(vals) and (idx == p_idx).all()
    with torch.no_grad():
        tu = torch.from_numpy(users)
        rows = retrieval.mask_train_items(
            port.model.score_batchwise(port.model.scoring_reprs(), tu).to(
                torch.bfloat16), port.model.pos_padded[tu],
            port.data.n_items).float().numpy()
    for r, row in enumerate(jv):
        for j, x in enumerate(row):
            if np.isfinite(x) and (np.round(rows[r], 4) == x).sum() == 1:
                assert p_idx[r, j] == j_idx[r, j], (r, j)
    test_idx, test_vals = port._predict_users(port.data.test_users)
    assert _no_tie_crosses(test_vals, (3, 5))
    assert len(seen['port']) == len(seen['jax']) == 1
    for name, v in seen['jax'][0].items():
        np.testing.assert_allclose(seen['port'][0][name], v, atol=1e-6,
                                   rtol=0, err_msg=name)


# --- the mesh ----------------------------------------------------------------

MESH_CLI = {'lgcn': ['--model', 'lgcn'], 'ltr_kg': ['--model', 'ltr_kg']}


def _cli_argv(dummy, ck, model):
    return [*MESH_CLI[model], '--load', ck, '--data', dummy, '--emb_size',
            '16', *KS, '--batch_size', '16', '--no_train', '--predict',
            '--quiet', '--approx_topk', str(RECALL)]


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, dummy_copy):
    sys.path.insert(0, HELPERS)
    import torch_mesh_conv_worker
    ck = str(tmp_path_factory.mktemp('approx_ck') / 'ck.pkl')
    _base_checkpoint(ck, load_interactions(dummy_copy), seed=6)
    ue, ie, pos = _tables(7, n_users=24, n_items=61, ties=True)
    padded = np.zeros((64, ie.shape[1]), np.float32)
    padded[:61] = ie
    inp = {'kind': 'approx', 'ks': (1, 7, 20),
           'tables': {'users': ue, 'items': padded, 'pos': pos,
                      'n_valid': 61},
           'cli_runs': [(model, _cli_argv(dummy_copy, ck, model),
                         {2: '1x2', 4: '2x2'}) for model in MESH_CLI]}
    dirs = {w: tmp_path_factory.mktemp(f'approx{w}') for w in (2, 4)}
    for d in dirs.values():
        with open(d / 'inputs.pkl', 'wb') as f:
            pickle.dump(inp, f)
    contexts = [mp.start_processes(torch_mesh_conv_worker.run,
                                   args=(w, str(d)), nprocs=w, join=False,
                                   start_method='spawn')
                for w, d in dirs.items()]
    single = tmp_path_factory.mktemp('approx_single')
    old_cwd, old_env = os.getcwd(), os.environ.get('TEXTGCN_TPU_PLATFORM')
    try:
        os.chdir(single)
        os.environ['TEXTGCN_TPU_PLATFORM'] = 'cpu'
        from textgcn_tpu_torch.cli import main as port_main
        one = {m: port_main(argv + ['--uid', m]).metrics_logger
               for m, argv, _ in inp['cli_runs']}
    finally:
        os.chdir(old_cwd)
        if old_env is None:
            os.environ.pop('TEXTGCN_TPU_PLATFORM', None)
        else:
            os.environ['TEXTGCN_TPU_PLATFORM'] = old_env
        _join(contexts, SPAWN_TIMEOUT)
    out = {'inputs': inp, 'dirs': dirs, 'single': single, 'one': one}
    for w, d in dirs.items():
        out[w] = []
        for r in range(w):
            with open(d / f'rank{r}.pkl', 'rb') as f:
                out[w].append(pickle.load(f))
    return out


@pytest.mark.parametrize('world', [2, 4])
def test_sharded_topk_serves_the_one_card_result(ranks, world):
    t = ranks['inputs']['tables']
    args = (torch.from_numpy(t['users']), torch.from_numpy(t['items']),
            torch.from_numpy(t['pos']))
    for k in ranks['inputs']['ks']:
        want_v, want_i = retrieval.score_and_topk(
            *args, k=k, n_items=t['n_valid'], approx=RECALL)
        for got in ranks[world]:
            v, i = got['approx'][k]
            np.testing.assert_array_equal(v, want_v.numpy())
            np.testing.assert_array_equal(i, want_i.numpy())


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('model', list(MESH_CLI))
def test_the_mesh_cli_serves_the_one_process_result(ranks, world, model):
    for got in ranks[world]:
        mine = got['cli'][model]['metrics_logger']
        for name, v in ranks['one'][model].items():
            np.testing.assert_array_equal(mine[name], v)
    rel = os.path.join('runs', 'dummy', model, 'predictions.tsv')
    with open(os.path.join(ranks['single'], rel), 'rb') as f:
        want = f.read()
    with open(os.path.join(ranks['dirs'][world], 'cwd0', rel), 'rb') as f:
        assert f.read() == want


# --- mining ------------------------------------------------------------------

def test_a_recall_target_mines_the_exact_hard_negatives(synthetic_dir,
                                                        monkeypatch):
    """One ``adv_sampling`` step on a keep-0.6 candidate mask (bf16 scores
    with ties, 10 of 50 items mined): the same hard negatives, loss and
    gradients under ``TEXTGCN_TPU_ADV_TOPK=0.95`` as unset, and the JAX
    package's hard negatives under the same target."""
    runs = {}
    for env in ('', '0.95'):
        monkeypatch.setenv(retrieval.ADV_TOPK_ENV, env)
        jm, jp, tm = _models(synthetic_dir, (5, 10))
        users, keep, ridx = _draws(np.random.RandomState(4), tm.n_users,
                                   tm.n_items, 0.6)
        with torch.no_grad():
            ur, ir = tm.representation(training=True, w_pairs=PAIRS)
            negs, valid = tm.hard_negatives(ur, ir, _t(users),
                                            _t(keep, torch.bool))
        loss, _ = tm.loss_given(_t(users), _t(keep, torch.bool), _t(ridx),
                                PAIRS, PAIRS_2)
        loss.backward()
        runs[env] = (negs, valid, loss.detach(), tm.user_emb.grad.clone())
    for a, b in zip(runs[''], runs['0.95']):
        assert torch.equal(a, b)
    _, _, _, (jnegs, jvalid) = _jax_loss_given(jm, jp, users, keep, ridx,
                                               PAIRS, PAIRS_2)
    negs, valid = runs['0.95'][:2]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(negs.numpy()[valid.numpy()],
                                  np.asarray(jnegs)[np.asarray(jvalid)])


def test_adv_sampling_trains_under_a_recall_target(tmp_path, monkeypatch,
                                                   dummy_copy):
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    argv = ['--model', 'adv_sampling', '--data', dummy_copy, '--epochs',
            '2', '--evaluate_every', '1', '--batch_size', '16',
            '--emb_size', '16', *KS, '--quiet', '--no_save']
    runs = {}
    for env in ('exact', '0.95'):
        monkeypatch.setenv(retrieval.ADV_TOPK_ENV, env)
        runs[env] = port_main(argv + ['--uid', env]).loss_history
    assert runs['exact'] == runs['0.95']


# --- refusals ----------------------------------------------------------------

@pytest.mark.parametrize('value', ['1.0', '-0.1', '1.5'])
def test_a_target_outside_zero_one_is_refused_as_in_jax(value):
    from textgcn_tpu.config import parse_args as jax_parse
    argv = ['--model', 'lgcn', '--approx_topk', value]
    with pytest.raises(ValueError, match=r'\[0, 1\)'):
        tconfig.parse_args(argv)
    with pytest.raises(AssertionError, match=r'\[0, 1\)'):
        jax_parse(argv)
