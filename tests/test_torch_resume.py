"""The port's ``--resume``, on the CPU.

* A run stopped after epoch N and resumed with ``--resume`` equals the
  run that was not stopped bit for bit (loss sums, metrics, tables and
  Adam state), in one process and on a W = 2 gloo mesh (ranks started
  with ``torch.multiprocessing``, ``tests/helpers/torch_resume_worker.py``);
  ``resume`` refuses what the JAX package refuses.

The SIGTERM stop and ``--refresh_every`` are ``tests/test_torch_refresh.py``'s.
Every test trains on one torch thread.
"""


import logging
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.cli import main as port_main
from textgcn_tpu_torch.train.checkpoint import make_checkpointer
from textgcn_tpu_torch.train.trainer import RESUME_CONFIG_FIELDS, Trainer

HELPERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'helpers')
SALT = 0x9E3779B9                      # high bit set
KEEP = float(np.float32(1.0 - 0.4))
PAIRS = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))
D = 16
EPOCHS = 4
SPAWN_TIMEOUT = 240


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


def _run_dir(uid):
    return os.path.join('runs', 'dummy', uid)


def _assert_same_state(a: Trainer, b: Trainer):
    """Bit-equal parameters, Adam state and generators."""
    for (name, p), (_, q) in zip(a.model.named_parameters(),
                                 b.model.named_parameters()):
        assert torch.equal(p, q), name
    for p, q in zip(a.optimizer.param_groups[0]['params'],
                    b.optimizer.param_groups[0]['params']):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.salt_generator.get_state(),
                       b.salt_generator.get_state())


# --- resume in one process ----------------------------------------------------

RESUME_CASES = {
    'lgcn': ['--model', 'lgcn'],
    'lgcn_refresh': ['--model', 'lgcn', '--refresh_every', '2'],
    'gat': ['--model', 'gat', '--aggr', 'mean', '--n_layers', '2'],
    'ltr_pop_frozen': ['--model', 'ltr_pop', '--freeze', '--ltr_layers',
                       '3'],
}


@pytest.mark.parametrize('case', sorted(RESUME_CASES))
def test_resume_continues_bit_for_bit(cli, case):
    flags = RESUME_CASES[case]
    full = cli(flags + ['--epochs', str(EPOCHS), '--uid', 'full'])
    half = cli(flags + ['--epochs', str(EPOCHS // 2), '--uid', 'half'])
    state = make_checkpointer().load_resume(_run_dir('half'))
    assert int(state['epoch']) == EPOCHS // 2
    assert set(state['config']) == set(RESUME_CONFIG_FIELDS)
    assert half.loss_history == full.loss_history[:EPOCHS // 2]
    resumed = cli(flags + ['--epochs', str(EPOCHS), '--uid', 'resumed',
                           '--resume', _run_dir('half')])
    assert resumed.loss_history == full.loss_history[EPOCHS // 2:]
    for name, rows in full.metrics_logger.items():
        np.testing.assert_array_equal(resumed.metrics_logger[name], rows)
    _assert_same_state(full, resumed)
    # best.pkl: the resumed run's, else the half run's (the best epoch
    # came before the stop)
    best = os.path.join(_run_dir('resumed'), 'best.pkl')
    if not os.path.exists(best):
        best = os.path.join(_run_dir('half'), 'best.pkl')
    with open(best, 'rb') as f:
        best = pickle.load(f)
    with open(os.path.join(_run_dir('full'), 'best.pkl'), 'rb') as f:
        want = pickle.load(f)
    assert best['epoch'] == want['epoch']
    np.testing.assert_array_equal(best['params']['user_emb'],
                                  want['params']['user_emb'])


def test_the_jax_tools_read_a_port_resume_state(cli):
    """``tools/conv_quality_sweep.best_metrics`` reads the port's
    ``resume_state.pkl`` (its ``metrics``) as it reads the JAX package's."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(HELPERS)))
    from tools.conv_quality_sweep import best_metrics
    tr = cli(['--model', 'lgcn', '--epochs', '4', '--uid', 'sweep'])
    got = best_metrics(_run_dir('sweep'))     # names k = 3 '@20'

    assert got['n_evals'] == 2
    assert got['recall@20'] == tr.metrics_logger['recall'][:, 0].max()


def _refusal_setups(cli):
    """Each refusal: a function that makes the run and returns the argv of
    the resume that must raise, and what it raises."""
    lgcn = ['--model', 'lgcn', '--epochs', '2']

    def stamps():
        cli(lgcn + ['--uid', 'a'])
        path = os.path.join(_run_dir('a'), 'resume_state.pkl')
        with open(path, 'rb') as f:
            state = pickle.load(f)
        state['epoch'] = np.int64(1)
        with open(path, 'wb') as f:
            pickle.dump(state, f)
        return lgcn + ['--resume', _run_dir('a')]

    def config():
        cli(lgcn + ['--uid', 'a'])
        return lgcn + ['--resume', _run_dir('a'), '--lr', '0.5']

    def optimizer_shape():
        ltr = ['--model', 'ltr_linear', '--epochs', '2']
        cli(ltr + ['--ltr_layers', '3', '--uid', 'a'])
        return ltr + ['--ltr_layers', '4', '--resume', _run_dir('a')]

    def no_state():
        cli(lgcn + ['--uid', 'a', '--no_resume_state'])
        return lgcn + ['--resume', _run_dir('a')]

    def not_a_dir():
        cli(lgcn + ['--uid', 'a'])
        return lgcn + ['--resume', os.path.join(_run_dir('a'), 'best.pkl')]

    return {
        'epoch_stamps': (stamps, ValueError, 'does not match'),
        'config_field': (config, ValueError, 'differing: lr'),
        'optimizer_shape': (optimizer_shape, ValueError, 'optimizer exp_avg'),
        'no_resume_state': (no_state, FileNotFoundError, 'resume_state'),
        'not_a_run_dir': (not_a_dir, ValueError, 'run directory'),
    }


@pytest.mark.parametrize('refusal', ['epoch_stamps', 'config_field',
                                     'optimizer_shape', 'no_resume_state',
                                     'not_a_run_dir'])
def test_resume_refuses_what_jax_refuses(cli, refusal):
    setup, err, match = _refusal_setups(cli)[refusal]
    argv = setup()
    with pytest.raises(err, match=match):
        cli(argv + ['--uid', 'b'])


def test_resume_excludes_load():
    with pytest.raises(ValueError, match='excludes'):
        tconfig.parse_args(['--model', 'lgcn', '--resume', 'a', '--load',
                            'b'])


# --- resume on a W = 2 mesh --------------------------------------------------

@pytest.fixture(scope='module')
def mesh_ranks(tmp_path_factory, dummy_dir):
    sys.path.insert(0, HELPERS)
    import torch_resume_worker
    work = tmp_path_factory.mktemp('resume_mesh')
    inp = {'epochs': EPOCHS,
           'argv': ['--model', 'lgcn', '--data', dummy_dir,
                    '--evaluate_every', '2', '--batch_size', '16',
                    '--emb_size', str(D), '-k', '3', '5', '--quiet']}
    with open(work / 'inputs.pkl', 'wb') as f:
        pickle.dump(inp, f)
    ctx = mp.start_processes(torch_resume_worker.run, args=(2, str(work)),
                             nprocs=2, join=False, start_method='spawn')
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError('resume ranks still running after '
                                   f'{SPAWN_TIMEOUT} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    out = []
    for r in range(2):
        with open(work / f'rank{r}.pkl', 'rb') as f:
            out.append(pickle.load(f))
    return out


def test_resume_on_a_w2_mesh_continues_bit_for_bit(mesh_ranks):
    for got in mesh_ranks:
        full, half, resumed = got['full'], got['half'], got['resumed']
        assert len(full['loss_history']) == EPOCHS
        assert half['loss_history'] == full['loss_history'][:EPOCHS // 2]
        assert resumed['loss_history'] == full['loss_history'][EPOCHS // 2:]
        for name, rows in full['metrics_logger'].items():
            np.testing.assert_array_equal(resumed['metrics_logger'][name],
                                          rows)
        for name in ('user_emb', 'item_emb'):
            np.testing.assert_array_equal(resumed['params'][name],
                                          full['params'][name])


def test_mesh_ranks_agree_and_differ_from_the_half_run(mesh_ranks):
    a, b = mesh_ranks
    assert a['full']['loss_history'] == b['full']['loss_history']
    np.testing.assert_array_equal(a['resumed']['params']['user_emb'],
                                  b['resumed']['params']['user_emb'])
    assert not np.array_equal(a['half']['params']['user_emb'],
                              a['full']['params']['user_emb'])
