"""``--ckpt_backend orbax`` as ``torch.distributed.checkpoint`` (DCP), on
the CPU: ``train.checkpoint.DistCheckpointer`` against the pickle backend,
the JAX package's Orbax contract and other numbers of ranks.

Ranks are gloo processes (``tests/helpers/torch_resume_worker.py``),
started once for the module: W = 2 trains ``lgcn --mesh 1x2`` on
``data/dummy`` for 4 epochs, for 2, and resumes the 2 to 4, with each
backend; W = 4 waits for W = 2's orbax runs, then resumes the W = 2 half
run and serves the W = 2 full run.  The one-process runs are made here
while the ranks run.

* At W = 2 the orbax resume is the pickle backend's bit for bit (loss
  sums, metrics, tables), and both are the uninterrupted run's.
* Every rank writes its own rows: the tables' DCP chunks are the ranks'.
* A W = 2 checkpoint resumes and serves at W = 4 and in one process (loss
  sums 1e-5 relative, metrics 1e-6, tables 1e-5: sums in another order).
* In one process, without a process group, the orbax resume is the
  pickle resume bit for bit.
* A JAX ``.orbax`` directory (the JAX package's ``OrbaxCheckpointer``) is
  read by the port's Orbax reader, bit for bit, and served; a ``.orbax``
  directory that is neither DCP nor Orbax is refused; a run directory
  without ``best.orbax`` loads ``best.pkl``.
* A tree round-trips (numpy and torch arrays, scalars, strings, empty
  arrays); a failed save leaves the previous checkpoint in place; the
  boosted heads keep ``forest.npz`` beside the ``.orbax`` directories.
"""

import logging
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_mesh_conv import HELPERS, _join
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.cli import main as port_main
from textgcn_tpu_torch.train import checkpoint as tck

D = 16
EPOCHS = 4
SPAWN_TIMEOUT = 480
ORBAX_DIRS = ('latest_checkpoint.orbax', 'best.orbax', 'resume_state.orbax')


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def _argv(data):
    return ['--model', 'lgcn', '--data', data, '--evaluate_every', '2',
            '--batch_size', '16', '--emb_size', str(D), '-k', '3', '5',
            '--quiet']


def _one_process(root, data):
    """Without a process group: 4 epochs, 2, and the 2 resumed, with each
    backend."""
    out = {}
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.chdir(root)
        mpatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
        for backend in ('orbax', 'pickle'):
            argv = [*_argv(data), '--ckpt_backend', backend]
            for uid, extra in (
                    ('full', ['--epochs', str(EPOCHS)]),
                    ('half', ['--epochs', str(EPOCHS // 2)]),
                    ('resumed', ['--epochs', str(EPOCHS), '--resume',
                                 os.path.join('runs', 'dummy',
                                              f'half-{backend}')])):
                trainer = port_main([*argv, *extra, '--uid',
                                     f'{uid}-{backend}'])
                out[uid, backend] = trainer
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory, dummy_dir):
    sys.path.insert(0, HELPERS)
    import torch_resume_worker
    data = str(tmp_path_factory.mktemp('dcp_data') / 'dummy')
    shutil.copytree(dummy_dir, data)
    w2, w4, one = (tmp_path_factory.mktemp(n) for n in ('dcp2', 'dcp4',
                                                         'dcp1'))
    inputs = {
        w2: {'epochs': EPOCHS, 'argv': _argv(data),
             'backends': ('orbax', 'pickle')},
        w4: {'epochs': EPOCHS, 'argv': _argv(data), 'timeout': SPAWN_TIMEOUT,
             'wait_for': str(w2 / 'done-orbax'),
             'resume_from': str(w2 / 'runs' / 'dummy' / 'half-orbax'),
             'load_from': str(w2 / 'runs' / 'dummy' / 'full-orbax')}}
    for d, inp in inputs.items():
        with open(d / 'inputs.pkl', 'wb') as f:
            pickle.dump(inp, f)
    contexts = [mp.start_processes(torch_resume_worker.run,
                                   args=(w, str(d)), nprocs=w, join=False,
                                   start_method='spawn')
                for w, d in ((2, w2), (4, w4))]
    try:
        single = _one_process(one, data)
    finally:
        _join(contexts, SPAWN_TIMEOUT)
    out = {'data': data, 'dirs': {2: w2, 4: w4, 1: one}, 'single': single}
    for w, d in ((2, w2), (4, w4)):
        out[w] = []
        for r in range(w):
            with open(d / f'rank{r}.pkl', 'rb') as f:
                out[w].append(pickle.load(f))
    return out


def _assert_same_run(got, want):
    assert got['loss_history'] == want['loss_history']
    for name, rows in want['metrics_logger'].items():
        np.testing.assert_array_equal(got['metrics_logger'][name], rows)
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_array_equal(got['params'][name],
                                      want['params'][name])


def _assert_close_run(got_losses, got_params, want, metrics=None):
    np.testing.assert_allclose([h['loss'] for h in got_losses],
                               [h['loss'] for h in want['loss_history']],
                               rtol=1e-5, atol=0)
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_allclose(got_params[name], want['params'][name],
                                   atol=1e-5, rtol=0)
    for name, v in (metrics or {}).items():
        np.testing.assert_allclose(v, want['metrics_logger'][name][-1],
                                   atol=1e-6, rtol=0)


def test_w2_orbax_resume_is_the_pickle_resume_bit_for_bit(runs):
    for got in runs[2]:
        _assert_same_run(got['resumed-orbax'], got['resumed-pickle'])
        full = got['full-orbax']
        _assert_same_run(got['full-pickle'], full)
        assert got['resumed-orbax']['loss_history'] == \
            full['loss_history'][EPOCHS // 2:]
        for name in ('user_emb', 'item_emb'):
            np.testing.assert_array_equal(got['resumed-orbax']['params'][name],
                                          full['params'][name])


def test_orbax_runs_write_the_jax_backends_names(runs):
    run = runs['dirs'][2] / 'runs' / 'dummy' / 'full-orbax'
    files = set(os.listdir(run))
    assert set(ORBAX_DIRS) <= files
    assert not any(f.endswith('.pkl') or f.endswith('.tmp') for f in files)
    for name in ORBAX_DIRS:
        assert (run / name / '.metadata').exists()
    assert tck.DistCheckpointer.cooperative
    assert not tck.PickleCheckpointer.cooperative


def test_every_rank_writes_its_own_rows(runs):
    """The tables and their Adam moments are saved as two chunks of rows,
    one a rank, in two files; what the ranks hold whole, once."""
    import torch.distributed.checkpoint as dcp
    run = runs['dirs'][2] / 'runs' / 'dummy' / 'full-orbax'
    n_users = runs['single']['full', 'orbax'].model.n_users
    padded = -(-n_users // 2) * 2
    for name in ('latest_checkpoint.orbax', 'resume_state.orbax'):
        meta = dcp.FileSystemReader(str(run / name)).read_metadata()
        sharded = [m for m in meta.state_dict_metadata.values()
                   if hasattr(m, 'chunks') and len(m.chunks) == 2]
        assert sharded, name
        for m in sharded:
            offsets = sorted(tuple(c.offsets) for c in m.chunks)
            assert offsets[0][0] == 0 and offsets[1][0] == m.size[0] // 2
        assert any(m.size[0] == padded for m in sharded)
        files = {os.path.basename(f) for f in os.listdir(run / name)}
        assert {'__0_0.distcp', '__1_0.distcp'} <= files


def test_w4_resumes_and_serves_a_w2_checkpoint(runs):
    full = runs[2][0]['full-orbax']
    for got in runs[4]:
        resumed = got['resumed']
        _assert_close_run(full['loss_history'][:EPOCHS // 2]
                          + resumed['loss_history'], resumed['params'], full,
                          resumed['last_metrics'])
        best = runs[2][0]['full-orbax']['metrics_logger']
        row = int(np.flatnonzero(best['recall'][:, 0]
                                 == best['recall'][:, 0].max())[-1])
        for name, v in got['loaded']['last_metrics'].items():
            np.testing.assert_allclose(v, best[name][row], atol=1e-6, rtol=0)


def test_one_process_resumes_and_serves_a_w2_checkpoint(runs, monkeypatch):
    w2 = runs['dirs'][2] / 'runs' / 'dummy'
    full = runs[2][0]['full-orbax']
    monkeypatch.chdir(runs['dirs'][1])
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    argv = [*_argv(runs['data']), '--ckpt_backend', 'orbax']
    resumed = port_main([*argv, '--epochs', str(EPOCHS), '--resume',
                         str(w2 / 'half-orbax'), '--uid', 'from-w2'])
    params = {n: getattr(resumed.model, n).detach().numpy()
              for n in ('user_emb', 'item_emb')}
    _assert_close_run(full['loss_history'][:EPOCHS // 2]
                      + resumed.loss_history, params, full,
                      resumed.last_metrics)
    served = port_main([*argv, '--load', str(w2 / 'full-orbax' / 'best.orbax'),
                        '--no_train', '--uid', 'served-w2'])
    rows = full['metrics_logger']
    row = int(np.flatnonzero(rows['recall'][:, 0]
                             == rows['recall'][:, 0].max())[-1])
    for name, v in served.last_metrics.items():
        np.testing.assert_allclose(v, rows[name][row], atol=1e-6, rtol=0)


def test_one_process_orbax_resume_is_the_pickle_resume(runs):
    single = runs['single']
    for backend in ('orbax', 'pickle'):
        full, resumed = single['full', backend], single['resumed', backend]
        assert resumed.loss_history == full.loss_history[EPOCHS // 2:]
    a, b = single['resumed', 'orbax'], single['resumed', 'pickle']
    for name in ('user_emb', 'item_emb'):
        assert torch.equal(getattr(a.model, name), getattr(b.model, name))
    for name, rows in b.metrics_logger.items():
        np.testing.assert_array_equal(a.metrics_logger[name], rows)
    for pa, pb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for key in ('exp_avg', 'exp_avg_sq', 'step'):
            assert torch.equal(pa[key], pb[key])


def test_a_jax_orbax_directory_is_read(runs, tmp_path, monkeypatch):
    from textgcn_tpu.train.checkpoint import OrbaxCheckpointer
    rng = np.random.RandomState(2)
    model = runs['single']['full', 'orbax'].model
    run = tmp_path / 'runs' / 'dummy' / 'jax'
    params = {'user_emb': rng.randn(model.n_users, D).astype(np.float32),
              'item_emb': rng.randn(model.n_items, D).astype(np.float32)}
    jax_ck = OrbaxCheckpointer()
    jax_ck.save_latest(str(run), {'params': params, 'epoch': 2,
                                  'model': 'lgcn'})
    jax_ck.promote_best(str(run))
    assert (run / 'best.orbax').is_dir()
    want = jax_ck.load(str(run))
    got = tck.DistCheckpointer().load(str(run))
    assert sorted(got) == sorted(want) == ['epoch', 'model', 'params']
    assert (got['epoch'], got['model']) == (want['epoch'], want['model'])
    for name, table in params.items():
        assert got['params'][name].dtype == np.float32
        np.testing.assert_array_equal(got['params'][name], table)
        np.testing.assert_array_equal(got['params'][name],
                                      np.asarray(want['params'][name]))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    served = port_main([*_argv(runs['data']), '--ckpt_backend', 'orbax',
                        '--load', str(run), '--no_train', '--uid', 'jax'])
    for name, table in params.items():
        np.testing.assert_array_equal(
            getattr(served.model, name).detach().numpy(), table)


def test_a_directory_neither_dcp_nor_orbax_is_refused(runs, tmp_path,
                                                      monkeypatch):
    run = tmp_path / 'runs' / 'dummy' / 'odd'
    (run / 'best.orbax').mkdir(parents=True)
    (run / 'best.orbax' / 'data.bin').write_bytes(b'not a checkpoint')
    with pytest.raises(ValueError, match=r'neither a torch\.distributed'
                       r'\.checkpoint directory .* nor an Orbax checkpoint'):
        tck.DistCheckpointer().load(str(run))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    with pytest.raises(ValueError, match=r'has no \.metadata\) nor an '
                       r'Orbax checkpoint \(it has no _METADATA'):
        port_main([*_argv(runs['data']), '--ckpt_backend', 'orbax',
                   '--load', str(run), '--no_train', '--uid', 'refused'])


def test_a_run_without_best_orbax_loads_best_pkl(runs, monkeypatch):
    """The JAX backend's fallback (``checkpoint.py:152-162``): a pickle
    run's directory serves through ``--ckpt_backend orbax``."""
    pickle_run = runs['single']['full', 'pickle']
    run = runs['dirs'][1] / pickle_run.cfg.save_path
    assert not (run / 'best.orbax').exists() and (run / 'best.pkl').exists()
    want = tck.PickleCheckpointer().load(str(run))
    got = tck.DistCheckpointer().load(str(run))
    for name in ('user_emb', 'item_emb'):
        np.testing.assert_array_equal(got['params'][name],
                                      want['params'][name])
    monkeypatch.chdir(runs['dirs'][1])
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    argv = [*_argv(runs['data']), '--load', str(run), '--no_train']
    a = port_main([*argv, '--ckpt_backend', 'orbax', '--uid', 'fallback'])
    b = port_main([*argv, '--uid', 'as-pickle'])
    for name, v in b.last_metrics.items():
        np.testing.assert_array_equal(a.last_metrics[name], v)


def test_a_tree_round_trips_in_one_process(tmp_path):
    tree = {'params': {'user_emb': np.arange(12, dtype=np.float32).reshape(
        6, 2), 'tower': [{'w': np.ones((3, 1), np.float32),
                          'b': np.zeros(1, np.float32)}]},
        'epoch': np.int64(7), 'model': 'lgcn', 'none': None, 'flag': True,
        'lr': 1e-3, 'shape': (2, 3), 'empty': np.zeros((0, 2)),
        'state': torch.arange(5, dtype=torch.uint8)}
    ck = tck.DistCheckpointer()
    ck.save_resume(str(tmp_path), tree)
    got = ck.load_resume(str(tmp_path))
    assert got['epoch'] == 7 and isinstance(got['epoch'], np.int64)
    assert (got['model'], got['none'], got['flag'], got['lr'],
            got['shape']) == ('lgcn', None, True, 1e-3, (2, 3))
    np.testing.assert_array_equal(got['params']['user_emb'],
                                  tree['params']['user_emb'])
    assert got['params']['tower'][0]['w'].shape == (3, 1)
    assert got['empty'].shape == (0, 2) and got['empty'].dtype == np.float64
    assert torch.equal(got['state'], tree['state'])
    with pytest.raises(TypeError, match='cannot checkpoint'):
        ck.save_resume(str(tmp_path), {'bad': object()})


def test_a_failed_save_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    import torch.distributed.checkpoint as dcp
    ck = tck.DistCheckpointer()
    ck.save_latest(str(tmp_path), {'params': {'x': np.ones(3)}, 'epoch': 1})
    real = dcp.save

    def crash(state, checkpoint_id, **kw):
        real(state, checkpoint_id=checkpoint_id, **kw)
        raise OSError('disk full')

    monkeypatch.setattr(dcp, 'save', crash)
    with pytest.raises(OSError, match='disk full'):
        ck.save_latest(str(tmp_path), {'params': {'x': np.zeros(3)},
                                       'epoch': 2})
    monkeypatch.setattr(dcp, 'save', real)
    assert ck.load(str(tmp_path / ck.latest_name))['epoch'] == 1
    ck.save_latest(str(tmp_path), {'params': {'x': np.zeros(3)}, 'epoch': 3})
    got = ck.load(str(tmp_path / ck.latest_name))
    assert got['epoch'] == 3 and not got['params']['x'].any()
    assert sorted(os.listdir(tmp_path)) == [ck.latest_name]


def test_boosted_heads_keep_forest_npz_beside_the_orbax_directories(
        runs, monkeypatch):
    monkeypatch.chdir(runs['dirs'][1])
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    base = runs['dirs'][1] / runs['single']['full', 'orbax'].cfg.save_path
    argv = ['--model', 'gbdt', *_argv(runs['data'])[2:], '--ckpt_backend',
            'orbax']
    fit = port_main([*argv, '--load_base', str(base), '--uid', 'gbdt-orbax'])
    run = runs['dirs'][1] / fit.cfg.save_path
    assert {'forest.npz', *ORBAX_DIRS} <= set(os.listdir(run))
    served = port_main([*argv, '--load', str(run), '--no_train', '--uid',
                        'gbdt-orbax-serve'])
    for name, v in fit.last_metrics.items():
        np.testing.assert_array_equal(served.last_metrics[name], v)
