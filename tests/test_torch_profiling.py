"""The port's ``utils/profiling.py`` and ``--trace``.

``StepTimer`` and ``profile`` as the JAX package's ``tests/test_profiling
.py`` holds its own; the trainer's examples/s from the timer; ``--trace
DIR`` on the CPU for a trained model of each trainer (``lgcn``, a conv
model, a boosted head, ``lgcn --mesh 1x1``) writes a trace that parses;
and on the card, a profiler that cannot record CUDA activity raises.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from textgcn_tpu.utils.profiling import StepTimer as JaxStepTimer
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.utils import profiling
from textgcn_tpu_torch.utils.profiling import StepTimer, profile


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: these tensors are tiny, so one thread is faster,
    and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


def test_step_timer():
    t = StepTimer(window=5)
    t.start()
    for _ in range(8):
        t.tick()
    assert len(t._times) == 5  # rolling window
    assert t.mean_s >= 0
    s = t.summary()
    assert 'p50=' in s and 'p95=' in s


def test_step_timer_summary_matches_jax():
    a, b = StepTimer(window=4), JaxStepTimer(window=4)
    assert a.summary() == b.summary() == 'no steps timed'
    times = [0.003, 0.001, 0.002, 0.010, 0.004]
    for t in (a, b):
        t._times = list(times[-4:])
    assert a.summary() == b.summary() and a.mean_s == b.mean_s


def test_start_leaves_the_time_between_steps_out():
    t = StepTimer()
    t.start()
    t.tick()
    import time
    time.sleep(0.05)
    t.start()
    t.tick()
    assert max(t._times) < 0.05


def test_profile_decorator(capsys):
    @profile
    def work():
        return sum(range(1000))

    assert work() == sum(range(1000))
    out = capsys.readouterr().out
    assert 'cumtime' in out


def _cli(tmp_path, monkeypatch, argv):
    from textgcn_tpu_torch import cli
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    return cli.main(argv)


COMMON = ['--epochs', '2', '--evaluate_every', '1', '--batch_size', '16',
          '--emb_size', '16', '-k', '3', '5', '--quiet']


@pytest.fixture(scope='module')
def data(tmp_path_factory, dummy_dir):
    d = str(tmp_path_factory.mktemp('data') / 'dummy')
    shutil.copytree(dummy_dir, d)
    return d


def _events(path):
    with open(path) as f:
        return json.load(f)['traceEvents']


@pytest.mark.parametrize('flags', [
    ('--model', 'lgcn'),
    ('--model', 'gcn', '--aggr', 'mean'),
    ('--model', 'lgcn', '--mesh', '1x1'),
], ids=['lgcn', 'gcn', 'lgcn-mesh'])
def test_trace_of_training_on_the_cpu(tmp_path, monkeypatch, data, flags):
    out = tmp_path / 'trace'
    tr = _cli(tmp_path, monkeypatch, ['--data', data, *flags, *COMMON,
                                       '--uid', 'traced', '--trace',
                                       str(out)])
    path = profiling.trace_path(str(out), 0)
    assert os.listdir(out) == [os.path.basename(path)]
    events = _events(path)
    assert any('aten::' in e.get('name', '') for e in events)
    assert profiling.device_events(path) == []        # nothing on a card
    assert len(tr.loss_history) == 2
    assert len(tr.step_timer._times) == 1             # window: 1 epoch


def test_trace_of_a_boosted_head(tmp_path, monkeypatch, data):
    base = _cli(tmp_path, monkeypatch, ['--data', data, '--model', 'lgcn',
                                        *COMMON, '--uid', 'base'])
    out = tmp_path / 'trace'
    tr = _cli(tmp_path, monkeypatch, [
        '--data', data, '--model', 'gbdt', '--load_base',
        base.cfg.save_path, '--batch_size', '16', '--emb_size', '16', '-k',
        '3', '5', '--quiet', '--uid', 'gbdt', '--trace', str(out)])
    assert tr.model.forest_state is not None
    names = {e.get('name', '') for e in _events(
        profiling.trace_path(str(out)))}
    assert any('aten::' in n for n in names)


def test_examples_per_second_come_from_the_step_timer(tmp_path, monkeypatch,
                                                      data, caplog):
    tr = _cli(tmp_path, monkeypatch, ['--data', data, '--model', 'lgcn',
                                       '--epochs', '4', '--evaluate_every',
                                       '2', '--batch_size', '16',
                                       '--emb_size', '16', '-k', '3', '5',
                                       '--uid', 'eps'])
    timer = tr.step_timer
    assert timer.window == 2 and len(timer._times) == 2
    with open(os.path.join(tr.cfg.save_path, 'log.log')) as f:
        lines = [ln for ln in f if 'examples/s' in ln]
    assert len(lines) == 2
    want = tr.model.num_batches(16) * 16 / timer.mean_s
    got = float(lines[-1].split('(')[1].split(' examples/s')[0])
    assert abs(got - want) <= 0.5 + 1e-6 * want


def test_on_the_card_no_cuda_activity_raises(tmp_path, monkeypatch):
    """No fallback: without CUDA activity in the profiler, a trace of a
    run on the card refuses to start."""
    from torch.profiler import ProfilerActivity
    monkeypatch.setattr(torch.profiler, 'supported_activities',
                        lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match='cannot record CUDA activity'):
        with profiling.trace(str(tmp_path), 'cuda'):
            pass
    assert not os.listdir(tmp_path)


def test_a_card_trace_without_device_events_raises(tmp_path, monkeypatch):
    """A trace of the card that holds no device event is refused after
    the run (the profiler lost its CUDA activity)."""
    from torch.profiler import ProfilerActivity
    monkeypatch.setattr(torch.profiler, 'supported_activities',
                        lambda: {ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA})
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
    real = torch.profiler.profile

    def cpu_only(activities, **kw):
        return real(activities=[ProfilerActivity.CPU], **kw)

    monkeypatch.setattr(torch.profiler, 'profile', cpu_only)
    with pytest.raises(RuntimeError, match='no CUDA activity'):
        with profiling.trace(str(tmp_path), 'cuda'):
            torch.ones(4).sum()


def test_trace_paths_are_named_by_rank(tmp_path):
    assert profiling.trace_path('d', 3) == os.path.join(
        'd', 'trace_rank3.pt.trace.json')
    with profiling.trace(str(tmp_path)) as path:
        np.ones(3).sum()
    assert path == profiling.trace_path(str(tmp_path), 0)
    assert os.path.exists(path)
