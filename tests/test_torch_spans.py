"""The port's spans (``utils/profiling.span``) on the CPU.

Under a ``torch.profiler`` recording CPU activity, one ``lgcn`` step (and
one with ``--refresh_every``), one ``adv_sampling`` step, an epoch's
sampling and one ``_predict_users`` call, exact and in serving mode, emit
every span as a user annotation, nested as ``docs/TORCH.md``'s "Tracing"
lists them; the outer spans carry their inputs.  With no profiler a span
enters no range.  The losses, the parameters after a step and the served
indices and values are bit for bit the same with and without the
profiler.  ``--trace DIR`` writes the spans into its Chrome trace.
"""

import json
import logging
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.models.adv_sampling import AdvSamplModel
from textgcn_tpu_torch.models.lightgcn import LightGCN
from textgcn_tpu_torch.ops.retrieval import APPROX_TOPK_ENV
from textgcn_tpu_torch.train.trainer import Trainer
from textgcn_tpu_torch.utils import profiling

D = 16
BATCH = 16

# each span and the span it nests in
TRAIN_PARENTS = {'train.salts': 'train.step', 'train.forward': 'train.step',
                 'train.backward': 'train.step', 'train.adam': 'train.step'}
REFRESH_PARENTS = {**TRAIN_PARENTS, 'train.refresh': 'train.step'}
MINING_PARENTS = {**TRAIN_PARENTS, 'mining': 'train.forward',
                  'mining.scores': 'mining', 'mining.mask': 'mining',
                  'mining.topk': 'mining'}
SERVE_PARENTS = {'serve.upload': 'serve.request',
                 'serve.propagate': 'serve.request',
                 'serve.retrieve': 'serve.request',
                 'retrieve.scores': 'serve.retrieve',
                 'retrieve.mask': 'serve.retrieve',
                 'retrieve.topk': 'serve.retrieve',
                 'serve.fetch': 'serve.request'}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the tensors are tiny, and the suite's parallel
    workers do not oversubscribe the cores."""
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


@pytest.fixture(scope='module')
def data(dummy_dir):
    return load_interactions(dummy_dir)


def make_trainer(dummy_dir, data, model='lgcn', **kw):
    cfg = tconfig.Config(model=model, data=dummy_dir, emb_size=D, k=(3, 5),
                         batch_size=BATCH, epochs=1, save=False,
                         **kw).finalize()
    cls = AdvSamplModel if model == 'adv_sampling' else LightGCN
    return Trainer(cfg, cls(cfg, data, device='cpu'), data)


def recorded(fn, record_shapes=False):
    """``fn()``'s result and the user annotations the profiler recorded
    while it ran: ``(name, start_ns, end_ns, thread, inputs)``."""
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=record_shapes) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              e.start_thread_id(), list(e.concrete_inputs()))
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    return out, spans


def assert_nested(spans, parents):
    """Every span of ``parents`` is there, each inside a span of its
    parent's name on its thread."""
    names = {s[0] for s in spans}
    assert set(parents) | set(parents.values()) <= names, names
    for name, lo, hi, thread, _ in spans:
        parent = parents.get(name)
        if parent is None:
            continue
        assert lo <= hi
        assert any(p[0] == parent and p[3] == thread and p[1] <= lo
                   and hi <= p[2] for p in spans), (name, parent)


def one_step(tr, step=0):
    batches = tr.model.sample_batches(tr.generator, BATCH)
    return tr.epoch_step(step, batches[step])


@pytest.mark.parametrize('model, kw, parents', [
    ('lgcn', {}, TRAIN_PARENTS),
    ('lgcn', {'refresh_every': 2}, REFRESH_PARENTS),
    ('adv_sampling', {}, MINING_PARENTS),
], ids=['lgcn', 'lgcn-refresh', 'adv_sampling'])
def test_a_training_step_emits_its_spans_nested(dummy_dir, data, model, kw,
                                                parents):
    tr = make_trainer(dummy_dir, data, model, **kw)
    batches = tr.model.sample_batches(tr.generator, BATCH)
    _, spans = recorded(lambda: tr.epoch_step(0, batches[0]))
    assert_nested(spans, parents)
    assert [s[0] for s in spans].count('train.step') == 1
    if 'train.refresh' not in parents:
        assert 'train.refresh' not in {s[0] for s in spans}
    _, spans = recorded(lambda: tr.epoch_step(1, batches[1]))
    assert 'train.refresh' not in {s[0] for s in spans}


@pytest.mark.parametrize('model', ['lgcn', 'adv_sampling'])
def test_the_epochs_sampling_is_a_span(dummy_dir, data, model):
    tr = make_trainer(dummy_dir, data, model)
    batches, spans = recorded(
        lambda: tr.model.sample_batches(tr.generator, BATCH))
    assert [s[0] for s in spans] == ['train.sample_epoch']
    assert len(batches) == tr.model.num_batches(BATCH)


@pytest.mark.parametrize('approx', ['', '0.95'], ids=['exact', 'serving'])
def test_a_request_emits_its_spans_nested(dummy_dir, data, monkeypatch,
                                          approx):
    monkeypatch.setenv(APPROX_TOPK_ENV, approx)
    tr = make_trainer(dummy_dir, data)
    users = np.arange(2 * BATCH + 3) % data.n_users     # 3 batches
    (idx, vals), spans = recorded(lambda: tr._predict_users(users))
    assert idx.shape == (len(users), 5)
    assert_nested(spans, SERVE_PARENTS)
    names = [s[0] for s in spans]
    assert names.count('serve.request') == 1
    assert names.count('serve.propagate') == 1
    for name in ('serve.retrieve', 'retrieve.scores', 'retrieve.mask',
                 'retrieve.topk'):
        assert names.count(name) == 3, name
    assert not any(n.startswith('mining') for n in names)


def test_the_outer_spans_carry_their_inputs(dummy_dir, data):
    """``train.step``: the step's index; ``serve.request``: the request's
    sequence number and its cohort size (kept when the profiler records
    shapes)."""
    tr = make_trainer(dummy_dir, data)
    batches = tr.model.sample_batches(tr.generator, BATCH)
    _, spans = recorded(lambda: tr.epoch_step(1, batches[1]), True)
    assert [s[4] for s in spans if s[0] == 'train.step'] == [[1]]
    users = data.test_users[:7]
    tr._predict_users(users)
    _, spans = recorded(lambda: tr._predict_users(users), True)
    assert [s[4] for s in spans if s[0] == 'serve.request'] == [[2, 7]]


def test_no_profiler_no_range(dummy_dir, data, monkeypatch):
    """With no profiler running a span is the shared no-op context and
    enters no range."""
    calls = []
    real = torch.autograd._record_function_with_args_enter
    monkeypatch.setattr(torch.autograd, '_record_function_with_args_enter',
                        lambda *a: calls.append(a[0]) or real(*a))
    real_rf = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda *a, **k: calls.append(a[0]) or real_rf(*a,
                                                                      **k))
    assert profiling.span('train.step', (3,)) is profiling._NO_SPAN
    for model in ('lgcn', 'adv_sampling'):
        tr = make_trainer(dummy_dir, data, model, refresh_every=1)
        one_step(tr)
        tr._predict_users(data.test_users)
    assert calls == []
    # the same calls under the profiler do enter ranges (beside torch's
    # own, ``Optimizer.step#Adam.step``, ...)
    _, spans = recorded(lambda: one_step(tr))
    assert 'train.step' in calls
    assert sorted(calls) == sorted(s[0] for s in spans
                                   if not s[0].startswith('Optimizer.'))


@pytest.mark.parametrize('model', ['lgcn', 'adv_sampling'])
def test_results_are_the_same_with_and_without_the_profiler(dummy_dir, data,
                                                            model):
    runs = []
    for traced in (False, True):
        tr = make_trainer(dummy_dir, data, model)
        batches = tr.model.sample_batches(tr.generator, BATCH)

        def work():
            losses = [tr.epoch_step(k, batches[k])[0] for k in range(2)]
            return losses, tr._predict_users(data.test_users)
        (losses, (idx, vals)), _ = recorded(work) if traced else (work(),
                                                                    None)
        params = [p.detach().clone() for p in tr.model.parameters()]
        runs.append((losses, params, idx, vals))
    (l0, p0, i0, v0), (l1, p1, i1, v1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert len(p0) == len(p1) and all(torch.equal(a, b)
                                      for a, b in zip(p0, p1))
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(v0, v1)


def test_trace_dir_holds_the_spans(tmp_path, monkeypatch, dummy_dir):
    from textgcn_tpu_torch import cli
    d = str(tmp_path / 'dummy')
    shutil.copytree(dummy_dir, d)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    out = str(tmp_path / 'trace')
    cli.main(['--model', 'lgcn', '--data', d, '--epochs', '1',
              '--evaluate_every', '1', '--batch_size', str(BATCH),
              '--emb_size', str(D), '-k', '3', '5', '--quiet', '--uid',
              'spans', '--trace', out])
    with open(profiling.trace_path(out)) as f:
        events = json.load(f)['traceEvents']
    names = {e['name'] for e in events if e.get('cat') == 'user_annotation'}
    assert {'train.step', 'train.forward', 'train.backward', 'train.adam',
            'train.sample_epoch', 'serve.request'} <= names
    steps = [e for e in events if e.get('name') == 'train.step']
    assert [e['args']['Concrete Inputs'] for e in steps[:2]] == [['0'],
                                                                 ['1']]
