"""The readers of the program's spans on hand-built traces: each gives
the exact number, and None where its span or the device time is absent
(a program without the spans; the CPU)."""

import pytest

from portbench import harness, spans
from portbench.tracing import WINDOW, Trace

MS = 1_000_000          # ns

READERS = harness.metric_readers()
TRAIN = ('forward_ms_per_step', 'backward_ms_per_step', 'adam_ms_per_step',
         'launches_per_step', 'mining_topk_ms_per_step')
SERVE = ('retrieval_topk_ms_per_request', 'request_idle_ms')


def readings(kind, trace, count):
    return harness.Readings(kind, None, 1.0, count, [0.001] * count, 0.0,
                            0.0, trace, count)


def op(name, start, end, launch):
    return (name, start * MS, end * MS, launch * MS)


def ms(*pairs):
    return [(s * MS, e * MS) for s, e in pairs]


def train_trace():
    """Two steps; a kernel of step 1's forward runs after its span ends
    (launch time decides); one launch between steps, one of unknown
    launch."""
    ranges = {WINDOW: ms((0, 100)), 'step': ms((0, 45), (50, 95)),
              'train.step': ms((0, 40), (50, 90)),
              'train.salts': ms((0, 1), (50, 51)),
              'train.forward': ms((1, 10), (51, 60)),
              'mining': ms((3, 9), (53, 59)),
              'mining.topk': ms((4, 8), (54, 58)),
              'train.backward': ms((10, 20), (60, 70)),
              'train.adam': ms((20, 30), (70, 80))}
    ops = [op('k1', 2, 5, 1.5), op('topk', 6, 8, 4.5), op('k1', 12, 14, 9),
           op('k1_bwd', 15, 19, 11), op('adam', 21, 22, 20.5),
           op('k1', 52, 55, 52), op('topk', 56, 57.5, 55),
           op('k1_bwd', 61, 63, 61), op('adam', 71, 72, 71),
           op('between', 95, 96, 45), op('unknown', 96, 97, -1)]
    return Trace(ms((0, 100))[0], ops, ranges)


def serve_trace():
    """Two requests: the first idle 2 + 5 ms (before its first kernel,
    between two kernels), the second 5 + 1 + 17 ms; busy time outside both
    counts for neither."""
    ranges = {WINDOW: ms((0, 100)), 'request': ms((9, 41), (49, 81)),
              'serve.request': ms((10, 40), (50, 80)),
              'serve.retrieve': ms((20, 25), (60, 62)),
              'retrieve.topk': ms((21, 24), (60.5, 61.5))}
    ops = [op('k1', 12, 20, 11), op('gemm', 18, 30, 17),
           op('topk', 26, 29, 22), op('copy', 35, 45, 34),
           op('k1', 55, 60, 54), op('topk', 61, 63, 61),
           op('outside', 85, 90, 84)]
    return Trace(ms((0, 100))[0], ops, ranges)


def read(name, r):
    return READERS[name].read(r)


def test_train_readers_give_the_exact_numbers():
    r = readings('train', train_trace(), 2)
    assert read('forward_ms_per_step', r) == pytest.approx((3 + 2 + 2 + 3
                                                            + 1.5) / 2)
    assert read('backward_ms_per_step', r) == pytest.approx((4 + 2) / 2)
    assert read('adam_ms_per_step', r) == pytest.approx((1 + 1) / 2)
    assert read('mining_topk_ms_per_step', r) == pytest.approx((2 + 1.5) / 2)
    assert read('launches_per_step', r) == 9 / 2
    for name in SERVE:
        assert read(name, r) is None


def test_serve_readers_give_the_exact_numbers():
    r = readings('serve', serve_trace(), 2)
    assert read('retrieval_topk_ms_per_request', r) == pytest.approx(
        (3 + 2) / 2)
    assert read('request_idle_ms', r) == pytest.approx((2 + 5 + 5 + 1 + 17)
                                                      / 2)
    for name in TRAIN:
        assert read(name, r) is None


def test_idle_counts_overlapping_spans_once_and_stays_in_the_window():
    tr = serve_trace()
    tr.ranges['serve.request'] = ms((10, 40), (15, 30), (30, 42), (95, 120))
    # (10, 42): busy 12-30 and 35-42; (95, 100): idle, clipped at the end
    assert spans.idle_inside_s(tr, 'serve.request') == pytest.approx(
        (2 + 5 + 5) * 1e-3)


@pytest.mark.parametrize('kind, names, make', [
    ('train', TRAIN, train_trace), ('serve', SERVE, serve_trace)])
def test_no_span_no_reading(kind, names, make):
    """A program without the spans: only the benchmark's own ranges."""
    tr = make()
    tr.ranges = {k: v for k, v in tr.ranges.items()
                 if k in (WINDOW, 'step', 'request')}
    r = readings(kind, tr, 2)
    for name in names:
        assert read(name, r) is None, name


@pytest.mark.parametrize('kind, names, make', [
    ('train', TRAIN, train_trace), ('serve', SERVE, serve_trace)])
def test_no_device_time_no_reading(kind, names, make):
    """The CPU: the spans are there, no operation ran on a card."""
    tr = make()
    tr.ops = []
    r = readings(kind, tr, 2)
    for name in names:
        assert read(name, r) is None, name
    assert read(names[0], readings(kind, None, 0)) is None
