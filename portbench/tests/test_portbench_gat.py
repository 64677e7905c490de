"""The ``gat-book.train`` cell on the CPU at a small size: a sound run is
``correct``, the bf16 control and the training faults each exceed a limit,
the traced run reports the train readers; ``work_gat``'s counts against a
hand count; the new readers on a hand-built trace."""

import pytest

from portbench import faults, harness, work, work_gat
from portbench.tracing import WINDOW, Trace
from portbench.traffic import train_conv

CELL = 'gat-book.train'
MS = 1_000_000          # ns


def test_a_sound_run_is_correct_and_traced_as_a_train_cell(tmp_path, small):
    r = harness.run(CELL, 41, 0.3, True, device='cpu', overrides=small,
                    cache_dir=str(tmp_path))
    assert r['correct'], r['checks']
    assert set(r['checks']) == {'loss_gap', 'grad_gap', 'change_gap',
                                'sample_bad', 'id_map_bad'}
    # no device time on the CPU: the host's readers alone
    assert {'train_host_ms_per_step', 'train_mfu', 'load_s'} \
        <= set(r['metrics'])


@pytest.mark.parametrize('mode', ['control', 'unchanged', 'half_batch'])
def test_control_and_faults_exceed_a_limit(tmp_path, small, monkeypatch,
                                           mode):
    """``faults.plant`` knows a training cell as kind ``train``: the
    faults reach this cell's program through ``train_conv.plant_fault``."""
    monkeypatch.setattr(faults, 'plant', train_conv.plant_fault)
    r = harness.run(CELL, 43, 0.3, False, device='cpu', mode=mode,
                    overrides=small, cache_dir=str(tmp_path))
    assert not r['correct'], r['checks']
    assert [k for k, c in r['checks'].items() if c['value'] > c['limit']]


def test_the_conv_weights_follow_the_seed():
    a = train_conv.draw_convs(2**31 + 5, 3, 8, 'cpu')
    b = train_conv.draw_convs(2**31 + 5, 3, 8, 'cpu')
    c = train_conv.draw_convs(7, 3, 8, 'cpu')
    assert [sorted(lp) for lp in a] == [sorted(('w', 'a_src', 'a_dst',
                                                'b'))] * 3
    assert all((lp['w'] == lq['w']).all() for lp, lq in zip(a, b))
    assert not (a[0]['w'] == c[0]['w']).all()
    assert a[0]['w'].shape == (8, 8) and a[0]['a_src'].shape == (8,)
    bound = (6.0 / 16) ** 0.5
    assert float(a[0]['w'].abs().max()) <= bound


def test_k3_and_k4_counted_by_hand_on_a_three_row_csr():
    # forward: 4 sources -> 3 destinations, 5 edges, d = 2, keep 0.5
    k3 = work_gat.k3(4, 3, 5, 2, 0.5)
    assert k3.flops == (2 * 2 + 6) * 0.5 * 5
    # h 4*2, s 4, d 3, num 3*2, den 3, m 3; rowptr 4, col 5
    assert k3.nbytes == 4 * (8 + 4 + 3 + 6 + 3 + 3) + 4 * (4 + 5)
    k4 = work_gat.k4(4, 3, 5, 2, 0.5)
    assert k4.flops == (4 * 2 + 8) * 0.5 * 5
    # h 4*2, g_num 3*2, s 4, d 3, m 3, g_den 3, dh 4*2, ds 4, dd 3;
    # the transpose's rowptr 5, col 5
    assert k4.nbytes == 4 * (8 + 6 + 4 + 3 + 3 + 3 + 8 + 4 + 3) \
        + 4 * (5 + 5)


def test_a_step_and_the_bounds():
    s = work.Shape(n_users=3, n_items=4, n_edges=5, d=2, n_layers=3,
                   keep=0.5)
    n = 7
    layer = (work_gat.dense(n, 2) + work_gat.k3(4, 3, 5, 2, 0.5)
             + work_gat.k3(3, 4, 5, 2, 0.5) + work_gat.fold(n, 2)
             + work_gat.fold_backward(n, 2) + work_gat.k4(4, 3, 5, 2, 0.5)
             + work_gat.k4(3, 4, 5, 2, 0.5) + work_gat.dense_backward(n, 2))
    step = work_gat.step(s, batch=2, neg=1)
    params = n * 2 + 3 * (4 + 6)
    assert step.flops == 3 * layer.flops
    assert step.nbytes == (3 * layer.nbytes + 2 * 4 * 2 * 3 * 2
                           + 7 * 4 * params)
    assert work_gat.k3_bound_ms(s, 0.5) == pytest.approx(
        0.5e3 * (work_gat.k3(4, 3, 5, 2, 0.5).least_s()
                 + work_gat.k3(3, 4, 5, 2, 0.5).least_s()))
    assert work_gat.k4_bound_ms(s, 1.0) == pytest.approx(
        0.5e3 * (work_gat.k4(4, 3, 5, 2, 1.0).least_s()
                 + work_gat.k4(3, 4, 5, 2, 1.0).least_s()))


def gat_trace():
    """Two steps: K3 launched inside ``conv.attention`` (one of its ops a
    fold, 1 ms), K4 inside ``conv.attention.backward``; a K1 and a copy
    elsewhere."""
    def ms(*pairs):
        return [(a * MS, b * MS) for a, b in pairs]
    ranges = {WINDOW: ms((0, 100)),
              'conv.attention': ms((1, 5), (51, 55)),
              'conv.attention.backward': ms((20, 24), (70, 74))}
    ops = [('void gat_fwd_kernel<4, 1>', 2 * MS, 4 * MS, 2 * MS),
           ('fold', 4 * MS, 5 * MS, 3 * MS),
           ('void gat_bwd_kernel<4, 1>', 21 * MS, 24 * MS, 21 * MS),
           ('void gat_fwd_kernel<4, 1>', 52 * MS, 54 * MS, 52 * MS),
           ('fold', 54 * MS, 55 * MS, 53 * MS),
           ('void gat_bwd_kernel<4, 1>', 71 * MS, 74 * MS, 71 * MS),
           ('spmm_dropout_kernel', 80 * MS, 81 * MS, 79 * MS)]
    return Trace(ms((0, 100))[0], ops, ranges)


def test_the_attention_readers_on_a_hand_built_trace():
    readers = harness.metric_readers()
    s = work.Shape(n_users=52643, n_items=91599, n_edges=2387286, d=64,
                   n_layers=3, keep=0.6)
    r = harness.Readings('train', s, 1.0, 2, [0.001] * 2, 0.0, 0.0,
                         gat_trace(), 2, 0.6)
    assert readers['attention_ms_per_step'].read(r) == pytest.approx(
        (3 + 3 + 3 + 3) / 2)
    assert readers['k3_roofline.train'].read(r) == pytest.approx(
        100 * 2 * work_gat.k3_bound_ms(s, 0.6) / 4.0)
    assert readers['k4_roofline.train'].read(r) == pytest.approx(
        100 * 2 * work_gat.k4_bound_ms(s, 0.6) / 6.0)
    # a program without the spans, a serve cell, no trace: no reading
    bare = Trace(r.trace.window, r.trace.ops, {WINDOW: [r.trace.window]})
    r_bare = harness.Readings('train', s, 1.0, 2, [0.001] * 2, 0.0, 0.0,
                              bare, 2, 0.6)
    assert readers['attention_ms_per_step'].read(r_bare) is None
    assert readers['k3_roofline.train'].read(r_bare) is not None
    for name in ('attention_ms_per_step', 'k3_roofline.train',
                 'k4_roofline.train'):
        serve = harness.Readings('serve', s, 1.0, 2, [0.001] * 2, 0.0, 0.0,
                                 gat_trace(), 2, 0.6)
        assert readers[name].read(serve) is None
        none = harness.Readings('train', s, 1.0, 2, [0.001] * 2, 0.0, 0.0)
        assert readers[name].read(none) is None
