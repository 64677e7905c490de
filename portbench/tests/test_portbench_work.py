"""``work.py`` and the frozen ``bound_ms`` against hand-counted graphs,
and a reader's arithmetic."""

import pytest

from portbench import work


def test_bound_ms_counts_tables_csr_and_output():
    # 3 sources, 2 destinations, 4 edges, d = 2: x 3*2, rowptr 3, col 4,
    # w 4, out 2*2 -> 4 * 21 bytes
    ms, which = work.bound_ms(3, 2, 4, 2)
    assert which == 'bytes'
    assert ms == pytest.approx(4 * 21 / work.PEAK_BYTES_PER_S * 1e3)


def test_bound_ms_by_operations_when_they_dominate():
    # d = 4096, one edge: 2 * 4096 ops vs 4 * (4096 + 2 + 2 + 4096) bytes
    ms, which = work.bound_ms(1, 1, 1, 4096, n_kept=10**6)
    assert which == 'operations'
    assert ms == pytest.approx(2 * 10**6 * 4096 / work.PEAK_F32_FLOP_PER_S
                               * 1e3)


def test_spmm_and_propagation():
    s = work.Shape(n_users=2, n_items=3, n_edges=4, d=2, n_layers=3,
                   keep=0.5)
    to_user = work.spmm(3, 2, 4, 2, 0.5)
    assert to_user.flops == 2 * 2 * 0.5 * 4
    assert to_user.nbytes == 4 * (6 + 4) + 4 * (3 + 4) + 4 * 4
    p = work.propagation(s, 0.5)
    assert p.flops == 3 * (8 + 8)
    assert p.nbytes == 3 * (to_user.nbytes + work.spmm(2, 3, 4, 2, 0.5).nbytes)
    assert work.k1_mean_bound_ms(s, 1.0) == pytest.approx(
        0.5 * (work.bound_ms(3, 2, 4, 2)[0] + work.bound_ms(2, 3, 4, 2)[0]))


def test_steps_and_requests():
    s = work.Shape(n_users=10, n_items=20, n_edges=30, d=4, n_layers=2,
                   keep=0.6)
    adam = work.adam(s)
    assert adam.nbytes == 7 * 4 * 30 * 4
    step = work.lgcn_step(s, batch=5, neg=1)
    assert step.flops == 2 * work.propagation(s, 0.6).flops
    assert step.nbytes == (2 * work.propagation(s, 0.6).nbytes
                           + 2 * 4 * 5 * 3 * 4 + adam.nbytes)
    adv = work.adv_step(s, 5, 20, 5, 3)
    assert adv.flops == 3 * work.propagation(s, 0.6).flops + 2 * 5 * 20 * 4
    req = work.serve_request(7, s, batch=4, k=3)
    prod = work.catalogue_product(4, s) + work.catalogue_product(3, s)
    assert req.flops == work.propagation(s, 1.0).flops + prod.flops
    assert req.nbytes == (work.propagation(s, 1.0).nbytes + prod.nbytes
                          + 7 * 3 * 12)
    assert req.least_s() == max(req.flops / work.PEAK_F32_FLOP_PER_S,
                                req.nbytes / work.PEAK_BYTES_PER_S)


def test_train_idle_is_the_windows_step_against_the_traced_busy_time():
    from types import SimpleNamespace

    from portbench import harness
    read = harness.metric_readers()['device_idle.train'].read
    trace = SimpleNamespace(busy_s=0.36, window_s=0.48)
    r = SimpleNamespace(kind='train', trace=trace, traced_count=60,
                        count=1000, window_s=6.25)
    assert read(r) == pytest.approx(100 * (1 - 6.0 / 6.25))
    assert read(SimpleNamespace(**(r.__dict__ | {'trace': None}))) is None
    assert read(SimpleNamespace(**(r.__dict__ | {'kind': 'serve'}))) is None
