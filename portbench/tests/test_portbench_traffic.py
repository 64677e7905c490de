"""The serving pool: every seed asks for the same requests, in another
order, each block of ``cohort_grid`` requests one of each size."""

import numpy as np

from portbench import harness
from portbench.traffic import serve


def pool(small, seed):
    t = harness.Cell.load('lgcn-book.serve', overrides=small).traffic
    rng = np.random.default_rng(5)
    train_user = np.repeat(np.arange(40), rng.integers(1, 30, 40))
    return t, serve.make_pool(t, train_user, 45, seed)


def test_every_seed_asks_for_the_same_requests(small):
    t, a = pool(small, 3)
    _, b = pool(small, 2**31 + 11)
    _, a2 = pool(small, 3)
    assert [r.users.tolist() for r in a] == [r.users.tolist() for r in a2]
    assert [r.users.tolist() for r in a] != [r.users.tolist() for r in b]
    assert (sorted(tuple(sorted(r.users.tolist())) for r in a)
            == sorted(tuple(sorted(r.users.tolist())) for r in b))
    grid = np.minimum(serve.cohort_grid(t), 40)
    for p in (a, b):
        assert len(p) == t['pool_requests']
        for s in range(0, len(p), len(grid)):
            sizes = sorted(len(r.users) for r in p[s:s + len(grid)])
            assert sizes == sorted(grid.tolist())
        for r in p:
            assert len(set(r.users.tolist())) == len(r.users)
            assert len(r.keep) == min(len(r.users), t['kept_rows'])
