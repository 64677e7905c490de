"""Generate a clustered synthetic dataset with text (meta + reviews).

    python -m textgcn_tpu_torch.tools.make_synthetic <out_dir> [n_users]
        [n_items] [seed] [--sharp] [--cold F]

Counterpart of the JAX package's ``tools/make_synthetic.py`` without
pandas: the same CLI, the same four modes and, for the same arguments,
the same bytes in ``train.tsv``, ``test.tsv``, ``meta_synced.tsv``,
``reviews_text.tsv`` and ``cold_items.txt``.  Every draw of
``np.random.RandomState(seed)`` comes in the JAX tool's order:

* the legacy per-user loop (``n_users <= 100_000``, not ``--sharp``):
  each user's draws, then ``groupby('user_id').filter(len >= 3)`` and
  ``groupby('user_id').sample(n=2, random_state=rng)``, which visits the
  users in the string order of their ids (``u0, u1, u10, ...``) and
  draws ``rng.choice(len(group), 2, replace=False)`` for each; the test
  rows leave the table in its order;
* the vectorised path above 100,000 users (draws with replacement, pair
  dedup, 2 held-out pairs per user);
* ``--sharp``: 95% own-cluster Zipf draws, 2 own-cluster pairs per user
  held out;
* ``--sharp --cold F``: a fraction F of each cluster's items cold (one
  train interaction each, one held-out cold pair per test user) and
  per-cluster template texts.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..data.tsv import write_table

# above this many users the legacy per-user loop gives way to the
# vectorised path (the JAX tool's threshold)
LOOP_USERS = 100_000


def _generate_sharp(rng, n_users, n_items, k_clusters, ucl, items_by_cl,
                    ext_pool=None):
    """95% own-cluster draws, Zipf (rank^-1) popularity within each
    cluster, 12-24 interactions per user, 2 own-cluster pairs per user
    held out; ``ext_pool`` restricts the 5% uniform draws.  Returns the
    (users, items) of train and of test."""
    n_inter = rng.randint(12, 25, n_users)
    n_own = np.maximum((n_inter * 0.95).astype(int), 3)
    n_ext = n_inter - n_own

    u_own = np.repeat(np.arange(n_users), n_own)
    i_own = np.empty(len(u_own), np.int64)
    cl_of_draw = ucl[u_own]
    for c in range(k_clusters):
        m = cl_of_draw == c
        pool = items_by_cl[c]
        if len(pool):
            w = 1.0 / np.arange(1, len(pool) + 1)
            i_own[m] = pool[rng.choice(len(pool), int(m.sum()),
                                       p=w / w.sum())]
        else:
            i_own[m] = rng.randint(0, n_items, int(m.sum()))
    u_ext = np.repeat(np.arange(n_users), n_ext)
    if ext_pool is None:
        i_ext = rng.randint(0, n_items, len(u_ext))
    else:
        i_ext = ext_pool[rng.randint(0, len(ext_pool), len(u_ext))]

    u_all = np.concatenate([u_own, u_ext])
    i_all = np.concatenate([i_own, i_ext])
    own = np.concatenate([np.ones(len(u_own), bool),
                          np.zeros(len(u_ext), bool)])
    # dedup (u, i), keeping the own tag if any duplicate was an own draw
    order = np.lexsort((~own, i_all, u_all))
    u_s, i_s, own_s = u_all[order], i_all[order], own[order]
    first = np.ones(len(u_s), bool)
    first[1:] = (u_s[1:] != u_s[:-1]) | (i_s[1:] != i_s[:-1])
    u_s, i_s, own_s = u_s[first], i_s[first], own_s[first]

    # shuffle, then stable-sort by user: the order within a user is random
    shuf = rng.permutation(len(u_s))
    srt = shuf[np.argsort(u_s[shuf], kind='stable')]
    u_p, i_p, own_p = u_s[srt], i_s[srt], own_s[srt]
    starts = np.searchsorted(u_p, np.arange(n_users))
    counts = np.diff(np.append(starts, len(u_p)))
    own_rank = _cumcount_where(u_p, own_p, starts)
    own_total = np.zeros(n_users, np.int64)
    np.add.at(own_total, u_p[own_p], 1)
    is_test = own_p & (own_rank < 2) & (own_total[u_p] >= 4) \
        & (counts[u_p] >= 5)
    return (u_p[~is_test], i_p[~is_test]), (u_p[is_test], i_p[is_test])


def _split_cold(rng, items_by_cl, cold: float):
    """Per cluster, a ``cold`` fraction of the items (keeping 3 warm ones)
    leaves the Zipf pools.  Returns (warm pools, cold-item mask)."""
    n_items = 1 + max((int(p.max()) for p in items_by_cl if len(p)),
                      default=0)
    cold_mask = np.zeros(n_items, bool)
    warm_by_cl = []
    for pool in items_by_cl:
        n_cold = min(int(round(len(pool) * cold)), max(len(pool) - 3, 0))
        if n_cold > 0:
            cold_c = rng.choice(pool, size=n_cold, replace=False)
            cold_mask[cold_c] = True
            warm_by_cl.append(np.setdiff1d(pool, cold_c))
        else:
            warm_by_cl.append(pool)
    return warm_by_cl, cold_mask


def _add_cold(rng, train, test, ucl, icl, cold_mask, k_clusters, n_users):
    """One train interaction per cold item (a random user of its cluster)
    and one held-out (user, own-cluster cold item) pair per test user."""
    users_by_cl = [np.where(ucl == c)[0] for c in range(k_clusters)]
    cold_items = np.where(cold_mask)[0]
    seed_users = np.empty(len(cold_items), np.int64)
    cold_cl = icl[cold_items]
    for c in range(k_clusters):
        m = cold_cl == c
        if not m.any():
            continue
        pool = users_by_cl[c]
        if not len(pool):
            pool = np.arange(n_users)
        seed_users[m] = pool[rng.randint(0, len(pool), int(m.sum()))]

    test_users = np.unique(test[0])
    cold_by_cl = [cold_items[cold_cl == c] for c in range(k_clusters)]
    t_items = np.full(len(test_users), -1, np.int64)
    for c in range(k_clusters):
        m = ucl[test_users] == c
        pool = cold_by_cl[c]
        if len(pool) and m.any():
            t_items[m] = pool[rng.randint(0, len(pool), int(m.sum()))]
    keep = t_items >= 0
    tu, ti = test_users[keep], t_items[keep]
    # drop a held-out cold item that is the very item the user seeded
    seeds = set(zip(seed_users.tolist(), cold_items.tolist()))
    coll = np.fromiter(((u, i) in seeds for u, i in zip(tu.tolist(),
                                                        ti.tolist())),
                       bool, count=len(tu))
    tu, ti = tu[~coll], ti[~coll]
    train = (np.concatenate([train[0], seed_users]),
             np.concatenate([train[1], cold_items]))
    test = (np.concatenate([test[0], tu]), np.concatenate([test[1], ti]))
    return train, test


def _cumcount_where(users_sorted, flag, starts):
    """Rank of each flagged row among its user's flagged rows (rows sorted
    by user; unflagged rows get a large rank)."""
    csum = np.cumsum(flag)
    base = csum - np.where(flag, 1, 0)
    per_user_base = csum[starts] - flag[starts]
    rank = base - per_user_base[users_sorted]
    return np.where(flag, rank, 1 << 30)


def _legacy(rng, n_users, n_items, ucl, items_by_cl):
    """The per-user loop, ``groupby('user_id').filter(len >= 3)`` and
    ``groupby('user_id').sample(n=2, random_state=rng)``."""
    all_items = np.arange(n_items)
    rows_u, rows_i = [], []
    for u in range(n_users):
        own = items_by_cl[ucl[u]]
        n_inter = rng.randint(8, 18)
        n_own = max(int(n_inter * 0.85), 1)
        chosen = list(rng.choice(own, size=min(n_own, len(own)),
                                 replace=False))
        extra = n_inter - len(chosen)
        if extra > 0:
            chosen += list(rng.choice(all_items, size=min(extra, n_items),
                                      replace=False))
        # a set's iteration order, as the JAX tool writes its rows
        for i in set(chosen):
            rows_u.append(u)
            rows_i.append(int(i))
    u = np.asarray(rows_u, np.int64)
    i = np.asarray(rows_i, np.int64)
    counts = np.bincount(u, minlength=n_users)
    keep = counts[u] >= 3
    u, i = u[keep], i[keep]
    # the groups in the string order of 'u<N>', each group's rows in
    # table order
    users = sorted(np.unique(u).tolist(), key=lambda x: f'u{x}')
    order = np.argsort(u, kind='stable')
    starts = np.searchsorted(u[order], np.arange(n_users + 1))
    picked = []
    for user in users:
        grp = order[starts[user]:starts[user + 1]]
        picked.append(grp[rng.choice(len(grp), size=2, replace=False)])
    test_rows = np.concatenate(picked) if picked else np.zeros(0, np.int64)
    in_test = np.zeros(len(u), bool)
    in_test[test_rows] = True
    return (u[~in_test], i[~in_test]), (u[test_rows], i[test_rows])


def _vectorised(rng, n_users, n_items, k_clusters, ucl, items_by_cl):
    """85% own-cluster / 15% uniform, 8-17 draws per user with
    replacement, pair dedup, 2 random pairs per user held out (users with
    3 pairs or more)."""
    n_inter = rng.randint(8, 18, n_users)
    n_own = np.maximum((n_inter * 0.85).astype(int), 1)
    n_ext = n_inter - n_own
    u_own = np.repeat(np.arange(n_users), n_own)
    i_own = np.empty(len(u_own), np.int64)
    cl_of_draw = ucl[u_own]
    for c in range(k_clusters):
        m = cl_of_draw == c
        pool = items_by_cl[c]
        if len(pool):
            i_own[m] = pool[rng.randint(0, len(pool), int(m.sum()))]
        else:
            i_own[m] = rng.randint(0, n_items, int(m.sum()))
    u_ext = np.repeat(np.arange(n_users), n_ext)
    i_ext = rng.randint(0, n_items, len(u_ext))
    pairs = np.unique(np.stack([np.concatenate([u_own, u_ext]),
                                np.concatenate([i_own, i_ext])], 1), axis=0)
    perm = rng.permutation(len(pairs))
    p = pairs[perm][np.argsort(pairs[perm][:, 0], kind='stable')]
    starts = np.searchsorted(p[:, 0], np.arange(n_users))
    counts = np.diff(np.append(starts, len(p)))
    rank = np.arange(len(p)) - starts[p[:, 0]]
    is_test = (rank < 2) & (counts[p[:, 0]] >= 3)
    return ((p[~is_test, 0], p[~is_test, 1]),
            (p[is_test, 0], p[is_test, 1]))


def _ids(prefix: str, arr) -> list[str]:
    return [f'{prefix}{x}' for x in np.asarray(arr).tolist()]


def generate(out_dir: str, n_users: int = 5000, n_items: int = 2000,
             k_clusters: int = 20, seed: int = 0, sharp: bool = False,
             cold: float = 0.0) -> dict[str, int]:
    """Write the dataset into ``out_dir`` (the JAX tool's ``generate``:
    ``sharp`` the high-signal instrument of ~50-item clusters, ``cold >
    0`` with it the cold-start text instrument, whose cold item ids go to
    ``cold_items.txt``).  Returns the row and cold-item counts."""
    rng = np.random.RandomState(seed)
    if sharp:
        k_clusters = max(20, n_items // 50)
    ucl = rng.randint(0, k_clusters, n_users)
    icl = rng.randint(0, k_clusters, n_items)
    items_by_cl = [np.where(icl == c)[0] for c in range(k_clusters)]

    cold_mask = np.zeros(n_items, bool)
    if sharp and cold > 0:
        draw_pools, cold_mask = _split_cold(rng, items_by_cl, cold)
        if cold_mask.shape[0] < n_items:  # trailing clusters may be empty
            cold_mask = np.pad(cold_mask, (0, n_items - cold_mask.shape[0]))
    else:
        draw_pools = items_by_cl

    if sharp:
        ext_pool = np.where(~cold_mask)[0] if cold_mask.any() else None
        train, test = _generate_sharp(rng, n_users, n_items, k_clusters,
                                      ucl, draw_pools, ext_pool=ext_pool)
        if cold > 0:
            train, test = _add_cold(rng, train, test, ucl, icl, cold_mask,
                                    k_clusters, n_users)
    elif n_users <= LOOP_USERS:
        train, test = _legacy(rng, n_users, n_items, ucl, items_by_cl)
    else:
        train, test = _vectorised(rng, n_users, n_items, k_clusters, ucl,
                                  items_by_cl)
    keep = np.isin(test[1], train[1]) & np.isin(test[0], train[0])
    test = (test[0][keep], test[1][keep])

    os.makedirs(out_dir, exist_ok=True)
    train_cols = [_ids('u', train[0]), _ids('i', train[1])]
    for name, cols in (('train.tsv', train_cols),
                       ('test.tsv', [_ids('u', test[0]),
                                     _ids('i', test[1])])):
        write_table(os.path.join(out_dir, name), ['user_id', 'asin'], cols)

    icl_s = icl.astype(str).tolist()
    if sharp and cold > 0:
        style = rng.randint(0, 4, n_items).astype(str).tolist()
        title = [f'category {c} product line {s}'
                 for c, s in zip(icl_s, style)]
        desc = [f'a category {c} style {s} item for enthusiasts'
                for c, s in zip(icl_s, style)]
        with open(os.path.join(out_dir, 'cold_items.txt'), 'w') as f:
            f.write('\n'.join(f'i{i}' for i in np.where(cold_mask)[0]))
    else:
        title = [f'product {i} of category {icl_s[i]} series'
                 for i in range(n_items)]
        desc = [f'a category {icl_s[i]} item with features {i % 7} and '
                f'{i % 13} for enthusiasts' for i in range(n_items)]
    write_table(os.path.join(out_dir, 'meta_synced.tsv'),
                ['asin', 'title', 'description'],
                [_ids('i', np.arange(n_items)), title, desc])

    users_s, items = train_cols[0], train[1].tolist()
    cat = [icl_s[i] for i in items]
    if sharp and cold > 0:
        v = rng.randint(0, 6, len(items)).astype(str).tolist()
        review = [f'review of a category {c} product variant {x}'
                  for c, x in zip(cat, v)]
    elif n_users <= LOOP_USERS:
        review = [f'user {u} review of category {c} product {i} quality '
                  f'{rng.randint(1, 5)}'
                  for u, c, i in zip(users_s, cat, items)]
    else:
        q = rng.randint(1, 5, len(items)).astype(str).tolist()
        review = [f'user {u} review of category {c} product {i} quality '
                  f'{x}' for u, c, i, x in zip(users_s, cat, items, q)]
    t = rng.randint(1.5e9, 1.6e9, len(items))
    rating = rng.randint(1, 6, len(items))
    write_table(os.path.join(out_dir, 'reviews_text.tsv'),
                ['user_id', 'asin', 'review', 'time', 'rating'],
                [users_s, train_cols[1], review, t.astype(str).tolist(),
                 rating.astype(str).tolist()])
    cold_n = int(cold_mask.sum())
    print(f'{out_dir}: {len(items)} train, {len(test[0])} test, '
          f'{n_users} users, {n_items} items'
          + (f', {cold_n} cold items' if cold_n else ''))
    return {'train': len(items), 'test': len(test[0]), 'cold': cold_n}


def parse_argv(args: list[str]) -> dict:
    """The JAX tool's command line: ``<out_dir> [n_users] [n_items]
    [seed]`` with ``--sharp`` and ``--cold F`` (or ``--cold=F``)
    anywhere."""
    sharp, cold, argv = False, 0.0, []
    i = 0
    while i < len(args):
        a = args[i]
        if a == '--sharp':
            sharp = True
        elif a.startswith('--cold'):
            cold = float(a.split('=', 1)[1]) if '=' in a \
                else float(args[i + 1])
            i += 0 if '=' in a else 1
        else:
            argv.append(a)
        i += 1
    return {'out_dir': argv[0] if len(argv) > 0 else 'data/synthetic',
            'n_users': int(argv[1]) if len(argv) > 1 else 5000,
            'n_items': int(argv[2]) if len(argv) > 2 else 2000,
            'seed': int(argv[3]) if len(argv) > 3 else 0,
            'sharp': sharp, 'cold': cold}


def main(argv: list[str] | None = None) -> dict[str, int]:
    return generate(**parse_argv(sys.argv[1:] if argv is None else argv))


if __name__ == '__main__':
    main()
