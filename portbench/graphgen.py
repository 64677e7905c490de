"""The cells' interaction graph: one Chung-Lu draw per configuration.

Each pair's user is drawn with probability proportional to ``rank ** -s``
over the users, its item likewise over the items, and pairs drawn twice
are drawn again until the configuration's count of distinct pairs is met.
Ranks are dealt to ids by a permutation from the same draw, so the
popular rows do not sit together.  Then each user's pairs are split
80/20 at random into train and test, as the reference TextGCN's
stratified split does (``round(0.2 * degree)`` test pairs a user, so
every user keeps a train pair).

The draw takes the configuration's ``graph_seed``, not the run's seed:
the graph is the configuration's dataset, the same in every run, as a
real dataset is.  The run's seed draws the tables, the batches, the
dropout salts and the requests.  (With a graph drawn from each run's
seed, the rates of one seed agreed across runs but those of different
seeds did not: where the heaviest rows fall decides K1's tail.)

The pairs are written as ``train.tsv`` and ``test.tsv`` (``user_id``,
``asin``; ids ``u%06d`` and ``i%06d``, so string order is id order) under
``portbench/.cache/<dataset key>/``, where later runs find them.
Imports numpy only.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         '.cache')
ID_DIGITS = 6
HEADER = b'user_id\tasin\n'


@dataclass
class Interactions:
    """The generated pairs, in generated ids (``u``: 0..n_users-1,
    ``i``: 0..n_items-1), each side sorted by (user, item)."""
    train_user: np.ndarray
    train_item: np.ndarray
    test_user: np.ndarray
    test_item: np.ndarray
    n_users: int
    n_items: int


def rank_cdf(n: int, s: float) -> np.ndarray:
    """Cumulative probabilities of ranks 1..n under ``rank ** -s``."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def draw_pairs(rng: np.random.Generator, n_users: int, n_items: int,
               n_pairs: int, s: float) -> tuple[np.ndarray, np.ndarray]:
    """``n_pairs`` distinct (user rank, item rank) pairs, ranks from 0,
    sorted by key ``user * n_items + item``."""
    if n_pairs > n_users * n_items // 2:
        raise ValueError(f'{n_pairs} pairs is too dense for '
                         f'{n_users} x {n_items}')
    cdf_u, cdf_i = rank_cdf(n_users, s), rank_cdf(n_items, s)
    keys = np.zeros(0, np.int64)
    while len(keys) < n_pairs:
        need = n_pairs - len(keys)
        u = np.searchsorted(cdf_u, rng.random(need), side='right')
        i = np.searchsorted(cdf_i, rng.random(need), side='right')
        u = np.minimum(u, n_users - 1)
        i = np.minimum(i, n_items - 1)
        keys = np.unique(np.concatenate([keys, u * n_items + i]))
    return keys // n_items, keys % n_items


def split_per_user(rng: np.random.Generator, user: np.ndarray,
                   test_share: float) -> np.ndarray:
    """A bool mask of the test pairs: ``round(test_share * degree)`` of
    each user's pairs, drawn at random (``user`` sorted)."""
    n = len(user)
    order = np.lexsort((rng.random(n), user))
    deg = np.bincount(user)
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    rank = np.arange(n) - starts[user[order]]
    n_test = np.floor(test_share * deg + 0.5).astype(np.int64)
    n_test = np.minimum(n_test, deg - 1)
    test = np.zeros(n, bool)
    test[order] = rank < n_test[user[order]]
    return test


def generate(dataset: dict) -> Interactions:
    """The configuration's ``dataset``, drawn from its ``graph_seed``."""
    rng = np.random.default_rng([int(dataset['graph_seed']), 0x6C6763])
    n_users, n_items = dataset['n_users'], dataset['n_items']
    s = dataset['popularity_exponent']
    u_rank, i_rank = draw_pairs(rng, n_users, n_items,
                                dataset['n_interactions'], s)
    user = rng.permutation(n_users)[u_rank]
    item = rng.permutation(n_items)[i_rank]
    order = np.lexsort((item, user))
    user, item = user[order], item[order]
    test = split_per_user(rng, user, 1.0 - dataset['train_share'])
    return Interactions(user[~test], item[~test], user[test], item[test],
                        n_users, n_items)


def degree_stats(inter: Interactions) -> dict:
    """Realised degrees over all pairs: the heaviest and mean user and
    item, and the share of pairs held by the top 1% of items."""
    user = np.concatenate([inter.train_user, inter.test_user])
    item = np.concatenate([inter.train_item, inter.test_item])
    du = np.bincount(user, minlength=inter.n_users)
    di = np.bincount(item, minlength=inter.n_items)
    top = np.sort(di)[::-1][:max(1, inter.n_items // 100)]
    tu = np.bincount(inter.train_user, minlength=inter.n_users)
    return {'pairs': int(len(user)), 'train_pairs': int(len(inter.train_user)),
            'max_user_degree': int(du.max()), 'mean_user_degree':
            float(du.mean()), 'max_item_degree': int(di.max()),
            'mean_item_degree': float(di.mean()),
            'min_user_degree': int(du.min()), 'min_item_degree':
            int(di.min()), 'max_user_train_degree': int(tu.max()),
            'top1pct_item_share': float(top.sum() / len(user))}


def tsv_bytes(user: np.ndarray, item: np.ndarray) -> bytes:
    """The rows ``u%06d<TAB>i%06d<LF>`` after the header, built as one
    byte array."""
    n = len(user)
    rows = np.empty((n, 2 * ID_DIGITS + 4), np.uint8)
    rows[:, 0] = ord('u')
    rows[:, ID_DIGITS + 1] = ord('\t')
    rows[:, ID_DIGITS + 2] = ord('i')
    rows[:, -1] = ord('\n')
    for k in range(ID_DIGITS):
        p = 10 ** (ID_DIGITS - 1 - k)
        rows[:, 1 + k] = ord('0') + (user // p) % 10
        rows[:, ID_DIGITS + 3 + k] = ord('0') + (item // p) % 10
    return HEADER + rows.tobytes()


def parse_tsv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """``(user, item)`` generated ids of a file ``tsv_bytes`` wrote."""
    with open(path, 'rb') as f:
        raw = f.read()[len(HEADER):]
    rows = np.frombuffer(raw, np.uint8).reshape(-1, 2 * ID_DIGITS + 4)
    digits = rows.astype(np.int64) - ord('0')
    pw = 10 ** np.arange(ID_DIGITS - 1, -1, -1)
    return (digits[:, 1:1 + ID_DIGITS] @ pw,
            digits[:, ID_DIGITS + 3:2 * ID_DIGITS + 3] @ pw)


def dataset_key(dataset: dict) -> str:
    blob = json.dumps(dataset, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def materialise(dataset: dict, cache_dir: str = CACHE_DIR):
    """``(folder, interactions, seconds)``: the folder holding
    ``train.tsv``/``test.tsv`` of ``dataset`` (written unless the cache
    has it), the pairs, and the seconds spent making and writing them (0
    when cached: the files are read back)."""
    folder = os.path.join(cache_dir, dataset_key(dataset))
    train, test = (os.path.join(folder, f) for f in ('train.tsv',
                                                      'test.tsv'))
    if os.path.exists(train) and os.path.exists(test):
        tu, ti = parse_tsv(train)
        eu, ei = parse_tsv(test)
        return folder, Interactions(tu, ti, eu, ei, dataset['n_users'],
                                    dataset['n_items']), 0.0
    t0 = time.perf_counter()
    inter = generate(dataset)
    os.makedirs(folder, exist_ok=True)
    for path, (u, i) in ((train, (inter.train_user, inter.train_item)),
                         (test, (inter.test_user, inter.test_item))):
        tmp = f'{path}.{os.getpid()}.tmp'
        with open(tmp, 'wb') as f:
            f.write(tsv_bytes(u, i))
        os.replace(tmp, path)
    return folder, inter, time.perf_counter() - t0
