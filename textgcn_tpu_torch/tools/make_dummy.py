"""Write the checked-in fixture ``data/dummy/`` without pandas.

Counterpart of the JAX package's ``tools/make_dummy.py``: the same four
files, byte for byte -- ``train.tsv`` and ``test.tsv`` (12 users, 4-7
distinct items each out of 10, one shuffled item a user to test, test
items without a train row dropped), ``meta_synced.tsv`` (a title and a
description an item) and ``reviews_text.tsv`` (one review a train row,
times and ratings drawn after) -- from the one ``RandomState(7)`` whose
draws the JAX tool makes through pandas: ``DataFrame.groupby('user_id')``
visits users in string order, and ``sample(frac=1, random_state=rng)`` is
``rng.choice(n, size=n, replace=False)``.

Usage::

    python -m textgcn_tpu_torch.tools.make_dummy [OUT]

``OUT`` defaults to the repository's ``data/dummy``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..data.tsv import write_rows

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'data', 'dummy')

N_USERS = 12
N_ITEMS = 10
SEED = 7


def main(argv=None) -> dict[str, int]:
    argv = sys.argv[1:] if argv is None else list(argv)
    out = argv[0] if argv else OUT
    rng = np.random.RandomState(SEED)
    os.makedirs(out, exist_ok=True)

    rows: dict[str, list[tuple[str, str]]] = {}
    for u in range(N_USERS):
        n_inter = rng.randint(4, 8)
        items = rng.choice(N_ITEMS, size=n_inter, replace=False)
        rows[f'user_{u}'] = [(f'user_{u}', f'asin_{i}') for i in items]

    # per-user split in groupby's (string) order: the first item of a
    # shuffle to test, the rest to train
    train, test = [], []
    for user in sorted(rows):
        group = rows[user]
        order = rng.choice(len(group), size=len(group), replace=False)
        shuffled = [group[k] for k in order]
        test.append(shuffled[0])
        train.extend(shuffled[1:])
    train.sort()
    test.sort()
    # drop test items that are not in train
    train_items = {a for _, a in train}
    test = [r for r in test if r[1] in train_items]
    write_rows(os.path.join(out, 'train.tsv'), ['user_id', 'asin'], train)
    write_rows(os.path.join(out, 'test.tsv'), ['user_id', 'asin'], test)

    # meta: title + description per item
    write_rows(os.path.join(out, 'meta_synced.tsv'),
               ['asin', 'title', 'description'],
               [(f'asin_{i}', f'item number {i} title words',
                 f'a longer description of item {i} with detail {i * 3}')
                for i in range(N_ITEMS)])

    # reviews: one per train interaction with synthetic time stamps
    times = rng.randint(1_500_000_000, 1_600_000_000, size=len(train))
    ratings = rng.randint(1, 6, size=len(train))
    write_rows(os.path.join(out, 'reviews_text.tsv'),
               ['user_id', 'asin', 'review', 'time', 'rating'],
               [(u, a, f'review text from {u} about {a} opinion {j}',
                 str(t), str(r))
                for j, ((u, a), t, r) in enumerate(zip(train, times,
                                                       ratings))])
    print(f'wrote dummy fixture: {len(train)} train, {len(test)} test, '
          f'{N_USERS} users, {N_ITEMS} items')
    return {'train': len(train), 'test': len(test)}


if __name__ == '__main__':
    main()
