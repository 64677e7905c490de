"""scikit-learn's stratified ``train_test_split``, drawn exactly.

The JAX package splits with ``sklearn.model_selection.train_test_split(
rows, stratify=y, train_size=train_size, random_state=seed)``
(``data/core.py:116-128``, ``data/preprocess.py:154-163``).  The GPU
machine has no scikit-learn, so ``stratified_split`` repeats its draws on
``np.random.RandomState(seed)`` in its order (scikit-learn 1.9):

1. ``_validate_shuffle_split``: ``n_train = floor(train_size * n)`` for a
   float ``train_size``, ``n_test = n - n_train``;
2. ``StratifiedShuffleSplit._iter_indices``: the classes of
   ``np.unique(y, return_inverse=True)``, each class's rows in a stable
   sort, ``_approximate_mode`` for the train counts and again for the
   test counts of the rows left (its ties broken by ``rng.choice``), one
   ``rng.permutation`` per class, then one of the train rows and one of
   the test rows.

It returns the two index arrays in the order scikit-learn returns them,
which is the order of the rows ``_safe_indexing`` (``.iloc``) takes.
"""

from __future__ import annotations

import math
import numbers

import numpy as np


def _sizes(n_samples: int, train_size) -> tuple[int, int]:
    """``_validate_shuffle_split(n, None, train_size, 0.25)`` and the
    integer check that ``StratifiedShuffleSplit`` makes again."""
    if isinstance(train_size, numbers.Integral):
        if not 0 < train_size < n_samples:
            raise ValueError(f'train_size={train_size} should be either '
                             'positive and smaller than the number of '
                             f'samples {n_samples} or a float in the (0, '
                             '1) range')
        n_train = int(train_size)
    else:
        if not 0 < train_size < 1:
            raise ValueError(f'train_size={train_size} should be either '
                             'positive and smaller than the number of '
                             f'samples {n_samples} or a float in the (0, '
                             '1) range')
        n_train = math.floor(train_size * n_samples)
    n_test = n_samples - n_train
    if n_train == 0:
        raise ValueError(f'With n_samples={n_samples}, test_size=None and '
                         f'train_size={train_size}, the resulting train set '
                         'will be empty. Adjust any of the aforementioned '
                         'parameters.')
    if n_test <= 0:
        raise ValueError(f'test_size={n_test} should be either positive and '
                         'smaller than the number of samples '
                         f'{n_samples} or a float in the (0, 1) range')
    return n_train, n_test


def approximate_mode(class_counts: np.ndarray, n_draws: int,
                     rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's ``utils.extmath._approximate_mode``: the floored
    proportional share of ``n_draws`` per class, the rest handed out by
    largest remainder, ties drawn with ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(y, train_size=0.8, seed=None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """``(train, test)`` row indices of ``train_test_split(range(len(y)),
    stratify=y, train_size=train_size, random_state=seed)``; ``seed`` an
    int or a ``RandomState``."""
    y = np.asarray(y)
    n_train, n_test = _sizes(len(y), train_size)
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError('The least populated classes in y have only 1 '
                         'member, which is too few. The minimum number of '
                         'groups for any class cannot be less than 2. '
                         'Classes with too few members are: '
                         f'{classes[class_counts < 2].tolist()}')
    if n_train < n_classes:
        raise ValueError(f'The train_size = {n_train} should be greater or '
                         f'equal to the number of classes = {n_classes}')
    if n_test < n_classes:
        raise ValueError(f'The test_size = {n_test} should be greater or '
                         f'equal to the number of classes = {n_classes}')
    class_indices = np.split(np.argsort(y_indices, kind='stable'),
                             np.cumsum(class_counts)[:-1])
    if seed is None:
        rng = np.random.mtrand._rand
    elif isinstance(seed, np.random.RandomState):
        rng = seed
    else:
        rng = np.random.RandomState(seed)
    n_i = approximate_mode(class_counts, n_train, rng)
    t_i = approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        permutation = rng.permutation(class_counts[i])
        perm_indices = class_indices[i].take(permutation, mode='clip')
        train.extend(perm_indices[:n_i[i]])
        test.extend(perm_indices[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def keep_frequent(keys, min_count: int = 3) -> np.ndarray:
    """Row mask of ``df[df.groupby(col)[col].transform('size') >=
    min_count]``: the rows whose key occurs at least ``min_count`` times
    (a missing key, ``None``, never does)."""
    counts: dict = {}
    for k in keys:
        if k is not None:
            counts[k] = counts.get(k, 0) + 1
    return np.array([k is not None and counts[k] >= min_count
                     for k in keys], dtype=bool)
