"""The port's stratified split (``data/split.py``) against scikit-learn.

``stratified_split(y, train_size, seed)`` must return the train and test
index arrays of ``sklearn.model_selection.train_test_split(range(n),
stratify=y, train_size=train_size, random_state=seed)`` exactly, order
included: the JAX package writes its split TSVs in that order.  Where
scikit-learn refuses a split (a class under 2 rows, fewer train or test
rows than classes), the port refuses it too.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.model_selection import train_test_split

from textgcn_tpu_torch.data.split import (approximate_mode, keep_frequent,
                                          stratified_split)


def _labels(n_classes: int, lo: int, hi: int, seed: int) -> list[str]:
    """Shuffled user-like ids, each class ``lo``-``hi`` rows, ids that sort
    differently as strings and as numbers."""
    rng = np.random.RandomState(seed * 1009 + n_classes)
    counts = rng.randint(lo, hi + 1, n_classes)
    y = np.repeat([f'u{c}' for c in rng.permutation(n_classes)], counts)
    rng.shuffle(y)
    return y.tolist()


def _check(y, train_size, seed):
    try:
        want = train_test_split(np.arange(len(y)), stratify=y,
                                train_size=train_size, random_state=seed)
    except ValueError:
        with pytest.raises(ValueError):
            stratified_split(y, train_size, seed)
        return False
    got = stratified_split(y, train_size, seed)
    for w, g in zip(want, got):
        assert g.dtype.kind == 'i'
        np.testing.assert_array_equal(g, w)
    return True


@pytest.mark.parametrize('seed', [0, 3, 42])
@pytest.mark.parametrize('train_size', [0.8, 0.7])
@pytest.mark.parametrize('counts', [(3, 3), (3, 40), (40, 40)],
                         ids=['3', '3-40', '40'])
@pytest.mark.parametrize('n_classes', [1, 2, 7, 60, 500])
def test_split_equals_sklearn(n_classes, counts, train_size, seed):
    _check(_labels(n_classes, *counts, seed), train_size, seed)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(3, 40), min_size=1, max_size=120),
       st.sampled_from([0.8, 0.7, 0.5]), st.integers(0, 2**31 - 1))
def test_split_equals_sklearn_on_drawn_counts(counts, train_size, seed):
    y = np.repeat([f'user{c}' for c in range(len(counts))], counts)
    np.random.RandomState(seed).shuffle(y)
    _check(y.tolist(), train_size, seed)


def test_refusals_match_sklearn():
    assert not _check(['a', 'a', 'b'], 0.8, 0)          # a class of one
    assert not _check(['a'] * 3 + ['b'] * 3, 0.95, 0)   # test rows < classes
    with pytest.raises(ValueError):
        stratified_split(['a'] * 5, 1.0, 0)


def test_a_random_state_is_drawn_from_in_place():
    y = _labels(20, 3, 9, 1)
    rng_a, rng_b = np.random.RandomState(4), np.random.RandomState(4)
    want = train_test_split(np.arange(len(y)), stratify=y, train_size=0.8,
                            random_state=rng_a)
    got = stratified_split(y, 0.8, rng_b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert rng_a.randint(1 << 30) == rng_b.randint(1 << 30)


@pytest.mark.parametrize('seed', [0, 3, 42])
def test_approximate_mode_equals_sklearn(seed):
    from sklearn.utils.extmath import _approximate_mode
    counts = np.random.RandomState(seed).randint(1, 9, 50)
    for n in (7, 50, int(counts.sum()) // 2):
        want = _approximate_mode(counts, n, np.random.RandomState(seed))
        got = approximate_mode(counts, n, np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)


def test_keep_frequent_is_the_groupby_size_filter():
    import pandas as pd
    keys = ['a', 'b', None, 'a', 'c', 'a', 'b', None, None, 'b', 'c']
    s = pd.Series(keys, dtype=object)
    want = (s.groupby(s).transform('size') >= 3).to_numpy()
    np.testing.assert_array_equal(keep_frequent(keys), want)
