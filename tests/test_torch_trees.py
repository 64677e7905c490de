"""The port's tree ensembles (``textgcn_tpu_torch/ops/trees.py``) against
scikit-learn and the JAX package's scorer, on the CPU.

* The scorer: an ensemble that scikit-learn fits, carried across with
  ``weights.forest_from_estimator``, scores bit for bit as the JAX
  package's ``forest_predict`` of the same estimator, and within 1e-6 of
  scikit-learn's ``predict`` (float32 sums of float64 leaf values).
* The fit: ``fit_gbrt`` against ``GradientBoostingRegressor(
  n_estimators=10, max_depth=3)`` on inputs without tied splits (checked
  first: fits under several ``random_state`` give the same trees, since
  scikit-learn draws its feature order at random and keeps either of two
  equal splits), in one batch and warm-started over 3: equal node arrays,
  values within 1e-12 relative, the same ``init_``, importances within
  1e-9, impurities 1e-12; the raw predictions of a carried fit bit for
  bit.
"""

import numpy as np
import pytest
import torch
from sklearn.ensemble import (GradientBoostingRegressor,
                              RandomForestRegressor)
from sklearn.tree import DecisionTreeRegressor

from textgcn_tpu.ops import trees as jax_trees
from textgcn_tpu_torch.ops import retrieval, trees
from textgcn_tpu_torch.weights import forest_from_estimator

STRUCTURE = ('children_left', 'children_right', 'feature', 'threshold',
             'n_node_samples')


def _data(n=4000, f=5, seed=0):
    """Random float32 rows and {0, 1} labels (a noisy logistic rule)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    p = 1 / (1 + np.exp(-(2 * x[:, 0] - x[:, 1] + 0.3 * x[:, 2] * x[:, 3])))
    return x, (rng.rand(n) < p).astype(np.float32)


def _threshold_data(n, seed, f=5):
    """Uniform float32 rows labelled by a noise-free linear rule: warm
    starts on it keep the fit's nodes large (no tied splits)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    return x, (x[:, 0] + 0.5 * x[:, 1] > 0.8).astype(np.float32)


def _gbr(random_state=0, **kw):
    return GradientBoostingRegressor(**{'n_estimators': 10, 'max_depth': 3,
                                        'random_state': random_state, **kw})


def _sklearn_fit(batches, random_state=0):
    est = _gbr(random_state, warm_start=True)
    for b, (x, y) in enumerate(batches):
        if b:
            est.set_params(n_estimators=est.n_estimators + 10)
        est.fit(x, y)
    return est


def _port_fit(batches):
    state = None
    for x, y in batches:
        state = trees.fit_gbrt(torch.from_numpy(x), torch.from_numpy(y),
                               state)
    return state


def _estimator_trees(est):
    return [e.tree_ for e in np.asarray(est.estimators_).reshape(-1)]


def _same_structure(a, b) -> bool:
    return all(np.array_equal(np.asarray(getattr(a, k)),
                              np.asarray(getattr(b, k))) for k in STRUCTURE)


def _tie_free(batches, n_states=4):
    """True when scikit-learn's fit does not depend on its random feature
    order: then no split had an equal rival on another feature."""
    fits = [_estimator_trees(_sklearn_fit(batches, rs))
            for rs in range(n_states)]
    return all(_same_structure(a, b) for other in fits[1:]
               for a, b in zip(fits[0], other))


def _assert_same_ensemble(est, state):
    sk = _estimator_trees(est)
    assert len(sk) == len(state.trees)
    for i, (a, b) in enumerate(zip(sk, state.trees)):
        for k in STRUCTURE:
            np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                          getattr(b, k), err_msg=f'tree {i} '
                                          f'{k}')
        want = a.value.reshape(-1)
        np.testing.assert_allclose(b.value, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=f'tree {i} value')
        # a mean of squares less a squared mean: absolute rounding
        np.testing.assert_allclose(b.impurity, a.impurity, rtol=0,
                                   atol=1e-12, err_msg=f'tree {i} impurity')
    assert state.init == float(np.asarray(est.init_.constant_).reshape(()))
    assert state.learning_rate == est.learning_rate
    np.testing.assert_allclose(state.feature_importances(),
                               est.feature_importances_, rtol=0, atol=1e-9)


# --- the scorer --------------------------------------------------------------

def _fitted(case):
    if case == 'gbrt':
        x, y = _data()
        return _gbr().fit(x, y), _data(2000, seed=1)[0]
    if case == 'warm_started_gbrt':
        x, y = _data()
        est = _gbr(warm_start=True, n_estimators=5).fit(x[:2000], y[:2000])
        est.set_params(n_estimators=10)
        return est.fit(x[2000:], y[2000:]), x
    if case == 'decision_tree':
        x, y = _data(1000)
        return DecisionTreeRegressor(max_depth=4, random_state=0).fit(x, y), x
    if case == 'single_leaf':
        x = np.random.RandomState(0).randn(50, 4).astype(np.float32)
        return DecisionTreeRegressor(max_depth=2).fit(
            x, np.full(50, 3.25, np.float32)), x
    # rows lying exactly on the (float32-rounded) split thresholds
    x, y = _data(500, f=4)
    est = DecisionTreeRegressor(max_depth=3, random_state=0).fit(x, y)
    t = est.tree_
    thr = t.threshold[t.children_left != -1]
    probes = np.repeat(thr.astype(np.float32)[:, None], x.shape[1], axis=1)
    return est, probes


@pytest.mark.parametrize('case', ['gbrt', 'warm_started_gbrt',
                                  'decision_tree', 'single_leaf',
                                  'threshold_rows'])
def test_forest_predict_matches_jax_bitwise_and_sklearn(case):
    est, xq = _fitted(case)
    state = forest_from_estimator(est)
    got = trees.forest_predict(trees.compile_forest(state),
                               torch.from_numpy(xq)).numpy()
    want_jax = np.asarray(jax_trees.forest_predict(
        jax_trees.compile_forest(est, xq.shape[1]), xq))
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_allclose(got, est.predict(xq), rtol=1e-6, atol=1e-6)


def test_compiled_forest_operands_equal_jax():
    est, _ = _fitted('warm_started_gbrt')
    port = trees.compile_forest(forest_from_estimator(est))
    jax_f = jax_trees.compile_forest(est, 5)
    for name in ('A', 'B', 'C', 'E', 'V', 'base'):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jax_f, name)))
    assert port.n_features == 5


def test_forest_from_estimator_refuses_what_it_cannot_carry():
    x, y = _data(300)
    exotic = GradientBoostingRegressor(
        n_estimators=2, init=DecisionTreeRegressor(max_depth=1)).fit(x, y)
    with pytest.raises(ValueError, match='init estimator'):
        forest_from_estimator(exotic)
    forest = RandomForestRegressor(n_estimators=2, max_depth=2).fit(x, y)
    with pytest.raises(ValueError, match='learning_rate'):
        forest_from_estimator(forest)
    with pytest.raises(TypeError, match='no fitted trees'):
        forest_from_estimator(object())
    empty = _gbr()
    empty.estimators_ = np.empty((0, 1), object)
    with pytest.raises(ValueError, match='no trees'):
        forest_from_estimator(empty)
    with pytest.raises(ValueError, match='no trees'):
        trees.compile_forest(trees.GBRTState([], 0.0, 0.1, 5))
    zero = GradientBoostingRegressor(n_estimators=2, init='zero').fit(x, y)
    state = forest_from_estimator(zero)
    assert state.init == 0.0
    got = trees.forest_predict(trees.compile_forest(state),
                               torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, zero.predict(x), rtol=1e-6, atol=1e-6)


# --- the fit -----------------------------------------------------------------

@pytest.mark.parametrize('n_batches, seed', [(1, 0), (1, 3), (3, 0)])
def test_fit_gbrt_matches_sklearn(n_batches, seed):
    n = 2000
    x, y = _threshold_data(n * n_batches, seed)
    batches = [(x[i * n:(i + 1) * n], y[i * n:(i + 1) * n])
               for i in range(n_batches)]
    assert _tie_free(batches), 'the inputs have tied splits'
    est = _sklearn_fit(batches)
    state = _port_fit(batches)
    _assert_same_ensemble(est, state)
    # the warm start's residuals start from these: bit for bit from the
    # same leaf values
    carried = forest_from_estimator(est)
    for xb, _ in batches:
        want = est._raw_predict(xb).reshape(-1)
        xt = torch.from_numpy(xb)
        np.testing.assert_array_equal(
            trees.raw_predict(carried, xt).numpy(), want)
        np.testing.assert_allclose(trees.raw_predict(state, xt).numpy(),
                                   want, rtol=1e-12, atol=0)


def _constant_feature():
    x, y = _threshold_data(1500, 2)
    x[:, 2] = np.float32(0.25)
    return x, y


def _close_values():
    """Feature 0 takes 4 values one float32 ulp apart around 1.0 (gaps
    under 1e-7 only in float32 arithmetic: 1 + 1e-7 rounds up to the next
    float32) and feature 4 values 3e-8 apart: no candidate splits there,
    though the labels follow them."""
    rng = np.random.RandomState(2)
    n = 1500
    x = rng.rand(n, 5).astype(np.float32)
    step = rng.randint(0, 4, n)
    x[:, 0] = np.float32(1.0) + step * np.spacing(np.float32(1.0))
    x[:, 4] = (step * 3e-8).astype(np.float32)
    y = ((step >= 2) ^ (x[:, 1] > 0.7)).astype(np.float32)
    return x, y


def _zero_labels():
    x, _ = _threshold_data(1000, 4)
    return x, np.zeros(1000, np.float32)


@pytest.mark.parametrize('make', [_constant_feature, _close_values,
                                  _zero_labels],
                         ids=['constant_feature', 'values_within_1e-7',
                              'all_zero_labels'])
def test_fit_gbrt_edge_cases_match_sklearn(make):
    x, y = make()
    batches = [(x, y)]
    assert _tie_free(batches), 'the inputs have tied splits'
    est = _sklearn_fit(batches)
    state = _port_fit(batches)
    _assert_same_ensemble(est, state)
    if make is _constant_feature:
        assert not any((t.feature == 2).any() for t in state.trees)
    if make is _close_values:
        assert not any(np.isin(t.feature, (0, 4)).any()
                       for t in state.trees)
    if make is _zero_labels:
        assert state.init == 0.0
        assert all(t.node_count == 1 for t in state.trees)
        np.testing.assert_array_equal(state.feature_importances(),
                                      np.zeros(5))


def test_fit_gbrt_continues_a_carried_estimator():
    """A scikit-learn fit carried across continues as its own warm start
    does: the port's next 10 trees equal scikit-learn's."""
    x, y = _threshold_data(4000, 0)
    batches = [(x[:2000], y[:2000]), (x[2000:], y[2000:])]
    assert _tie_free(batches)
    first = _gbr(warm_start=True).fit(*batches[0])
    state = trees.fit_gbrt(torch.from_numpy(batches[1][0]),
                           torch.from_numpy(batches[1][1]),
                           forest_from_estimator(first))
    _assert_same_ensemble(_sklearn_fit(batches), state)


def test_fit_gbrt_refuses_bad_shapes():
    x = torch.rand(10, 3)
    with pytest.raises(ValueError, match='fit_gbrt takes'):
        trees.fit_gbrt(x, torch.rand(9))
    state = trees.fit_gbrt(x, torch.rand(10), n_estimators=1)
    with pytest.raises(ValueError, match='features'):
        trees.fit_gbrt(torch.rand(10, 4), torch.rand(10), state)


def test_tied_features_keep_the_lower_index():
    """Two copies of one feature tie at every split: the fit takes the
    first copy, where scikit-learn takes either."""
    x, y = _threshold_data(1000, 5, f=3)
    x = np.concatenate([x[:, :1], x], axis=1)
    state = _port_fit([(x, y)])
    assert not any((t.feature == 1).any() for t in state.trees)
    assert any((t.feature == 0).any() for t in state.trees)


# --- the tie order of the served top-k --------------------------------------

@pytest.mark.parametrize('n', [10, 25_000])
def test_top_k_lower_index_is_lax_top_k(n):
    """Piecewise-constant scores with -inf masks: the same values and
    indices as ``lax.top_k``."""
    import jax
    rng = np.random.RandomState(n)
    scores = rng.randint(0, 5, (6, n)).astype(np.float32) * 0.25
    scores[rng.rand(6, n) < 0.2] = -np.inf
    k = min(n - 1, 40)
    v, i = retrieval.top_k_lower_index(torch.from_numpy(scores), k)
    jv, ji = jax.lax.top_k(scores, k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
