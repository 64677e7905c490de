"""Ranking metrics: recall / precision / hit / NDCG / F1 @k.

A copy of ``textgcn_tpu/ops/metrics.py`` (host-side numpy), kept here so
the port imports nothing of the JAX package.

Behavioral spec is the reference's pandas implementation
(``TextGCN/utils.py:11-63``), reproduced here as vectorized numpy over the
fixed-shape top-k prediction matrix:

* ``recall = |pred[:k] ∩ true| / |true|``            (utils.py:15-16)
* ``precision = |pred[:k] ∩ true| / k``              (utils.py:19-20)
* ``hit = 1[|pred[:k] ∩ true| > 0]``                 (utils.py:11-12)
* ``ndcg = DCG(rel) / IDCG`` with ``DCG = Σ (2^rel - 1)/log2(pos + 2)`` and
  the ideal gain vector = ``min(|true|, k)`` ones followed by zeros
  (utils.py:23-33); ``rel[j] = 1[pred[j] ∈ true]``.
* ``f1 = 2·recall·precision/(recall+precision)`` with a zero-division guard
  (utils.py:55-62)

All metrics are means over test users.  The reference computes intersections
with ``np.intersect1d`` per user per k; here membership is one vectorized
``searchsorted`` against per-user sorted truth, bit-identical for the
duplicate-free predictions produced by top-k.
"""

from __future__ import annotations

import numpy as np

METRICS = ('recall', 'precision', 'hit', 'ndcg', 'f1')


def _membership_matrix(y_pred: np.ndarray, y_true: list[list[int]]):
    """rel[u, j] = 1 if y_pred[u, j] is in y_true[u].

    One searchsorted over (user, item) composite keys for the whole
    prediction matrix — no per-user Python loop, so eval stays fast at
    paper scale (100k+ test users).  Host-side numpy int64, no wrap risk.
    """
    import itertools

    n, width = y_pred.shape
    lens = np.fromiter((len(t) for t in y_true), dtype=np.int64, count=n)
    total = int(lens.sum())
    if total == 0:
        return np.zeros((n, width), dtype=np.float64)
    flat_true = np.fromiter(itertools.chain.from_iterable(y_true),
                            dtype=np.int64, count=total)
    stride = int(max(flat_true.max(), int(y_pred.max(initial=0)))) + 1
    true_keys = np.repeat(np.arange(n, dtype=np.int64), lens) \
        * stride + flat_true
    true_keys.sort()
    pred_keys = (np.arange(n, dtype=np.int64)[:, None] * stride
                 + y_pred.astype(np.int64)).ravel()
    idx = np.clip(np.searchsorted(true_keys, pred_keys), 0, total - 1)
    return (true_keys[idx] == pred_keys).astype(np.float64) \
        .reshape(n, width)


def _dcg(rel: np.ndarray) -> np.ndarray:
    k = rel.shape[1]
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    return ((np.power(2.0, rel) - 1.0) * discounts[None, :]).sum(axis=1)


def calculate_metrics(y_pred: np.ndarray, y_true: list[list[int]],
                      ks: tuple[int, ...]) -> dict[str, list[float]]:
    """Compute all metrics for every k in ``ks`` (ascending order).

    ``y_pred``: (n_test_users, >=max(ks)) ranked item ids from top-k.
    ``y_true``: ragged ground-truth item lists, same user order.
    Returns ``{metric: [value@k for k in sorted(ks)]}`` as in reference
    ``utils.py:36-63``.
    """
    ks = tuple(sorted(ks))
    n = y_pred.shape[0]
    true_len = np.array([len(t) for t in y_true], dtype=np.float64)
    rel_full = _membership_matrix(y_pred[:, :max(ks)], y_true)

    result: dict[str, list[float]] = {m: [] for m in METRICS}
    for k in ks:
        rel = rel_full[:, :k]
        inter = rel.sum(axis=1)
        recall = inter / true_len
        precision = inter / k
        hit = (inter > 0).astype(np.float64)

        # ideal DCG: min(|true|, k) leading ones
        ideal_ones = np.minimum(true_len, k).astype(np.int64)
        pos = np.arange(k)[None, :]
        ideal_rel = (pos < ideal_ones[:, None]).astype(np.float64)
        idcg = _dcg(ideal_rel)
        ndcg = _dcg(rel) / idcg

        denom = recall + precision
        f1 = np.divide(2.0 * recall * precision, denom,
                       out=np.zeros(n), where=denom != 0)

        result['recall'].append(float(recall.mean()))
        result['precision'].append(float(precision.mean()))
        result['hit'].append(float(hit.mean()))
        result['ndcg'].append(float(ndcg.mean()))
        result['f1'].append(float(f1.mean()))
    return result


def early_stop(history: dict[str, np.ndarray]) -> bool:
    """Early-stop rule from reference ``utils.py:79-90``.

    ``history``: {metric: array of shape (n_evals, n_ks)}.  True when >=3
    evals exist and either every metric converged (last vs prev and last vs
    prev-prev within 1e-4) or every metric strictly declined for the last
    three evals.
    """
    if len(history['recall']) < 3:
        return False
    # Stack the three most recent eval rows per metric: window[0] is the
    # oldest of the three, window[2] the newest.
    windows = [np.stack([np.asarray(v[-3]), np.asarray(v[-2]),
                         np.asarray(v[-1])]) for v in history.values()]

    def _plateaued(w: np.ndarray) -> bool:
        # newest row within tolerance of each of the two before it
        # (np.allclose semantics: atol=1e-4 plus default rtol)
        return bool(np.allclose(w[2], w[1], atol=1e-4)
                    and np.allclose(w[2], w[0], atol=1e-4))

    def _sinking(w: np.ndarray) -> bool:
        # each eval strictly worse than the one before, at every k
        return bool((np.diff(w, axis=0) < 0).all())

    return all(map(_plateaued, windows)) or all(map(_sinking, windows))
