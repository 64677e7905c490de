"""Gradient-boosted regression trees: the fit and the scorer, on the device.

Counterpart of ``textgcn_tpu/ops/trees.py`` (``Forest``, ``_f32_floor``,
``_extract_tree``, ``compile_forest``, ``forest_predict``) and of the fit
the JAX package hands to scikit-learn's ``GradientBoostingRegressor`` on
the host (``textgcn_tpu/models/ltr_boosted.py``).  Nothing here imports
scikit-learn: a fitted tree is read duck-typed in its ``Tree`` layout
(``children_left``, ``children_right``, ``feature``, ``threshold``,
``value``; nodes in preorder), which ``Tree`` below also has.

**The fit** (``fit_gbrt``) is that estimator at its defaults: squared
error, learning rate 0.1, no subsampling, ``min_samples_split=2``,
``min_samples_leaf=1``, exact greedy splits of depth ``max_depth``, and
its ``warm_start`` continuation (more trees on a new batch of rows, the
first batch's mean kept as the initial prediction).  It runs in torch on
``x``'s device, as scikit-learn 1.9 computes it:

* X is float32; sums, means, residuals and raw predictions are float64;
* a node's candidate split between sorted values ``v[p-1]`` and ``v[p]``
  exists only where ``v[p] > v[p-1] + 1e-7``, that sum and comparison in
  float32 (``FEATURE_THRESHOLD``), its threshold ``v[p-1]/2 + v[p]/2`` in
  float64; a row goes left when its value is ``<=`` the threshold;
* the split maximises ``s_l**2/n_l + s_r**2/n_r`` (the proxy of
  ``squared_error``, the criterion the 1.9 ensemble's trees use), the
  lowest position winning within a feature;
* a node is a leaf at ``max_depth``, below 2 rows, at an impurity
  ``<= EPSILON``, or without a candidate; its value is its mean residual.

The tree is built a level at a time: each feature's rows stay sorted
within their node (the root's sort, stably partitioned level by level),
so a node's candidates in a feature are one scan of its run; the nodes
are then numbered in scikit-learn's preorder, so the arrays compare one
for one.  One choice
differs: scikit-learn visits the features in a random order, so of two
features with exactly equal best splits it keeps either; the fit keeps
the lower feature index.

**The scorer** (``compile_forest``, ``forest_predict``) evaluates each
tree as three dense contractions over all rows (the GEMM strategy of
Hummingbird): ``D = (X @ A <= B)`` tests every internal node, ``S = D @
C`` counts the path agreements (``C[i, l]`` is +1 if leaf ``l`` lies left
of node ``i``, -1 if right), and ``(S == E) @ V`` selects the leaf value.
Thresholds are rounded down to float32 so that ``x <= t`` over float32
rows decides as the float64 comparison does; the trees are summed in
float32 from zeros and the initial prediction added last, the JAX
package's order, so a carried-across ensemble scores bit for bit as its
``forest_predict`` does.  The products run in full float32 with TF32 off:
a rounded operand would send a row near a threshold down the wrong
branch.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, fields

import numpy as np
import torch

LEARNING_RATE = 0.1
FEATURE_THRESHOLD = np.float32(1e-7)      # sklearn/tree/_partitioner.pxd
EPSILON = float(np.finfo(np.float64).eps)  # sklearn/tree/_tree.pyx
TREE_LEAF, TREE_UNDEFINED = -1, -2


@dataclass
class Tree:
    """One fitted regression tree in scikit-learn's ``Tree`` layout: node
    0 is the root, nodes in preorder; a leaf has children ``-1``, feature
    ``-2`` and threshold ``-2.0``; ``value`` is each node's mean target,
    ``impurity`` its mean squared deviation."""

    children_left: np.ndarray     # int64 (n_nodes,)
    children_right: np.ndarray    # int64
    feature: np.ndarray           # int64
    threshold: np.ndarray         # float64
    value: np.ndarray             # float64
    impurity: np.ndarray          # float64
    n_node_samples: np.ndarray    # int64

    @property
    def node_count(self) -> int:
        return len(self.children_left)

    def importances(self, n_features: int) -> np.ndarray:
        """Each feature's impurity decrease, weighted by the rows, over
        the root's rows (``Tree.compute_feature_importances(normalize=
        False)``)."""
        out = np.zeros(n_features)
        w = self.n_node_samples.astype(np.float64)
        imp = self.impurity
        for node in range(self.node_count):
            left, right = self.children_left[node], self.children_right[node]
            if left != TREE_LEAF:
                out[self.feature[node]] += (w[node] * imp[node]
                                            - w[left] * imp[left]
                                            - w[right] * imp[right])
        return out / w[0]


@dataclass
class GBRTState:
    """A boosted ensemble: ``init + learning_rate * sum(tree values)``."""

    trees: list
    init: float
    learning_rate: float
    n_features: int

    def feature_importances(self) -> np.ndarray:
        """The normalised mean of the unnormalised importances of the
        trees that split (``GradientBoostingRegressor
        .feature_importances_``); zeros when none does."""
        rows = [t.importances(self.n_features) for t in self.trees
                if t.node_count > 1]
        if not rows:
            return np.zeros(self.n_features)
        avg = np.mean(rows, axis=0, dtype=np.float64)
        return avg / np.sum(avg)

    def digest(self) -> int:
        """48 bits of a SHA-256 of every tree's node arrays, the initial
        prediction, the learning rate and the feature count: an integer
        a float64 holds exactly (the mesh compares the ranks' forests by
        it)."""
        h = hashlib.sha256()
        for tree in self.trees:
            for f in fields(Tree):
                h.update(np.ascontiguousarray(getattr(tree, f.name))
                         .tobytes())
        h.update(np.array([self.init, self.learning_rate, self.n_features],
                          np.float64).tobytes())
        return int.from_bytes(h.digest()[:6], 'little')


# --- the fit -----------------------------------------------------------------

def fit_gbrt(x: torch.Tensor, y: torch.Tensor, state: GBRTState | None = None,
             n_estimators: int = 10, max_depth: int = 3) -> GBRTState:
    """Least-squares boosting of ``n_estimators`` trees on ``(x (R, F),
    y (R,))``, on ``x``'s device, at the learning rate ``LEARNING_RATE``.
    With ``state``, continue it as a ``warm_start`` estimator continues on
    a new batch: the residuals start from its raw predictions (its
    ``init`` and ``learning_rate`` are kept).  Returns the new state;
    ``state`` is not changed."""
    if x.ndim != 2 or y.shape != (x.shape[0],) or x.shape[0] == 0:
        raise ValueError(f'fit_gbrt takes x (R, F) and y (R,) with R > 0, '
                         f'got {tuple(x.shape)} and {tuple(y.shape)}')
    x = x.to(torch.float32).contiguous()
    y = y.to(device=x.device, dtype=torch.float64)
    n, n_features = x.shape
    if state is None:
        init = float(y.sum() / n)
        state = GBRTState([], init, LEARNING_RATE, n_features)
        raw = torch.full((n,), init, dtype=torch.float64, device=x.device)
    else:
        if state.n_features != n_features:
            raise ValueError(f'the ensemble has {state.n_features} '
                             f'features, x {n_features}')
        raw = raw_predict(state, x)
    # each feature's rows sorted by value, shared by the roots of all trees
    roots = []
    for j in range(n_features):
        vals, order = torch.sort(x[:, j], stable=True)
        roots.append((order, vals))
    n_left = torch.arange(1, n, dtype=torch.float64, device=x.device)
    trees = list(state.trees)
    for _ in range(n_estimators):
        tree, leaf_value = _fit_tree(x, y - raw, roots, n_left, max_depth)
        raw = raw + state.learning_rate * leaf_value
        trees.append(tree)
    return GBRTState(trees, state.init, state.learning_rate, n_features)


def _fit_tree(x: torch.Tensor, r: torch.Tensor, roots, n_left,
              max_depth: int):
    """One regression tree on the residuals ``r`` (float64), a level at a
    time; returns the ``Tree`` and each row's leaf value.

    ``layouts`` holds, for each feature, the rows of this level's nodes,
    their values and residuals, grouped by node (in heap order) and
    sorted by value within a node: the roots' order, stably partitioned
    level by level, so no level sorts or gathers again.  A node's sums
    are reductions over its run; its impurity, value and split decision
    are float64 arithmetic on the host, in scikit-learn's order."""
    n = x.shape[0]
    row_value = torch.zeros(n, dtype=torch.float64, device=x.device)
    layouts = [(rows, vals, r[rows]) for rows, vals in roots]
    counts, imps = [n], None
    levels = []
    for depth in range(max_depth + 1):
        rows0, _, res0 = layouts[0]
        ends = np.cumsum(counts).tolist()
        runs = [(e - m, e) for e, m in zip(ends, counts)]
        sums = torch.stack([res0[a:b].sum() for a, b in runs]
                           + [res0[a:b].square().sum() for a, b in runs])
        sums = sums.tolist()
        s, sq = sums[:len(runs)], sums[len(runs):]
        if imps is None:                           # the root: node_impurity()
            imps = [sq[0] / n - (s[0] / n) ** 2]
        leaf = [m < 2 or imp <= EPSILON or depth >= max_depth
                for m, imp in zip(counts, imps)]
        nodes = [[m, False, TREE_UNDEFINED, float(TREE_UNDEFINED),
                  s_c / m if m else 0.0, imp]
                 for m, s_c, imp in zip(counts, s, imps)]
        go_left = next_counts = next_imps = None
        if not all(leaf):
            best, feat, thr = _best_splits(layouts, counts, leaf, s, n_left)
            go_left = torch.zeros(n, dtype=torch.bool, device=x.device)
            next_counts, next_imps = [], []
            for c, (a, b) in enumerate(runs):
                m, child = counts[c], ([0, 0], [0.0, 0.0])
                if not leaf[c] and best[c] > -np.inf:
                    rows = rows0[a:b]
                    go = x[rows, feat[c]].to(torch.float64) <= thr[c]
                    left = res0[a:b][go]
                    n_l, n_r = left.shape[0], m - left.shape[0]
                    s_l, sq_l = torch.stack([left.sum(),
                                             left.square().sum()]).tolist()
                    s_r, sq_r = s[c] - s_l, sq[c] - sq_l
                    imp_l = sq_l / n_l - (s_l / n_l) ** 2  # children_impurity
                    imp_r = sq_r / n_r - (s_r / n_r) ** 2
                    improvement = (m / n) * (imps[c] - n_r / m * imp_r
                                             - n_l / m * imp_l)
                    # min_impurity_decrease = 0, as scikit-learn tests it
                    if not improvement + EPSILON < 0.0:
                        nodes[c][1:4] = True, feat[c], thr[c]
                        go_left[rows] = go
                        child = ([n_l, n_r], [imp_l, imp_r])
                next_counts += child[0]
                next_imps += child[1]
        for c, (a, b) in enumerate(runs):
            if counts[c] and not nodes[c][1]:
                row_value[rows0[a:b]] = nodes[c][4]
        levels.append(nodes)
        splits = [node[1] for node in nodes]
        if not any(splits):
            break
        # the last level needs one layout: its leaves' rows and sums
        kept = layouts if depth + 1 < max_depth else layouts[:1]
        layouts = [_partition(layout, go_left, counts, splits, next_counts)
                   for layout in kept]
        counts, imps = next_counts, next_imps
    return _preorder(levels), row_value


def _best_splits(layouts, counts, leaf, s, n_left):
    """``(proxy, feature, threshold)`` lists of every node's best split at
    this level (proxy ``-inf`` where a node has no candidate).  A node's
    candidates in a feature are the prefixes of its run in the layout:
    the left sums are one scan of the run's residuals, the left counts
    ``n_left`` (1, 2, ... as float64)."""
    dev, f64 = n_left.device, torch.float64
    best = [torch.tensor(-torch.inf, dtype=f64, device=dev)] * len(counts)
    feat = [torch.tensor(TREE_UNDEFINED, device=dev)] * len(counts)
    thr = [torch.tensor(float(TREE_UNDEFINED), dtype=f64,
                        device=dev)] * len(counts)
    thr32 = torch.tensor(FEATURE_THRESHOLD, device=dev)
    for j, (_, vals, res) in enumerate(layouts):
        a = 0
        for c, m in enumerate(counts):
            a += m
            if leaf[c]:
                continue
            v = vals[a - m:a]
            s_l = torch.cumsum(res[a - m:a - 1], 0)    # the first 1..m-1
            n_l = n_left[:m - 1]
            s_r = s[c] - s_l
            gap = v[1:] > v[:-1] + thr32                # float32, as sklearn
            proxy = torch.where(gap, s_l * s_l / n_l + s_r * s_r / (m - n_l),
                                -torch.inf)
            at = torch.argmax(proxy)       # the first of equal maxima
            better = proxy[at] > best[c]   # strict: the lower feature wins
            best[c] = torch.where(better, proxy[at], best[c])
            feat[c] = torch.where(better, j, feat[c])
            thr[c] = torch.where(better, v[at].to(f64) / 2.0
                                 + v[at + 1].to(f64) / 2.0, thr[c])
    out = torch.stack([torch.stack(best), torch.stack(feat).to(f64),
                       torch.stack(thr)]).tolist()
    return out[0], [int(f) for f in out[1]], out[2]


def _partition(layout, go_left, counts, splits, next_counts):
    """The next level's layout of one feature: each split node's run
    divided stably into its left rows, then its right rows (the children's
    runs, ``next_counts``); the rows of nodes that became leaves dropped.
    A left entry's place is its left child's start plus the run's lefts
    before it; a right entry's, its right child's start plus the run's
    rights before it."""
    rows = layout[0]
    out = [arr.new_empty(sum(next_counts)) for arr in layout]
    a = child = 0
    for c, m in enumerate(counts):
        n_l = next_counts[2 * c]
        if splits[c]:
            left = go_left[rows[a:a + m]]
            lefts = torch.cumsum(left, 0) - left.long()
            rights = torch.arange(m, device=rows.device) - lefts
            dest = child + torch.where(left, lefts, n_l + rights)
            for o, arr in zip(out, layout):
                o.index_copy_(0, dest, arr[a:a + m])
        child += n_l + next_counts[2 * c + 1]
        a += m
    return tuple(out)


def _preorder(levels) -> Tree:
    """The nodes of a level-by-level build (heap positions: the children
    of ``(d, k)`` are ``(d + 1, 2k)`` and ``(d + 1, 2k + 1)``) numbered in
    preorder, as scikit-learn's depth-first construction numbers them."""
    rows = []

    def visit(d, k):
        cnt, split, feat, thr, value, imp = levels[d][k]
        node = len(rows)
        rows.append(None)
        left = right = TREE_LEAF
        if split:
            left = visit(d + 1, 2 * k)
            right = visit(d + 1, 2 * k + 1)
        rows[node] = (left, right, int(feat) if split else TREE_UNDEFINED,
                      thr if split else float(TREE_UNDEFINED), value, imp,
                      int(cnt))
        return node

    visit(0, 0)
    cols = list(zip(*rows))
    i64, f64 = np.int64, np.float64
    return Tree(np.array(cols[0], i64), np.array(cols[1], i64),
                np.array(cols[2], i64), np.array(cols[3], f64),
                np.array(cols[4], f64), np.array(cols[5], f64),
                np.array(cols[6], i64))


def tree_depth(tree) -> int:
    """The depth of a tree in the ``Tree`` layout (preorder: a parent
    precedes its children)."""
    left, right = tree.children_left, tree.children_right
    depth = np.zeros(len(left), np.int64)
    for node in range(len(left)):
        for child in (left[node], right[node]):
            if child != TREE_LEAF:
                depth[child] = depth[node] + 1
    return int(depth.max())


def apply_tree(tree, x: torch.Tensor) -> torch.Tensor:
    """Each row's leaf (node index) in ``tree``: left where ``x <=
    threshold`` with float32 ``x`` against the float64 threshold, as
    ``Tree.apply`` routes."""
    dev = x.device
    left = torch.as_tensor(np.asarray(tree.children_left, np.int64),
                           device=dev)
    right = torch.as_tensor(np.asarray(tree.children_right, np.int64),
                            device=dev)
    feat = torch.as_tensor(np.asarray(tree.feature, np.int64),
                           device=dev).clamp(min=0)
    thr = torch.as_tensor(np.asarray(tree.threshold, np.float64),
                          device=dev)
    node = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    for _ in range(tree_depth(tree)):
        go_left = (x.gather(1, feat[node][:, None])[:, 0].to(torch.float64)
                   <= thr[node])
        child = torch.where(go_left, left[node], right[node])
        node = torch.where(left[node] == TREE_LEAF, node, child)
    return node


def raw_predict(state: GBRTState, x: torch.Tensor) -> torch.Tensor:
    """float64 raw predictions: ``init`` plus ``learning_rate *`` each
    tree's leaf value, tree by tree (``_raw_predict``/``predict_stages``);
    the fit's residuals start from these."""
    x = x.to(torch.float32)
    raw = torch.full((x.shape[0],), state.init, dtype=torch.float64,
                     device=x.device)
    for tree in state.trees:
        value = torch.as_tensor(np.asarray(tree.value, np.float64)
                                .reshape(-1), device=x.device)
        raw = raw + state.learning_rate * value[apply_tree(tree, x)]
    return raw


# --- the scorer --------------------------------------------------------------

@dataclass
class Forest:
    """Stacked padded per-tree GEMM operands (all shapes ``(T, ...)``)."""

    A: torch.Tensor       # (T, F, I) feature selectors
    B: torch.Tensor       # (T, I) thresholds (float32, rounded down)
    C: torch.Tensor       # (T, I, L) +-1 path matrix
    E: torch.Tensor       # (T, L) left-ancestor counts (2**30: a padded leaf)
    V: torch.Tensor       # (T, L) leaf values, scaled by the learning rate
    base: torch.Tensor    # () the initial prediction

    @property
    def n_features(self) -> int:
        return self.A.shape[1]


def _f32_floor(t: np.ndarray) -> np.ndarray:
    """Largest float32 <= t: makes ``x_f32 <= t_f32`` match ``x_f32 <=
    t_f64``."""
    t32 = t.astype(np.float32)
    over = t32.astype(np.float64) > t
    return np.where(over, np.nextafter(t32, np.float32(-np.inf)), t32)


def _extract_tree(tree, n_features: int):
    """``(A, B, C, E, V)`` of one fitted tree in the ``Tree`` layout."""
    left = np.asarray(tree.children_left)
    right = np.asarray(tree.children_right)
    internal = np.flatnonzero(left != TREE_LEAF)
    leaves = np.flatnonzero(left == TREE_LEAF)
    node_to_i = {int(nd): i for i, nd in enumerate(internal)}
    n_i, n_l = max(len(internal), 1), len(leaves)

    A = np.zeros((n_features, n_i), np.float32)
    B = np.full(n_i, np.float32(np.finfo(np.float32).max))
    C = np.zeros((n_i, n_l), np.float32)
    E = np.zeros(n_l, np.float32)
    V = np.asarray(tree.value)[leaves].reshape(n_l).astype(np.float32)
    for i, nd in enumerate(internal):
        A[tree.feature[nd], i] = 1.0
        B[i] = _f32_floor(np.float64(tree.threshold[nd]))

    def walk(node, anc):       # root-to-leaf paths and their branches
        if left[node] == TREE_LEAF:
            leaf = np.searchsorted(leaves, node)
            for i, d in anc:
                C[i, leaf] = d
            E[leaf] = sum(1 for _, d in anc if d > 0)
            return
        i = node_to_i[int(node)]
        walk(left[node], anc + [(i, 1.0)])
        walk(right[node], anc + [(i, -1.0)])

    walk(0, [])
    return A, B, C, E, V


def compile_forest(state: GBRTState, device=None) -> Forest:
    """The ensemble as a :class:`Forest` on ``device`` (default: the
    CPU); the operands are built in numpy as the JAX package builds
    them."""
    if not state.trees:
        raise ValueError('the ensemble has no trees')
    parts = [_extract_tree(t, state.n_features) for t in state.trees]
    max_i = max(p[0].shape[1] for p in parts)
    max_l = max(p[2].shape[1] for p in parts)
    scale = float(state.learning_rate)

    def pad(p):
        A, B, C, E, V = p
        pi, pl = max_i - A.shape[1], max_l - C.shape[1]
        A = np.pad(A, ((0, 0), (0, pi)))
        B = np.pad(B, (0, pi),
                   constant_values=np.float32(np.finfo(np.float32).max))
        C = np.pad(C, ((0, pi), (0, pl)))
        E = np.pad(E, (0, pl), constant_values=np.float32(2**30))
        V = np.pad(V, (0, pl))
        return A, B, C, E, V * scale

    stacked = (np.stack(x) for x in zip(*(pad(p) for p in parts)))
    A, B, C, E, V = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in stacked)
    base = torch.tensor(np.float32(state.init), device=device)
    return Forest(A, B, C, E, V, base)


def forest_predict(forest: Forest, x: torch.Tensor) -> torch.Tensor:
    """``(R, F)`` features -> ``(R,)`` float32 ensemble predictions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = x.to(torch.float32)
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for A, B, C, E, V in zip(forest.A, forest.B, forest.C, forest.E,
                             forest.V):
        d = (x @ A <= B).to(torch.float32)           # (R, I)
        onehot = (d @ C == E).to(torch.float32)      # (R, L)
        acc = acc + onehot @ V
    return acc + forest.base
