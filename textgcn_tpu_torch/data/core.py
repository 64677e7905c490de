"""Interaction dataset: TSV ingestion, id remap, bipartite graph build.

Counterpart of ``textgcn_tpu/data/core.py`` on the ``csv`` module and
numpy (no pandas).  The semantics are the JAX package's, field by field:

* ``train.tsv`` and ``test.tsv`` are read by the native reader
  (``native.py``, C++ built at first use) or, under
  ``TEXTGCN_TPU_NATIVE=0``, by the plain Python reader
  (``_read_interactions``), with the same results and refusals;
* rows are sorted by (user_id, asin) as strings;
* internal ids follow the first appearance in the sorted train table
  (users therefore in string order, items in order of first use);
* users that appear only in the test file are an error; items that appear
  only there are dropped with a warning;
* ``edge_weight = 1/sqrt(deg_u * deg_i)`` over the train edges,
  duplicates included;
* ``pos_padded[u, :deg_u]`` holds u's sorted train items, padded with
  ``n_items``;
* ``reshuffle=True`` loads ``<data>/reshuffle_<seed>/``, which
  ``reshuffle_train_test`` writes with the JAX package's bytes (its
  stratified split drawn as scikit-learn draws it, ``data/split.py``).
"""

from __future__ import annotations

import csv
import dataclasses
import io
import logging
import os
from dataclasses import dataclass

import numpy as np

from .. import native
from .split import keep_frequent, stratified_split
from .tsv import read_table, write_rows

log = logging.getLogger('textgcn_tpu_torch')


@dataclass
class Graph:
    """Normalized bipartite interaction graph in edge-list form."""
    n_users: int
    n_items: int
    edge_user: np.ndarray    # (E,) int32
    edge_item: np.ndarray    # (E,) int32
    edge_weight: np.ndarray  # (E,) float32, 1/sqrt(deg_u * deg_i)
    user_degree: np.ndarray  # (n_users,) int32
    item_degree: np.ndarray  # (n_items,) int32

    @property
    def n_edges(self) -> int:
        return int(self.edge_user.shape[0])


@dataclass
class InteractionData:
    """Loaded and remapped train/test interactions."""
    n_users: int
    n_items: int
    n_train: int
    n_test: int
    graph: Graph
    pos_padded: np.ndarray          # (n_users, max_degree) int32
    pos_degree: np.ndarray          # (n_users,) int32
    test_users: np.ndarray          # sorted unique test users, int32
    true_test: list[list[int]]      # per test user, its test item ids
    user_id_map: dict[int, str]     # internal -> external id
    item_id_map: dict[int, str]
    # table sizes rounded up for row-sharded tables on a mesh: phantom rows
    # have no edges, are never sampled and are never scored (the real
    # counts when there is no mesh)
    n_users_padded: int = 0
    n_items_padded: int = 0

    def __post_init__(self):
        self.n_users_padded = self.n_users_padded or self.n_users
        self.n_items_padded = self.n_items_padded or self.n_items

    def padded_to(self, multiple: int) -> 'InteractionData':
        """A copy whose table sizes are rounded up to ``multiple`` (the
        number of ranks the tables are row-sharded over)."""
        return dataclasses.replace(
            self, n_users_padded=-(-self.n_users // multiple) * multiple,
            n_items_padded=-(-self.n_items // multiple) * multiple)


def _read_interactions(path: str) -> list[tuple[str, str]]:
    """(user_id, asin) string pairs of a TSV with a header, sorted: the
    plain reader, which ``native.read_pairs`` matches.  Refuses, with a
    ``ValueError`` naming the path and the line: bytes that are not UTF-8
    (the line counted by ``\\n``), a header without ``user_id`` or
    ``asin``, a record (blank lines skipped, numbered by ``csv.reader``'s
    records from the header's 1) whose field count is not the header's,
    and a field over ``csv.field_size_limit()``."""
    with open(path, 'rb') as f:
        raw = f.read()
    try:
        text = raw.decode('utf-8')
    except UnicodeDecodeError as e:
        raise ValueError(native.error_message(
            path, native.NOT_UTF8, raw.count(b'\n', 0, e.start) + 1, 0, 0,
            [])) from None
    reader = csv.reader(io.StringIO(text, newline=''), delimiter='\t')
    line_no = 0     # the last record read whole
    try:
        header = next(reader, None)
        line_no = 1
        if header is None:
            raise ValueError(native.error_message(path, native.EMPTY, 1, 0,
                                                  0, []))
        if 'user_id' not in header or 'asin' not in header:
            raise ValueError(native.error_message(
                path, native.MISSING_COLUMN, 1, 0, 0, header))
        ui, ai = header.index('user_id'), header.index('asin')
        rows = []
        for line_no, r in enumerate(reader, start=2):
            if not r:
                continue
            if len(r) != len(header):
                raise ValueError(native.error_message(
                    path, native.FIELD_COUNT, line_no, len(header), len(r),
                    header))
            rows.append((r[ui], r[ai]))
    except csv.Error:
        # the record after the last one read whole went over the limit
        raise ValueError(native.error_message(
            path, native.FIELD_LIMIT, line_no + 1, 0, 0, [])) from None
    rows.sort()
    return rows


def _python_pairs(path: str):
    """``native.read_pairs``'s result from the plain reader: per sorted
    row the user's and the item's index in order of first appearance, and
    those ids."""
    rows = _read_interactions(path)
    u_map: dict[str, int] = {}
    i_map: dict[str, int] = {}
    user = np.empty(len(rows), np.int32)
    item = np.empty(len(rows), np.int32)
    for n, (u, a) in enumerate(rows):
        user[n] = u_map.setdefault(u, len(u_map))
        item[n] = i_map.setdefault(a, len(i_map))
    return user, item, list(u_map), list(i_map)


def read_pairs(path: str):
    """``(user_codes, item_codes, user_ids, item_ids)`` of a TSV: the
    native reader, or the plain one under ``TEXTGCN_TPU_NATIVE=0``."""
    if native.enabled():
        return native.read_pairs(path)
    return _python_pairs(path)


def _missing_last(v):
    """Sort key of a field as ``sort_values`` orders it: a missing value
    after every string."""
    return (v is None, v or '')


def reshuffle_train_test(data_dir: str, seed: int,
                         train_size: float = 0.8) -> str:
    """Re-split train + test stratified by user, as the JAX package's
    ``reshuffle_train_test`` (``textgcn_tpu/data/core.py:110-134``):
    concatenate the two files, keep users with 3 rows or more, split
    ``train_size`` of them stratified by user (scikit-learn's draws),
    sort each side by (user_id, asin), drop test rows whose item has no
    train row, and write ``<data>/reshuffle_<seed>/{train,test}.tsv`` in
    pandas' bytes.  An existing folder is reused.  Returns the folder."""
    out = os.path.join(data_dir, f'reshuffle_{seed}')
    if os.path.exists(os.path.join(out, 'train.tsv')):
        return out
    os.makedirs(out, exist_ok=True)
    h_train, train = read_table(os.path.join(data_dir, 'train.tsv'))
    h_test, test = read_table(os.path.join(data_dir, 'test.tsv'))
    # pd.concat: the union of the columns in order of appearance, a
    # column a file lacks missing in its rows
    header = h_train + [c for c in h_test if c not in h_train]
    rows = [r + [None] * (len(header) - len(r)) for r in train]
    at = [h_test.index(c) if c in h_test else None for c in header]
    rows += [[None if j is None else r[j] for j in at] for r in test]
    ui, ai = header.index('user_id'), header.index('asin')
    rows = [r for r, k in zip(rows, keep_frequent([r[ui] for r in rows]))
            if k]
    tr_idx, te_idx = stratified_split([r[ui] for r in rows], train_size,
                                      seed)

    def by_user_item(idx):
        return sorted((rows[i] for i in idx), key=lambda r: (
            _missing_last(r[ui]), _missing_last(r[ai])))

    tr, te = by_user_item(tr_idx), by_user_item(te_idx)
    items = {r[ai] for r in tr}
    te = [r for r in te if r[ai] in items]
    write_rows(os.path.join(out, 'train.tsv'), header, tr)
    write_rows(os.path.join(out, 'test.tsv'), header, te)
    return out


def load_interactions(data_dir: str, *, reshuffle: bool = False,
                      seed: int = 0) -> InteractionData:
    """Load ``train.tsv``/``test.tsv`` of ``data_dir`` and build the graph
    and the per-user tables; with ``reshuffle``, those of the split that
    ``reshuffle_train_test(data_dir, seed)`` writes."""
    folder = reshuffle_train_test(data_dir, seed) if reshuffle else data_dir
    edge_user, edge_item, users, items = read_pairs(
        os.path.join(folder, 'train.tsv'))
    t_user, t_item, t_users, t_items = read_pairs(
        os.path.join(folder, 'test.tsv'))
    u_map = {u: k for k, u in enumerate(users)}
    i_map = {a: k for k, a in enumerate(items)}

    test_only_users = {u for u in t_users if u not in u_map}
    if test_only_users:
        raise ValueError(f"users {test_only_users} from test set don't "
                         'appear in train set')
    # the test table's ids as train's, -1 for an item train lacks
    to_user = np.array([u_map[u] for u in t_users], np.int64)
    to_item = np.array([i_map.get(a, -1) for a in t_items], np.int64)
    test_only_items = {a for a in t_items if a not in i_map}
    if test_only_items:
        log.warning("items %s from test set don't appear in train set, "
                    'removing them', test_only_items)
    test_u, test_i = to_user[t_user], to_item[t_item]
    kept = test_i >= 0
    test_u, test_i = test_u[kept], test_i[kept]

    n_users, n_items, n_train = len(users), len(items), len(edge_user)
    user_degree = np.bincount(edge_user, minlength=n_users).astype(np.int32)
    item_degree = np.bincount(edge_item, minlength=n_items).astype(np.int32)
    with np.errstate(divide='ignore'):
        du = 1.0 / np.sqrt(user_degree.astype(np.float64))
        di = 1.0 / np.sqrt(item_degree.astype(np.float64))
    du[~np.isfinite(du)] = 0.0
    di[~np.isfinite(di)] = 0.0
    edge_weight = (du[edge_user] * di[edge_item]).astype(np.float32)
    graph = Graph(n_users, n_items, edge_user, edge_item, edge_weight,
                  user_degree, item_degree)

    # sorted positives per row; the pad value n_items sorts after all items
    max_deg = max(int(user_degree.max(initial=0)), 1)
    pos_padded = np.full((n_users, max_deg), n_items, dtype=np.int32)
    order = np.lexsort((edge_item, edge_user))
    sorted_u = edge_user[order]
    sorted_i = edge_item[order]
    row_starts = np.searchsorted(sorted_u, np.arange(n_users))
    col_idx = np.arange(n_train) - row_starts[sorted_u]
    pos_padded[sorted_u, col_idx] = sorted_i

    # test items of each user in the order of the sorted test table
    order = np.argsort(test_u, kind='stable')
    test_users, starts = np.unique(test_u[order], return_index=True)
    items_in_order = test_i[order].tolist()
    bounds = [*starts.tolist(), len(items_in_order)]
    true_test = [items_in_order[a:b] for a, b in zip(bounds, bounds[1:])]
    test_users = test_users.astype(np.int32)

    data = InteractionData(
        n_users=n_users, n_items=n_items, n_train=n_train, n_test=len(test_u),
        graph=graph, pos_padded=pos_padded, pos_degree=user_degree.copy(),
        test_users=test_users, true_test=true_test,
        user_id_map=dict(enumerate(users)),
        item_id_map=dict(enumerate(items)),
    )
    log.info('n_train:    %7d', n_train)
    log.info('n_test:     %7d', len(test_u))
    log.info('n_users:    %7d', n_users)
    log.info('n_items:    %7d', n_items)
    return data
