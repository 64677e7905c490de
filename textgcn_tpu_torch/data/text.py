"""Text features of the LTR heads: KG descriptions, review vectors,
popularity.

Counterpart of ``textgcn_tpu/data/text.py`` on the ``csv`` module and
numpy (no pandas), with the JAX package's semantics field by field:

* ``embed_text``: dedup, encode, remap, with the on-disk cache the JAX
  package reads and writes (``<stem>.npy`` and its ``.meta`` content
  fingerprint; a reference ``<stem>.torch`` is read when no ``.npy`` is
  there);
* item descriptions: the ``meta_synced.tsv`` columns after ``asin`` joined
  with `` [SEP] ``, each rendered as ``pandas.read_table(...).astype(str)``
  renders it (``_render_column``);
* reviews: ``reviews_text.tsv`` rows of train edges, per user and per item
  the ``median(count)`` latest ones (pandas' unstable descending sort of
  ``time`` replicated by ``_nargsort_desc``), mean vectors per item and
  per user, and users as the mean description of the items they
  reviewed;
* popularity, ``fixed`` (count / max count) or ``compat`` (the
  reference's literal formula: entity ids in count order over the number
  of entities);
* every train review's vector by (item, user), sorted by item then user,
  for the text models' ``--pos user``.

Encoders (``TEXTGCN_TPU_TEXT_ENCODER``), used when no cache fits:

* ``stub``: the JAX package's deterministic hash-seeded unit vectors, bit
  for bit;
* ``flax``: the port's encoder (``encoder.py``: BERT, DistilBERT,
  RoBERTa or XLM-RoBERTa) over ``--bert_model`` (a local directory, or a
  name in the Hugging Face cache; Flax weights read first, as
  ``FlaxAutoModel`` reads them) on the entry point's device, by the JAX
  package's Flax recipe (token mean, L2 norm, 512 tokens at most);
* ``st`` and ``auto`` (the default): the same encoders, MPNet too, with
  Sentence Transformers' semantics read from the directory (its modules,
  pooling, ``Normalize`` and ``max_seq_length``), which the JAX package's
  ``auto`` reaches first wherever sentence-transformers is installed.
  On a directory with Flax weights only (``flax_model.msgpack`` or its
  shards), where Sentence Transformers fails, ``auto`` runs the Flax
  recipe, as the JAX package's cascade does next (``encoder.flax_only``).
  Any other failure raises: ``auto`` does not fall back to the stub.
"""

from __future__ import annotations

import csv
import dataclasses
import hashlib
import logging
import os
import re
from dataclasses import dataclass

import numpy as np

from ..config import Config
from .core import InteractionData, load_interactions

log = logging.getLogger('textgcn_tpu_torch')

STUB_DIM = 384  # the width of all-MiniLM-L6-v2
ENCODER_ENV = 'TEXTGCN_TPU_TEXT_ENCODER'
ENCODERS = ('auto', 'flax', 'st', 'stub')

# the fields pandas.read_table reads as missing (its default na_values)
NA_VALUES = frozenset((
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'))
_INT = re.compile(r'[+-]?\d+\Z')
_FLOAT = re.compile(
    r'[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\Z',
    re.IGNORECASE)
_TRUE, _FALSE = ('True', 'TRUE', 'true'), ('False', 'FALSE', 'false')


# ---------------------------------------------------------------------------
# encoders

def _stub_encode(sentences: list[str]) -> np.ndarray:
    """Deterministic offline encoder: SHA-256-seeded unit-norm normals,
    the JAX package's ``_stub_encode`` bit for bit."""
    out = np.empty((len(sentences), STUB_DIM), dtype=np.float32)
    for j, s in enumerate(sentences):
        h = hashlib.sha256(s.encode('utf-8', 'ignore')).digest()
        rng = np.random.RandomState(int.from_bytes(h[:4], 'little'))
        v = rng.standard_normal(STUB_DIM).astype(np.float32)
        out[j] = v / max(np.linalg.norm(v), 1e-8)
    return out


def encode_sentences(sentences: list[str], bert_model: str,
                     batch_size: int) -> np.ndarray:
    """``(len(sentences), D)`` vectors from the encoder that
    ``TEXTGCN_TPU_TEXT_ENCODER`` names: ``stub``, or ``flax``, ``st`` and
    ``auto``, which run the port's encoder on the entry point's device
    (``config.platform_device``) by the Flax recipe or Sentence
    Transformers' (``encoder.encode``)."""
    backend = os.environ.get(ENCODER_ENV, 'auto')
    if backend == 'stub':
        return _stub_encode(sentences)
    if backend not in ENCODERS:
        raise ValueError(f'{ENCODER_ENV}={backend!r}: use one of '
                         f'{", ".join(ENCODERS)}')
    from ..config import platform_device
    from .encoder import encode
    return encode(sentences, bert_model, batch_size, platform_device(),
                  backend)


# ---------------------------------------------------------------------------
# the embedding cache

def _texts_fingerprint(texts: list[str]) -> str:
    """Content hash of the exact row sequence an embedding cache covers."""
    h = hashlib.sha1()
    h.update(str(len(texts)).encode())
    for t in texts:
        h.update(t.encode('utf-8', 'ignore'))
        h.update(b'\x00')
    return h.hexdigest()


def _read_cache(cache_path: str, texts: list[str]) -> np.ndarray | None:
    """The cached vectors of ``texts``, or None when there is no cache
    that fits: our ``.npy`` whose ``.meta`` fingerprint matches (without a
    ``.meta``, whose row count matches), else a reference ``.torch`` of
    the right row count."""
    npy_path = cache_path if cache_path.endswith('.npy') \
        else cache_path + '.npy'
    meta_path = npy_path + '.meta'
    if os.path.exists(npy_path):
        cached = np.load(npy_path)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                stale = f.read().strip() != _texts_fingerprint(texts)
        else:
            stale = len(cached) != len(texts)
        if not stale:
            return cached
        log.warning('embedding cache %s does not match the current text '
                    'rows (%d cached vs %d); re-encoding', npy_path,
                    len(cached), len(texts))
        return None
    torch_path = cache_path if cache_path.endswith('.torch') \
        else cache_path.rsplit('.npy', 1)[0] + '.torch'
    if os.path.exists(torch_path):
        import torch
        cached = torch.load(torch_path, map_location='cpu',
                            weights_only=True).numpy()
        if len(cached) == len(texts):
            return cached
        log.warning('reference embedding cache %s has %d rows but the '
                    'current text has %d; re-encoding', torch_path,
                    len(cached), len(texts))
    return None


def embed_text(texts: list[str], cache_path: str, bert_model: str,
               batch_size: int) -> np.ndarray:
    """The vectors of ``texts``, row for row: from the cache at
    ``cache_path`` (``.npy`` stem), else encoded once per distinct text
    and written there with its ``.meta`` fingerprint."""
    cached = _read_cache(cache_path, texts)
    if cached is not None:
        return cached
    unique = sorted(set(texts), key=lambda x: (-len(x.split(' ')), x))
    embs = encode_sentences(unique, bert_model, batch_size)
    row = {t: j for j, t in enumerate(unique)}
    result = embs[[row[t] for t in texts]].astype(np.float32)
    npy_path = cache_path if cache_path.endswith('.npy') \
        else cache_path + '.npy'
    os.makedirs(os.path.dirname(npy_path), exist_ok=True)
    np.save(npy_path, result)
    with open(npy_path + '.meta', 'w') as f:
        f.write(_texts_fingerprint(texts))
    return result


# ---------------------------------------------------------------------------
# TSV reading with pandas' rendering

def _read_tsv(path: str) -> tuple[list[str], list[list[str]]]:
    """Header and rows of a TSV (double-quoted fields unquoted, blank
    lines skipped, short rows padded with empty fields)."""
    with open(path, newline='', encoding='utf-8') as f:
        reader = csv.reader(f, delimiter='\t')
        header = next(reader)
        rows = [r + [''] * (len(header) - len(r)) for r in reader if r]
    return header, rows


def _column_type(values: list[str]) -> str:
    """The type pandas < 3 infers for a column: ``int`` (``float`` when
    one is missing), ``float``, ``bool`` or ``text``; all missing is
    ``float``."""
    present = [v for v in values if v not in NA_VALUES]
    if all(_INT.match(v) for v in present):
        return 'int' if len(present) == len(values) else 'float'
    if all(_FLOAT.match(v) or _INT.match(v) for v in present):
        return 'float'
    if all(v in _TRUE or v in _FALSE for v in present):
        return 'bool'
    return 'text'


def _render_column(values: list[str]) -> list[str]:
    """The strings ``read_table(...)[col].astype(str)`` gives for one
    column as pandas < 3 reads it (``_column_type``): ``'12'``, ``'12.0'``
    for an integer in a float column, ``'True'``, or the text; a missing
    field is ``'nan'``."""
    kind = _column_type(values)
    render = {'int': lambda v: str(int(v)),
              'float': lambda v: repr(float(v)),
              'bool': lambda v: str(v in _TRUE),
              'text': lambda v: v}[kind]
    return ['nan' if v in NA_VALUES else render(v) for v in values]


# ---------------------------------------------------------------------------
# LTR dataset: interactions + text features

@dataclass
class LTRData(InteractionData):
    """InteractionData extended with dense text and popularity features."""
    items_as_desc: np.ndarray = None          # (n_items, D)
    items_as_avg_reviews: np.ndarray = None   # (n_items, D)
    users_as_avg_reviews: np.ndarray = None   # (n_users, D)
    users_as_avg_desc: np.ndarray = None      # (n_users, D)
    popularity_users: np.ndarray = None       # (n_users, 1)
    popularity_items: np.ndarray = None       # (n_items, 1)
    text_dim: int = 0
    # the train reviews' vectors by (item, user), for the text models'
    # ``--pos user``: sorted by item, then user (ties in review order),
    # with the row pointer of each item's run
    review_pair_items: np.ndarray = None      # (n_reviews,) int32
    review_pair_users: np.ndarray = None      # (n_reviews,) int32
    review_pair_item_ptr: np.ndarray = None   # (n_items + 1,) int32
    review_pair_vectors: np.ndarray = None    # (n_reviews, D)


def _model_tag(cfg: Config) -> str:
    return f'{cfg.bert_model.split("/")[-1]}_{cfg.seed}-seed'


def _item_texts(base: InteractionData, cfg: Config) -> list[str]:
    """One text per item id: its ``meta_synced.tsv`` fields after
    ``asin`` joined with `` {sep} `` (the last row of a repeated asin
    wins); ``''`` for an item the file does not describe."""
    header, rows = _read_tsv(os.path.join(cfg.data, 'meta_synced.tsv'))
    ai = header.index('asin')
    columns = [[r[c] for r in rows] for c in range(len(header)) if c != ai]
    rendered = [_render_column(col) for col in columns]
    asins = [r[ai] for r in rows]
    by_asin = {}
    if _column_type(asins) == 'text':   # numeric keys match no item id
        for n, asin in enumerate(asins):
            if asin not in NA_VALUES:
                by_asin[asin] = f' {cfg.sep} '.join(c[n] for c in rendered)
    return [by_asin.get(base.item_id_map[i], '')
            for i in range(base.n_items)]


def _load_kg_descriptions(base: InteractionData, cfg: Config) -> np.ndarray:
    """Item descriptions from ``meta_synced.tsv``, embedded
    ``(n_items, D)``."""
    cache = os.path.join(cfg.data, 'embeddings',
                         f'item_kg_repr_{_model_tag(cfg)}')
    return embed_text(_item_texts(base, cfg), cache, cfg.bert_model,
                      cfg.emb_batch_size)


@dataclass
class Reviews:
    """``reviews_text.tsv`` rows whose user and item are in the graph, in
    the order of ``(asin, user_id)`` as strings (ties in file order)."""
    item: np.ndarray      # (n,) int64 item ids
    user: np.ndarray      # (n,) int64 user ids
    text: list[str]
    time: np.ndarray      # (n,) int64, or float64 when one is not integer

    def take(self, keep: np.ndarray) -> 'Reviews':
        """The rows where the boolean ``keep`` is set."""
        return Reviews(self.item[keep], self.user[keep],
                       [self.text[i] for i in np.flatnonzero(keep)],
                       self.time[keep])


def _time_values(times: list[str]) -> np.ndarray:
    """``pd.to_numeric(errors='coerce').fillna(0)``: int64 when every
    value is an integer, else float64 with 0 for what is no number."""
    if all(_INT.match(t) for t in times):
        return np.array([int(t) for t in times], np.int64)
    return np.array([float(t) if _FLOAT.match(t) or _INT.match(t) else 0.0
                     for t in times], np.float64)


def _load_reviews(base: InteractionData, cfg: Config) -> Reviews:
    """The review rows of the graph's users and items; a row with a
    missing field is dropped, as pandas' ``dropna`` drops it."""
    header, rows = _read_tsv(os.path.join(cfg.data, 'reviews_text.tsv'))
    ai, ui, ri = (header.index(c) for c in ('asin', 'user_id', 'review'))
    ti = header.index('time') if 'time' in header else None
    keyed = sorted(((r[ai], r[ui]), n) for n, r in enumerate(rows))
    u_map = {v: k for k, v in base.user_id_map.items()}
    i_map = {v: k for k, v in base.item_id_map.items()}
    items, users, texts, times = [], [], [], []
    for (asin, user), n in keyed:
        r = rows[n]
        t = r[ti] if ti is not None else '0'
        if (asin in NA_VALUES or user in NA_VALUES or r[ri] in NA_VALUES
                or t in NA_VALUES or asin not in i_map or user not in u_map):
            continue
        items.append(i_map[asin])
        users.append(u_map[user])
        texts.append(r[ri])
        times.append(t)
    return Reviews(np.array(items, np.int64), np.array(users, np.int64),
                   texts, _time_values(times))


def _nargsort_desc(values: np.ndarray) -> np.ndarray:
    """pandas' ``sort_values(ascending=False)`` order (``nargsort``):
    reverse, ``argsort(kind='quicksort')``, reverse.  Not stable: it
    decides which of two equal times comes first."""
    idx = np.arange(len(values))[::-1]
    return idx[values[::-1].argsort(kind='quicksort')][::-1]


def _head_by_group(order: np.ndarray, group: np.ndarray,
                   n: int) -> np.ndarray:
    """``groupby(group).head(n)`` of the rows ``order``, in that order."""
    g = group[order]
    by = np.argsort(g, kind='stable')
    starts = np.flatnonzero(np.r_[True, g[by][1:] != g[by][:-1]])
    rank = np.empty(len(g), np.int64)
    rank[by] = np.arange(len(g)) - np.repeat(starts, np.diff(
        np.r_[starts, len(g)]))
    return order[rank < n]


def _mean_by_group(ids: np.ndarray, vectors: np.ndarray,
                   n_groups: int) -> np.ndarray:
    """Mean of ``vectors`` rows per group id, summed in row order (the
    JAX package's ``np.add.at``, ~3x faster on the host's torch); absent
    groups get zeros."""
    import torch
    out = torch.zeros((n_groups, vectors.shape[1]), dtype=torch.float32)
    out.index_add_(0, torch.from_numpy(ids), torch.from_numpy(
        np.ascontiguousarray(vectors, np.float32)))
    out = out.numpy()
    counts = np.bincount(ids, minlength=n_groups).astype(np.float32)
    nz = counts > 0
    out[nz] /= counts[nz, None]
    return out


def _popularity(ids: np.ndarray, n: int, mode: str) -> np.ndarray:
    """Popularity per entity from its review ``ids``, ``(n, 1)`` float32:
    ``fixed`` count / max count; ``compat`` the reference's literal values
    (entity ids in count-descending order, pandas' tie order, divided by
    the number of entities with a review)."""
    uniq, cnt = np.unique(ids, return_counts=True)
    if mode == 'compat':
        order = uniq[_nargsort_desc(cnt)]
        vals = np.zeros(n)
        vals[:len(order)] = order / max(len(uniq), 1)
        return vals.astype(np.float32).reshape(-1, 1)
    counts = np.zeros(n, np.float64)
    counts[uniq] = cnt
    return (counts / max(counts.max(initial=0.0), 1.0)).astype(
        np.float32).reshape(-1, 1)


def load_ltr_data(cfg: Config,
                  popularity_mode: str | None = None) -> LTRData:
    """The LTR bundle: interactions plus text and popularity features
    (``textgcn_tpu/data/text.py:245-330``).  ``popularity_mode``
    defaults to ``cfg.popularity_mode``."""
    if popularity_mode is None:
        popularity_mode = cfg.popularity_mode
    base = load_interactions(cfg.data, reshuffle=cfg.reshuffle,
                             seed=cfg.seed)
    items_as_desc = _load_kg_descriptions(base, cfg).astype(np.float32)
    dim = items_as_desc.shape[1]

    reviews = _load_reviews(base, cfg)
    cache = os.path.join(cfg.data, 'embeddings',
                         f'item_full_reviews_loss_repr_{_model_tag(cfg)}')
    vectors = embed_text(reviews.text, cache, cfg.bert_model,
                         cfg.emb_batch_size)

    # train reviews only: int64 pair keys against the train edges
    g = base.graph
    n_u = np.int64(base.n_users)
    train_keys = g.edge_item.astype(np.int64) * n_u + g.edge_user
    keep = np.isin(reviews.item * n_u + reviews.user, train_keys)
    reviews = reviews.take(keep)
    vectors = vectors[keep]

    # the median review count over items and users together
    item_counts = np.unique(reviews.item, return_counts=True)[1]
    user_counts = np.unique(reviews.user, return_counts=True)[1]
    num_reviews = int(np.median(np.concatenate([item_counts, user_counts])))

    # per user and per item the latest num_reviews, by-user rows first;
    # the first row of a repeated (item, user) pair wins; sorted by pair
    latest = _nargsort_desc(reviews.time)
    picked = np.concatenate([
        _head_by_group(latest, reviews.user, num_reviews),
        _head_by_group(latest, reviews.item, num_reviews)])
    keys = reviews.item[picked] * n_u + reviews.user[picked]
    _, first = np.unique(keys, return_index=True)
    top = picked[first]
    top_items, top_users = reviews.item[top], reviews.user[top]
    top_vecs = vectors[top]

    items_as_avg_reviews = _mean_by_group(top_items, top_vecs, base.n_items)
    users_as_avg_reviews = _mean_by_group(top_users, top_vecs, base.n_users)
    users_as_avg_desc = _mean_by_group(top_users, items_as_desc[top_items],
                                       base.n_users)

    pop_u = _popularity(reviews.user, base.n_users, popularity_mode)
    pop_i = _popularity(reviews.item, base.n_items, popularity_mode)

    pair_items = reviews.item.astype(np.int32)
    pair_users = reviews.user.astype(np.int32)
    order = np.lexsort((pair_users, pair_items))
    pair_items, pair_users = pair_items[order], pair_users[order]
    pair_item_ptr = np.searchsorted(
        pair_items, np.arange(base.n_items + 1)).astype(np.int32)

    return LTRData(
        **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
        items_as_desc=items_as_desc,
        items_as_avg_reviews=items_as_avg_reviews,
        users_as_avg_reviews=users_as_avg_reviews,
        users_as_avg_desc=users_as_avg_desc,
        popularity_users=pop_u, popularity_items=pop_i, text_dim=dim,
        review_pair_items=pair_items, review_pair_users=pair_users,
        review_pair_item_ptr=pair_item_ptr,
        review_pair_vectors=vectors[order].astype(np.float32))
