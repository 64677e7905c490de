"""Offline preprocessing: raw Amazon per-category JSON -> clean TSVs.

    python -m textgcn_tpu_torch.data.preprocess <domain_dir> [seed]

Counterpart of ``textgcn_tpu/data/preprocess.py`` without pandas or
scikit-learn, writing the same bytes:

* metadata: keep {title, description, asin}, the first row of each asin,
  join list descriptions, clean both texts, drop a row with a missing
  value or one of ``NA_VALUES``;
* reviews: keep {reviewText, reviewerID, asin, unixReviewTime, overall}
  of known asins, the first row of each (user, asin), the rating as an
  int (``5.0`` -> ``5``), drop rows with a missing or NA value, 5-core,
  clean the review text;
* ``sync(n=13)``: 13-core and asin intersection to a fixpoint;
* split: users with 3 rows or more, 80/20 stratified by user, drawn as
  scikit-learn draws it (``data/split.py``);
* ``meta_synced.tsv``, ``reviews_text.tsv``, ``train.tsv``, ``test.tsv``
  and the summary lines.

A table is a dict of columns (lists), in pandas' column order; its
``kinds`` are the dtypes pandas infers for them (``data/tsv.py``), which
decide how numbers are written.
"""

from __future__ import annotations

import html
import json
import os
import re
import string
import sys
import unicodedata

import numpy as np

from .split import keep_frequent, stratified_split
from .tsv import as_kind, column_kind, format_column, is_missing, write_table

_PRINTABLE = string.punctuation + string.ascii_letters + string.digits + ' '
_UNPRINTABLE = re.compile(f'[^{re.escape(_PRINTABLE)}]')
_HTML_TAG = re.compile(r'<[^<]+?>')
_WS = re.compile(r'[\s_]+')

# strings that read as missing after cleaning: the JAX package's list
_NA_FAMILIES = (
    ('',),
    ('NA', 'N/A', 'n/a', '<NA>', 'NULL', 'null'),
    ('NaN', 'nan', '-NaN', '-nan'),
    ('#NA', '#N/A', '#N/A N/A'),
    ('1.#IND', '-1.#IND', '1.#QNAN', '-1.#QNAN'),
)
NA_VALUES = [s for family in _NA_FAMILIES for s in family]
_NA_SET = frozenset(NA_VALUES)


class Table:
    """Columns of Python values with the dtype pandas gives each."""

    def __init__(self, columns: dict[str, list], kinds: dict[str, str]):
        self.columns = columns
        self.kinds = kinds

    @classmethod
    def from_records(cls, records: list[dict], fields) -> 'Table':
        """``pd.DataFrame(records)`` for records with keys ``fields``."""
        columns, kinds = {}, {}
        for f in fields:
            values = [r[f] for r in records]
            kinds[f] = column_kind(values)
            columns[f] = as_kind(values, kinds[f])
        return cls(columns, kinds)

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()), []))

    def take(self, mask) -> 'Table':
        """The rows where ``mask`` is true, in order."""
        mask = np.asarray(mask, dtype=bool)
        return Table({c: [v for v, k in zip(vs, mask) if k]
                      for c, vs in self.columns.items()}, dict(self.kinds))

    def rows(self, index) -> 'Table':
        """The rows at ``index``, in its order (``.iloc``)."""
        return Table({c: [vs[i] for i in index]
                      for c, vs in self.columns.items()}, dict(self.kinds))

    def first_of(self, keys) -> 'Table':
        """``drop_duplicates(subset=keys)``: the first row of each key;
        missing values are one key."""
        seen, mask = set(), []
        for row in zip(*(self.columns[k] for k in keys)):
            key = tuple(None if is_missing(v) else v for v in row)
            mask.append(key not in seen)
            seen.add(key)
        return self.take(mask)

    def without_na(self) -> 'Table':
        """``.replace(NA_VALUES, np.nan).dropna()``: drop every row with a
        missing value or an ``NA_VALUES`` string in any column."""
        def bad(v):
            return is_missing(v) or (isinstance(v, str) and v in _NA_SET)
        mask = [not any(bad(v) for v in row)
                for row in zip(*self.columns.values())]
        return self.take(mask)

    def write(self, path: str):
        """``to_csv(path, sep='\\t', index=False)``."""
        write_table(path, list(self.columns),
                    [format_column(vs, self.kinds[c])
                     for c, vs in self.columns.items()])


def clean_text(s) -> str:
    """Normalize one text field: ASCII-fold, HTML-unescape, strip tags,
    drop non-printables, collapse whitespace and underscores, strip
    leading punctuation; 5 characters or fewer become empty."""
    if not isinstance(s, str):
        return ''
    s = unicodedata.normalize('NFKD', s)
    s = s.encode('ascii', 'ignore').decode('ascii')
    s = html.unescape(s)
    s = _HTML_TAG.sub('', s)
    s = _UNPRINTABLE.sub('', s)
    s = _WS.sub(' ', s)
    s = s.lstrip(string.punctuation)
    return s if len(s) > 5 else ''


def _iter_json(path: str):
    with open(path, 'r') as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def _as_text(v, kind: str) -> str:
    """``str`` of a description as pandas holds it (a float column's
    values are floats)."""
    return str(float(v) if kind == 'float' else v)


def process_metadata(path: str) -> Table:
    fields = ['title', 'description', 'asin']
    records = [{k: row[k] for k in fields} for row in _iter_json(path)
               if all(k in row for k in fields)]
    df = Table.from_records(records, fields).first_of(['asin'])
    kind = df.kinds['description']
    desc = [' '.join(d) if isinstance(d, list) else _as_text(d, kind)
            for d in df.columns['description']]
    df.columns['description'] = [clean_text(d) for d in desc]
    df.columns['title'] = [clean_text(t) for t in df.columns['title']]
    df.kinds.update(description='object', title='object')
    return df.without_na()


def core_n(df: Table, n: int = 5, columns=('asin', 'user_id')) -> Table:
    """Prune rows until every value of each key column occurs ``n`` times
    or more (to a fixpoint: dropping a user can drop an item below the
    threshold and the other way round)."""
    while True:
        keep = np.ones(len(df), bool)
        for col in columns:
            keep &= keep_frequent(df.columns[col], n)
        if keep.all():
            return df
        df = df.take(keep)


def process_reviews(path: str, available_asins: set) -> Table:
    fields = ['reviewText', 'reviewerID', 'asin', 'unixReviewTime',
              'overall']
    names = {'reviewText': 'review', 'reviewerID': 'user_id',
             'unixReviewTime': 'time', 'overall': 'rating'}
    records = [{names.get(k, k): row[k] for k in fields}
               for row in _iter_json(path)
               if all(k in row for k in fields)
               and row['asin'] in available_asins]
    df = Table.from_records(records, [names.get(k, k) for k in fields])
    df = df.first_of(['user_id', 'asin'])
    # astype({'rating': int}): a float is truncated, 5.0 -> 5
    df.columns['rating'] = [int(v) for v in df.columns['rating']]
    df.kinds['rating'] = 'int'
    df = core_n(df.without_na(), n=5)
    df.columns['review'] = [clean_text(r) for r in df.columns['review']]
    df.kinds['review'] = 'object'
    return df


def sync(meta: Table, reviews: Table, n: int = 1):
    """Restrict meta and reviews to a shared asin universe on which the
    reviews also satisfy the n-core, alternating the two steps until a
    pass removes nothing."""
    while True:
        rows_before = len(meta) + len(reviews)
        if n > 1:
            reviews = core_n(reviews, n)
        shared = set(meta.columns['asin']).intersection(
            reviews.columns['asin'])
        meta = meta.take([a in shared for a in meta.columns['asin']])
        reviews = reviews.take([a in shared
                                for a in reviews.columns['asin']])
        if len(meta) + len(reviews) == rows_before:
            return meta, reviews


def train_test_split(df: Table, column: str = 'user_id',
                     train_size: float = 0.8, seed: int = 42):
    """Users with 3 rows or more, split ``train_size`` stratified by
    ``column``: ``(train, test)`` in scikit-learn's row order."""
    df = df.take(keep_frequent(df.columns[column]))
    train, test = stratified_split(df.columns[column], train_size, seed)
    return df.rows(train), df.rows(test)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print('usage: python -m textgcn_tpu_torch.data.preprocess <domain> '
              '[seed]')
        sys.exit(1)
    domain = argv[0].rstrip('/')
    seed = int(argv[1]) if len(argv) > 1 else 42

    meta = process_metadata(os.path.join(
        domain, f'meta_{os.path.basename(domain)}.json'))
    reviews = process_reviews(
        os.path.join(domain, f'{os.path.basename(domain)}.json'),
        available_asins=set(meta.columns['asin']))

    meta, reviews = sync(meta, reviews, n=13)
    meta.write(os.path.join(domain, 'meta_synced.tsv'))
    reviews.write(os.path.join(domain, 'reviews_text.tsv'))

    train, test = train_test_split(reviews, seed=seed)
    train.write(os.path.join(domain, 'train.tsv'))
    test.write(os.path.join(domain, 'test.tsv'))

    summary = {
        'reviews': len(reviews),
        'users': len(set(reviews.columns['user_id'])),
        'items': len(set(reviews.columns['asin'])),
        'train': len(train),
        'test': len(test),
    }
    for name, count in summary.items():
        print(f'{name + ":":<9}{count:>7}')


if __name__ == '__main__':
    main()
