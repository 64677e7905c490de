"""Tab-separated tables as pandas reads and writes them, without pandas.

The JAX package reads its TSVs with ``pd.read_table(path, dtype=str)``
and writes them with ``DataFrame.to_csv(path, sep='\\t', index=False)``.
The port's data tools write the same bytes:

* ``write_table``: the stdlib ``csv`` writer that pandas itself drives
  (tab, ``'\\n'``, ``QUOTE_MINIMAL``); a missing value is an empty field;
* ``read_table``: every field a string, pandas' default NA sentinels
  (``NA_STRINGS``) read as missing (``None``), blank lines skipped, a
  short row padded with missing values;
* ``format_column``: the text pandas writes for a column of Python
  values, after the dtype pandas infers for it (``column_kind``).
"""

from __future__ import annotations

import csv
import math

import numpy as np

# pandas' default read-time NA sentinels (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset((
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'))


def is_missing(v) -> bool:
    """``None`` or a float NaN: what pandas' ``isna`` calls missing."""
    return v is None or (isinstance(v, float) and math.isnan(v))


def read_table(path: str) -> tuple[list[str], list[list[str | None]]]:
    """``(header, rows)`` of a TSV, as ``pd.read_table(path, dtype=str)``
    reads it: fields are strings, NA sentinels are ``None``."""
    with open(path, newline='', encoding='utf-8') as f:
        reader = csv.reader(f, delimiter='\t')
        header = next(reader)
        width = len(header)
        rows = []
        for line_no, r in enumerate(reader, start=2):
            if not r:
                continue
            if len(r) > width:
                raise ValueError(f'{path}:{line_no}: expected {width} '
                                 f'fields, saw {len(r)}')
            r = [None if v in NA_STRINGS else v for v in r]
            rows.append(r + [None] * (width - len(r)))
    return header, rows


def column_kind(values) -> str:
    """The dtype pandas infers for a column built from Python objects
    (``pd.DataFrame(list_of_dicts)``): ``'bool'``, ``'int'``,
    ``'float'`` (numbers with a missing value among them) or
    ``'object'``."""
    present = [v for v in values if not is_missing(v)]
    if not present:
        return 'object'
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        return 'bool' if len(present) == len(values) else 'object'
    numeric = [v for v in present if isinstance(v, (int, float, np.integer,
                                                    np.floating))
               and not isinstance(v, (bool, np.bool_))]
    if len(numeric) != len(present):
        return 'object'
    if len(present) == len(values) and all(
            isinstance(v, (int, np.integer)) and -2**63 <= v < 2**63
            for v in present):
        return 'int'
    return 'float'


def as_kind(values, kind: str) -> list:
    """The column's values as pandas holds them under ``kind``: floats
    (missing ones NaN) for ``'float'``, the Python objects otherwise."""
    if kind == 'float':
        return [math.nan if is_missing(v) else float(v) for v in values]
    return list(values)


def format_column(values, kind: str = 'object') -> list[str]:
    """The text ``to_csv`` writes for each value: a missing value as an
    empty field, a float column through numpy's ``astype(str)`` (pandas'
    path), anything else through ``str``."""
    if kind == 'float':
        arr = np.asarray(values, dtype=np.float64)
        text = arr.astype(str).tolist()
        return ['' if math.isnan(v) else t for v, t in zip(arr.tolist(),
                                                           text)]
    return ['' if is_missing(v) else str(v) for v in values]


def write_rows(path: str, header, rows) -> None:
    """Write ``rows`` (tuples of strings, ``None`` for a missing value)
    as ``to_csv(path, sep='\\t', index=False)`` writes a DataFrame."""
    with open(path, 'w', newline='', encoding='utf-8') as f:
        writer = csv.writer(f, delimiter='\t', lineterminator='\n',
                            quoting=csv.QUOTE_MINIMAL)
        writer.writerow(header)
        writer.writerows(rows)


def write_table(path: str, header, columns) -> None:
    """``write_rows`` for one list of strings per header field."""
    write_rows(path, header, zip(*columns))
