"""Render ``tools/conv_quality_sweep``'s rows as the RESULTS.md table.

Counterpart of the JAX package's ``tools/conv_quality_report.py``, the
same markdown for the same JSONL: the rows grouped by model, recall@20,
recall@40 and ndcg@20 as mean ± std across seeds (the mean alone for one
seed), and the margin of recall@20 over the ``lgcn`` control in sigma
units (sigma: the pooled std, at least the round-3 seed noise 3e-4).
Rows with an ``error`` go to stderr.

Usage::

    python -m textgcn_tpu_torch.tools.conv_quality_report [--in FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED_NOISE = 3e-4   # round-3 lgcn seed noise at this shape (RESULTS.md)
METRICS = ('recall@20', 'recall@40', 'ndcg@20')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--in', dest='inp', default='-')
    args = ap.parse_args(argv)
    fh = sys.stdin if args.inp == '-' else open(args.inp)
    try:
        rows = [json.loads(ln) for ln in fh if ln.strip().startswith('{')]
    finally:
        if fh is not sys.stdin:
            fh.close()
    by_model: dict[str, list[dict]] = {}
    for r in rows:
        if 'error' in r:
            print(f"# {r['model']}:{r['seed']} FAILED: "
                  f"{r['error'][:200]}", file=sys.stderr)
            continue
        by_model.setdefault(r['model'], []).append(r)

    base = np.mean([r['recall@20'] for r in by_model['lgcn']])
    print('| model | seeds | recall@20 | recall@40 | ndcg@20 | '
          'vs base (sigma units, r@20) |')
    print('|---|---|---|---|---|---|')
    for name, rs in by_model.items():
        cells = []
        for m in METRICS:
            v = np.array([r[m] for r in rs])
            cells.append(f'{v.mean():.4f} ± {v.std(ddof=0):.4f}'
                         if len(v) > 1 else f'{v.mean():.4f}')
        r20 = np.array([r['recall@20'] for r in rs])
        sigma = max(float(r20.std(ddof=0)), SEED_NOISE)
        margin = (r20.mean() - base) / sigma
        tag = '—' if name == 'lgcn' else f'{margin:+.0f}σ'
        print(f'| `{name}` | {len(rs)} | {cells[0]} | {cells[1]} | '
              f'{cells[2]} | {tag} |')


if __name__ == '__main__':
    main()
