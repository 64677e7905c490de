"""Semantic-loss knob sweep on the cold-start instrument.

Counterpart of the JAX package's ``tools/sem_cold_sweep.py``, with the
same grid, run names, flags and table: the text models' ``--weight``/
``--distance``/``--dist_fn`` tables (reference
``text_base_model.py:45-62``) on a ``make_synthetic --sharp --cold 0.2``
set (5,000 users x 2,000 items, seed 0; ``--quick``: 400 x 300, 6
epochs), each run trained from scratch through the port's ``cli.main``
(lr 5e-3, 60 epochs) and scored at its warm-selected best checkpoint by
``tools/cold_report``.  The ``lgcn`` base and the default-knob run come
first as in-sweep controls.  One JSON row a run, then the runs ranked by
cold recall@40, then ``{"rows": [...]}``.

Usage (the text from the stub encoder unless
``TEXTGCN_TPU_TEXT_ENCODER`` says otherwise)::

    python -m textgcn_tpu_torch.tools.sem_cold_sweep [--data DIR]
        [--runs DIR] [--epochs 60] [--quick] [--rows N]

``--rows N`` runs the base and the first N rows of the grid only.  Runs
land in ``<runs>/runs/<data name>/<run name>/`` (a finished run, one with
``best.pkl``, is scored again, not retrained).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

GRID = [
    # (weight, distance, dist_fn) — first row is the r3 default control
    ('1', '|b-g|', 'euclid'),
    ('1', 'max(g-b)', 'euclid'),
    ('1', 'selu(g-b)', 'euclid'),
    ('1', '(g-b)', 'euclid'),
    ('1', 'max(b-g)', 'euclid'),
    ('max(p-n)', 'max(g-b)', 'euclid'),
    ('max(p-n)', '|b-g|', 'euclid'),
    ('|p-n|', 'max(g-b)', 'euclid'),
    ('1', 'max(g-b)', 'cosine_minus'),
    ('1', '|b-g|', 'cosine_minus'),
]


def run_name(model: str, weight: str, distance: str, dist_fn: str) -> str:
    """The JAX tool's run name of a grid row."""
    return f'{model}_w{weight}_d{distance}_f{dist_fn}' \
        .replace('|', 'A').replace('(', '').replace(')', '') \
        .replace('-', 'm').replace(' ', '')


def main(argv=None) -> list[dict]:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument('--data', default=os.path.join(tmp, 'coldsweep_data'))
    ap.add_argument('--runs', default=os.path.join(tmp, 'coldsweep_runs'))
    ap.add_argument('--users', type=int, default=5000)
    ap.add_argument('--items', type=int, default=2000)
    ap.add_argument('--epochs', type=int, default=60)
    ap.add_argument('--lr', type=float, default=5e-3)
    ap.add_argument('--quick', action='store_true',
                    help='tiny shapes + few epochs (smoke test)')
    ap.add_argument('--model', default='kg')
    ap.add_argument('--rows', type=int, default=len(GRID),
                    help='run the base and the first ROWS grid rows')
    args = ap.parse_args(argv)

    os.environ.setdefault('TEXTGCN_TPU_TEXT_ENCODER', 'stub')
    # resolved before the chdir below, so relative --data keeps working
    args.data = os.path.abspath(args.data)
    if args.quick:
        args.users, args.items, args.epochs = 400, 300, 6

    if not os.path.exists(os.path.join(args.data, 'train.tsv')):
        from .make_synthetic import generate
        generate(args.data, n_users=args.users, n_items=args.items,
                 seed=0, sharp=True, cold=0.2)

    from ..cli import main as cli_main
    from . import cold_report

    base_args = ['--data', args.data, '--batch_size', '2048',
                 '--emb_size', '64', '--n_layers', '3',
                 '-k', '20', '40', '--lr', str(args.lr),
                 '--evaluate_every', '10', '--quiet']

    # save_path is derived as runs/<dataset>/<uid> under the cwd
    os.makedirs(args.runs, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(args.runs)
    dataset = os.path.basename(os.path.normpath(args.data))

    def one(name, model, extra):
        run_dir = os.path.join('runs', dataset, name)
        if not os.path.exists(os.path.join(run_dir, 'best.pkl')):
            cli_main(base_args + ['--model', model, '--epochs',
                                  str(args.epochs), '--uid', name] + extra)
        res = cold_report.main(
            base_args + ['--model', model, '--load', run_dir,
                         '--uid', f'{name}_report'] + extra)
        row = {
            'name': name,
            'warm_r20': float(res['warm']['recall'][0]),
            'warm_r40': float(res['warm']['recall'][1]),
            'cold_r40': float(res['cold']['recall'][1]),
            'cold_ndcg40': float(res['cold']['ndcg'][1]),
        }
        print(json.dumps(row))
        return row

    try:
        rows = [one('base_lgcn', 'lgcn', [])]
        for weight, distance, dist_fn in GRID[:args.rows]:
            rows.append(one(run_name(args.model, weight, distance, dist_fn),
                            args.model,
                            ['--weight', weight, '--distance', distance,
                             '--dist_fn', dist_fn]))
    finally:
        os.chdir(cwd)

    rows.sort(key=lambda r: -r['cold_r40'])
    print('\n== ranked by cold recall@40 ==')
    for r in rows:
        print(f"{r['name']:42s} cold_r40={r['cold_r40']:.4f} "
              f"cold_ndcg40={r['cold_ndcg40']:.4f} "
              f"warm_r20={r['warm_r20']:.4f} warm_r40={r['warm_r40']:.4f}")
    print(json.dumps({'rows': rows}))
    return rows


if __name__ == '__main__':
    main()
