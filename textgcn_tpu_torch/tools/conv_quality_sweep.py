"""Quality of the trained models at 50k x 20k on the sharp instrument.

    python -m textgcn_tpu_torch.tools.conv_quality_sweep [--data DIR]
        [--models lgcn:0,gcn:0,...] [--epochs 60] [--evaluate_every 5]
        [--lr 0.005]

Counterpart of the JAX package's ``tools/conv_quality_sweep.py``: it
writes the sharp set with the port's generator when ``DIR`` has no
``train.tsv`` (``make_synthetic DIR 50000 20000 0 --sharp``), then for
each ``model:seed`` runs ``python -m textgcn_tpu_torch`` (the card unless
``TEXTGCN_TPU_PLATFORM=cpu``) with the sweep's configuration: 60 epochs,
lr 0.005, an evaluation every 5 epochs (and the early stop), ``--aggr
mean`` for the convs, the other flags at their defaults.  The best value
of each metric at k = 20 and 40 comes from the run's
``resume_state.pkl``; one JSON row per run goes to stdout, with the
number of evaluations, the epochs run and the wall time.  A failed run is
reported with its error, not retried.  Runs are written under
``<cwd>/runs/<basename DIR>/qsweep-<model>-s<seed>``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

DEFAULT_RUNS = ('lgcn:0,gcn:0,gcn:1,gcn:2,gat:0,gat:1,gat:2,'
                'graphsage:0,gatv2:0')
CONVS = ('gcn', 'graphsage', 'gat', 'gatv2')
KS = (20, 40)
# the directory that holds the package, for the runs' ``python -m``
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def best_metrics(run_dir: str) -> dict:
    """Best value per (metric, k) over the run's evaluations, their
    number and the last epoch trained, from ``resume_state.pkl``."""
    with open(os.path.join(run_dir, 'resume_state.pkl'), 'rb') as f:
        state = pickle.load(f)
    hist = state['metrics']            # {name: (n_evals, n_k)}
    out = {}
    for name, rows in hist.items():
        for j, k in enumerate(KS):
            out[f'{name}@{k}'] = float(rows[:, j].max()) \
                if len(rows) else float('nan')
    out['n_evals'] = int(len(hist['recall']))
    out['epochs_run'] = int(state['epoch'])
    return out


def run_argv(model: str, seed: str, data: str, epochs: int,
             evaluate_every: int, lr: float) -> list[str]:
    """The CLI flags of one sweep run."""
    argv = ['--model', model, '--data', data, '--epochs', str(epochs),
            '--evaluate_every', str(evaluate_every), '--lr', str(lr),
            '--seed', seed, '--uid', f'qsweep-{model}-s{seed}', '--quiet']
    if model in CONVS:
        argv += ['--aggr', 'mean']
    return argv


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument('--data', default=os.path.join('build', 'sharp50k'))
    ap.add_argument('--users', type=int, default=50_000)
    ap.add_argument('--items', type=int, default=20_000)
    ap.add_argument('--models', default=DEFAULT_RUNS,
                    help='comma list of model:seed pairs, run in order')
    ap.add_argument('--epochs', type=int, default=60)
    ap.add_argument('--evaluate_every', type=int, default=5)
    ap.add_argument('--lr', type=float, default=0.005)
    args = ap.parse_args(argv)

    if not os.path.exists(os.path.join(args.data, 'train.tsv')):
        print(f'# generating the sharp set at {args.data}', file=sys.stderr)
        from .make_synthetic import generate
        generate(args.data, args.users, args.items, seed=0, sharp=True)

    base = os.path.basename(os.path.normpath(args.data))
    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ''))
    rows = []
    for pair in args.models.split(','):
        model, seed = pair.split(':')
        cmd = [sys.executable, '-m', 'textgcn_tpu_torch',
               *run_argv(model, seed, args.data, args.epochs,
                         args.evaluate_every, args.lr)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env)
        wall = time.perf_counter() - t0
        row = {'model': model, 'seed': int(seed), 'wall_s': round(wall, 1)}
        if r.returncode != 0:
            row['error'] = (r.stderr or r.stdout)[-2000:]
        else:
            row.update(best_metrics(os.path.join(
                'runs', base, f'qsweep-{model}-s{seed}')))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == '__main__':
    main()
