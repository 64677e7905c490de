"""Readings that set the limits of ``correct``: one process, many seeds.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 \
        [--mode control|unchanged|half_batch|answer_altered|candidates_all|
                candidates_fixed|positives_fixed] \
        [--seconds S]

Each seed is a whole run of the cell (``harness.run``, untraced) with the
program as configured, or the control in its place, or a fault planted;
one JSON line a seed with the numbers compared.  Run it on the chip at
the cell's size; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from . import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--mode', default=None)
    p.add_argument('--seconds', type=float, default=0.5)
    p.add_argument('--device', default='cuda:0')

    args = p.parse_args(argv)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        try:
            r = harness.run(args.workload, seed, args.seconds, False,
                            device=args.device, mode=args.mode)
        except Exception:  # one seed's failure is a reading too
            traceback.print_exc()
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'mode': args.mode, 'error': True}), flush=True)
            rc = 1
            continue
        print(json.dumps({
            'workload': args.workload, 'seed': seed, 'mode': args.mode,
            'correct': r['correct'], 'seconds': time.perf_counter() - t0,
            'metrics': {k: v['value'] for k, v in r['metrics'].items()},
            'checks': {k: v['value'] for k, v in r['checks'].items()}}),
            flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main())
