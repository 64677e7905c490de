"""Cold-start split report over a trained checkpoint.

Counterpart of the JAX package's ``tools/cold_report.py``: evaluates one
checkpoint on the warm-item and cold-item halves of a ``make_synthetic
--sharp --cold F`` dataset's held-out pairs (the cold items are the
external ids in ``<data>/cold_items.txt``).  One ranking pass over all
test users; the metrics of ``all``, ``warm`` (each user's warm test items;
users with none left out) and ``cold`` (the same with the cold items).

Usage (every flag is the CLI's; ``--no_train --no_save`` are added)::

    python -m textgcn_tpu_torch.tools.cold_report --model ltr_linear \\
        --data /tmp/cold20k --load runs/cold20k/ltr --uid cold_report
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..cli import main as cli_main
from ..ops import metrics as metrics_mod


def split_eval(trainer, cold: set[int]) -> dict[str, dict]:
    """``{'all' | 'warm' | 'cold': metrics}`` from one ranking pass over
    the test users; ``cold`` holds internal item ids."""
    data = trainer.data
    preds, _ = trainer._predict_users(data.test_users)
    out = {'all': metrics_mod.calculate_metrics(preds, data.true_test,
                                                trainer.k)}
    for name in ('warm', 'cold'):
        want_cold = name == 'cold'
        true_split = [[i for i in row if (i in cold) == want_cold]
                      for row in data.true_test]
        mask = np.fromiter((len(t) > 0 for t in true_split), bool,
                           count=len(true_split))
        out[name] = metrics_mod.calculate_metrics(
            preds[mask], [t for t in true_split if t], trainer.k)
    return out


def cold_item_ids(trainer) -> set[int]:
    """The internal ids of ``<data>/cold_items.txt``'s items that the
    dataset holds."""
    with open(os.path.join(trainer.cfg.data, 'cold_items.txt')) as f:
        cold_ext = set(f.read().split())
    return {i for i, ext in trainer.data.item_id_map.items()
            if ext in cold_ext}


def main(argv=None) -> dict[str, dict]:
    argv = list(sys.argv[1:] if argv is None else argv)
    trainer = cli_main(argv + ['--no_train', '--no_save'])
    cold = cold_item_ids(trainer)
    results = split_eval(trainer, cold)
    cfg, ks = trainer.cfg, trainer.k
    print(f'# cold_report model={cfg.model} data={cfg.data} '
          f'load={cfg.load} cold_items={len(cold)}')
    print('split      ' + ''.join(f'{m}@{k:<8}' for m in ('recall', 'ndcg')
                                  for k in ks))
    for split, res in results.items():
        row = ''.join(f'{v:<{10 + len(str(k))}.4f}'
                      for m in ('recall', 'ndcg')
                      for k, v in zip(ks, res[m]))
        print(f'{split:<11}{row}')
    return results


if __name__ == '__main__':
    main()
