"""Evaluation and serving runtime.

Counterpart of ``textgcn_tpu/train/trainer.py`` for the serving path:

* ``load``: a file or a run dir (``best.pkl``), re-evaluated at once,
  then the metrics history is reset;
* ``evaluate``: masked full-catalogue top-k over the test users and the
  five metrics per k;
* ``predict``: ranked items (+ scores rounded to 4 decimals) for any user
  list, optionally written to ``predictions.tsv`` with external ids, in
  the bytes pandas writes for the JAX package;
* ``export_reprs``: the propagated tables as ``.npy``.

Each ``evaluate``/``predict``/``export_reprs`` call propagates once, as
the JAX package's eval function does.  ``fit`` is not ported yet.
"""

from __future__ import annotations

import csv
import logging
import os

import numpy as np
import torch

from ..config import Config
from ..data.core import InteractionData
from ..ops import metrics as metrics_mod
from ..weights import params_from_jax
from .checkpoint import make_checkpointer

log = logging.getLogger('textgcn_tpu_torch')


class Trainer:

    def __init__(self, cfg: Config, model, data: InteractionData):
        self.cfg = cfg
        self.model = model
        self.data = data
        self.k = tuple(sorted(cfg.k))
        if data.n_items <= max(self.k):
            raise ValueError(f'all k must be less than number of items '
                             f'({data.n_items}), got k={list(self.k)}')
        self.metrics_names = list(metrics_mod.METRICS)
        self.metrics_logger = {m: np.zeros((0, len(self.k)))
                               for m in self.metrics_names}
        self.last_metrics: dict[str, list[float]] | None = None

    def fit(self):
        raise NotImplementedError('training (fit) is not ported yet')

    def evaluate(self) -> dict[str, list[float]]:
        """Metrics of the current tables over the test users; also kept in
        ``last_metrics``."""
        preds, _ = self._predict_users(self.data.test_users)
        results = metrics_mod.calculate_metrics(
            preds, self.data.true_test, self.k)
        log.info(' ' * 11 + ''.join(f'@{i:<6}' for i in self.k))
        for m in self.metrics_names:
            self.metrics_logger[m] = np.append(
                self.metrics_logger[m], [results[m]], axis=0)
            log.info('%-11s' % m + ' '.join(f'{v:.4f}' for v in results[m]))
        self.last_metrics = results
        return results

    def _predict_users(self, users: np.ndarray):
        """Top-max(k) over the catalogue for ``users``: numpy (n, max_k)
        indices and values.  One propagation, then batches of
        ``batch_size`` users."""
        bs, max_k = self.cfg.batch_size, max(self.k)
        users = torch.as_tensor(np.asarray(users, np.int64),
                                device=self.model.device)
        vals, idx = [], []
        with torch.no_grad():
            reprs = self.model.representation()
            for start in range(0, len(users), bs):
                v, i = self.model.topk_for_users(
                    reprs, users[start:start + bs], max_k)
                vals.append(v)
                idx.append(i)
        if not vals:
            return (np.zeros((0, max_k), np.int64),
                    np.zeros((0, max_k), np.float32))
        return (torch.cat(idx).cpu().numpy(),
                torch.cat(vals).cpu().numpy())

    def predict(self, users, save: bool = False, with_scores: bool = False):
        """Ranked items (+ scores) for a user id list; with ``save``,
        ``predictions.tsv`` in the run directory."""
        users = np.asarray(list(users), dtype=np.int64)
        idx, vals = self._predict_users(users)
        predictions = idx.tolist()
        scores = np.round(vals, 4).tolist()
        if save:
            item_ids, user_ids = self.data.item_id_map, self.data.user_id_map
            os.makedirs(self.cfg.save_path, exist_ok=True)
            out = os.path.join(self.cfg.save_path, 'predictions.tsv')
            with open(out, 'w', newline='', encoding='utf-8') as f:
                writer = csv.writer(f, delimiter='\t', lineterminator='\n')
                writer.writerow(['user_id', 'y_pred', 'scores'])
                for u, row, s in zip(users.tolist(), predictions, scores):
                    writer.writerow([user_ids[u],
                                     str([item_ids[i] for i in row]),
                                     str(s)])
            log.info('Predictions are saved in `%s`', out)
        if with_scores:
            return predictions, scores
        return predictions

    def export_reprs(self) -> dict[str, str]:
        """Write the eval-mode propagated tables as ``users_repr.npy`` and
        ``items_repr.npy`` in the run directory; returns {name: path}."""
        with torch.no_grad():
            users_repr, items_repr = self.model.representation()
        os.makedirs(self.cfg.save_path, exist_ok=True)
        paths = {}
        for name, arr in (('users_repr', users_repr),
                          ('items_repr', items_repr)):
            path = os.path.join(self.cfg.save_path, f'{name}.npy')
            np.save(path, arr.cpu().numpy())
            paths[name] = path
        log.info('Exported representations to %s: items_repr, users_repr',
                 self.cfg.save_path)
        return paths

    def load(self, load_path: str):
        log.info('Loading model %s', load_path)
        state = make_checkpointer(self.cfg.ckpt_backend).load(load_path)
        params = params_from_jax(state['params'], self.model.n_users,
                                 self.model.n_items, self.model.device)
        self.model.load_tables(params['user_emb'], params['item_emb'])
        log.info('Performance of the loaded model:')
        self.evaluate()
        self.metrics_logger = {m: np.zeros((0, len(self.k)))
                               for m in self.metrics_names}
