"""Training, evaluation and serving runtime.

Counterpart of ``textgcn_tpu/train/trainer.py`` on one device:

* ``fit``: the epoch loop.  Each epoch samples its BPR triples on the
  device, then each batch runs one full-graph propagation with hash edge
  dropout (fresh salts per step from the trainer's generator), the BPR +
  L2 loss, its backward and an Adam step.  The loss components are summed
  on the device and fetched once per epoch, where the NaN guard runs; at
  every ``evaluate_every``-th epoch they are logged as the JAX package
  logs them, the model is evaluated and checkpointed, and the early stop
  is checked;
* ``checkpoint``: ``latest_checkpoint.pkl`` in the JAX package's format,
  copied to ``best.pkl`` when recall@smallest-k reaches a new maximum on
  the params it was measured on;
* ``load``: a file or a run dir (``best.pkl``), re-evaluated at once,
  then the metrics history is reset; before ``fit`` it warm-starts the
  tables (and conv layers) as the JAX package's ``Trainer.load`` does;
* ``evaluate``: masked full-catalogue top-k over the test users and the
  five metrics per k;
* ``predict``: ranked items (+ scores rounded to 4 decimals) for any user
  list, optionally written to ``predictions.tsv`` with external ids, in
  the bytes pandas writes for the JAX package;
* ``export_reprs``: the propagated tables as ``.npy``.

Each ``evaluate``/``predict``/``export_reprs`` call propagates once, as
the JAX package's eval function does.

On a mesh (``model.mesh``) every rank runs the same loop: the same epochs
and salts from the same seeds, its part of each batch (``model.loss``),
Adam on its rows (elementwise, so it is the global Adam), the loss sums
all-reduced once an epoch, the catalogue-sharded top-k.  Every rank
computes the metrics; logs, ``predictions.tsv``, exports and checkpoints
come from rank 0 only, after the collectives that gather the tables
(``trainer.py:244, 407, 499, 527, 577`` in the JAX package).

Not ported yet: ``--resume`` (its ``resume_state.pkl``), the SIGTERM
stop, cached propagation (``--refresh_every``) and ``--steps_per_call``.
"""

from __future__ import annotations

import csv
import logging
import os
import time

import numpy as np
import torch

from ..config import Config
from ..data.core import InteractionData
from ..ops import metrics as metrics_mod
from ..parallel.multihost import is_primary
from ..parallel.sharded import all_reduce_sum
from ..weights import params_from_jax, params_to_jax
from .checkpoint import make_checkpointer

log = logging.getLogger('textgcn_tpu_torch')


class Trainer:

    def __init__(self, cfg: Config, model, data: InteractionData):
        """``model``'s device is the trainer's.  Its generators are seeded
        from ``cfg.seed``: one on the device draws the epochs' samples,
        one on the host draws the per-step dropout salts (so no step waits
        for the device to hand them back)."""
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
        self.loss_history: list[dict[str, float]] = []
        self.optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
        self.generator = torch.Generator(device=model.device).manual_seed(
            cfg.seed)
        self.salt_generator = torch.Generator().manual_seed(cfg.seed + 1)
        self._checkpointer = make_checkpointer(cfg.ckpt_backend)
        self.primary = is_primary()
        # the epoch whose metrics row describes the params as they are
        # now: best.pkl is promoted only from a checkpoint at that epoch
        self._last_eval_epoch: int | None = None

    # ------------------------------------------------------------------
    # training

    def train_step(self, batch, w_pairs):
        """One Adam step on ``batch`` with the dropout salts ``w_pairs``;
        returns the loss and its components, detached, on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.model.loss(batch, w_pairs=w_pairs)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), {c: v.detach() for c, v in aux.items()}

    def train_epoch(self) -> dict[str, torch.Tensor]:
        """Sample an epoch, step through its batches; the sums of the loss
        and its components stay on the device."""
        model = self.model
        batches = model.sample_batches(self.generator, self.cfg.batch_size)
        losses = []
        comps = {c: [] for c in self.model.loss_components}
        for batch in batches:
            w_pairs = model.graph_op.weights(self.salt_generator,
                                             model.dropout)
            loss, aux = self.train_step(batch, w_pairs)
            losses.append(loss)
            for c in comps:
                comps[c].append(aux[c])
        sums = {c: torch.stack(v).sum() for c, v in comps.items()}
        sums['loss'] = torch.stack(losses).sum()
        if model.mesh is not None:
            # each rank's losses are its share of each batch's
            summed = all_reduce_sum(torch.stack(list(sums.values())))
            sums = dict(zip(sums, summed))
        return sums

    def _finish_epoch(self, epoch: int, sums) -> dict[str, float]:
        """Fetch one epoch's sums and guard against a NaN loss (the JAX
        package checks once per epoch too)."""
        sums = {c: float(v) for c, v in sums.items()}
        if np.isnan(sums['loss']):
            raise FloatingPointError(f'loss is NA at epoch {epoch}')
        log.debug('Epoch %d: %s', epoch, self._format_components(sums))
        return sums

    def _format_components(self, sums) -> str:
        return ' '.join(f'{c} = {sums[c]:.4f}'
                        for c in self.model.loss_components)

    def fit(self) -> list[dict[str, float]]:
        """Train for ``cfg.epochs`` with eval, checkpoint and early stop
        every ``evaluate_every`` epochs; returns each epoch's loss sums
        (also kept in ``loss_history``)."""
        cfg = self.cfg
        history = self.loss_history = []
        t0 = time.time()
        t_window, n_window = time.perf_counter(), 0
        stopped = False
        for epoch in range(1, cfg.epochs + 1):
            sums = self._finish_epoch(epoch, self.train_epoch())
            history.append(sums)
            n_window += 1
            if epoch % cfg.evaluate_every:
                continue
            eps = (self.model.iterable_len * n_window
                   / (time.perf_counter() - t_window))
            log.info('Epoch %d: %s (%.0f examples/s, %.1fs)', epoch,
                     self._format_components(sums), eps, time.time() - t0)
            self.evaluate(epoch)
            self.checkpoint(epoch)
            t_window, n_window = time.perf_counter(), 0
            if metrics_mod.early_stop(self.metrics_logger):
                log.warning('Early stopping triggerred at epoch %d', epoch)
                stopped = True
                break
        if not stopped and cfg.epochs % cfg.evaluate_every:
            # the last epoch was no eval epoch: save latest only
            self.checkpoint(cfg.epochs)
        return history

    def checkpoint(self, epoch: int):
        if not self.cfg.save:
            return
        state = {'params': params_to_jax(self.model.param_tree()),
                 'epoch': epoch, 'model': self.cfg.model}
        if not self.primary:
            return
        self._checkpointer.save_latest(self.cfg.save_path, state)
        first = self.metrics_logger[self.metrics_names[0]]
        if len(first) and first[:, 0].max() == first[-1][0] \
                and epoch == self._last_eval_epoch:
            log.info('Updating best model at epoch %d', epoch)
            self._checkpointer.promote_best(self.cfg.save_path)

    # ------------------------------------------------------------------
    # evaluation and serving

    def evaluate(self, epoch: int | None = None) -> dict[str, list[float]]:
        """Metrics of the current tables over the test users; also kept in
        ``last_metrics``."""
        self._last_eval_epoch = epoch
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
            reprs = self.model.scoring_reprs()
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
        if save and self.primary:
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
        model = self.model
        with torch.no_grad():
            users_repr, items_repr = model.representation()
            users_repr = model.gathered(users_repr, model.n_users)
            items_repr = model.gathered(items_repr, model.n_items)
        paths = {}
        for name, arr in (('users_repr', users_repr),
                          ('items_repr', items_repr)):
            path = os.path.join(self.cfg.save_path, f'{name}.npy')
            if self.primary:
                os.makedirs(self.cfg.save_path, exist_ok=True)
                np.save(path, arr.cpu().numpy())
            paths[name] = path
        log.info('Exported representations to %s: items_repr, users_repr',
                 self.cfg.save_path)
        return paths

    def load(self, load_path: str):
        log.info('Loading model %s', load_path)
        state = self._checkpointer.load(load_path)
        params = params_from_jax(state['params'], self.model.n_users,
                                 self.model.n_items, self.model.device)
        self.model.load_params(params)
        log.info('Performance of the loaded model:')
        self.evaluate()
        self.metrics_logger = {m: np.zeros((0, len(self.k)))
                               for m in self.metrics_names}
