"""Gradient-boosted LTR heads: trees over the LTR cross features.

Counterpart of ``textgcn_tpu/models/ltr_boosted.py``: ``gbdt`` and
``xgboost`` (``LTRGradientBoosted``), ``gbdt_pop`` and ``xgboost_pop``
(``LTRGradientBoostedWPop``, two popularity features more) and ``marcus``
(``MarcusGradientBoosted``), with ``BoostedTrainer``.

* The features are ``LTRLinear``'s five crosses (seven with popularity),
  each ``(B, n_items)`` plane one ``(B, d) @ (d, n_items)`` product
  (``batch_features``); the tables come from one eval-mode propagation.
* ``fit_trees`` adds 10 warm-started trees of depth 3 per batch of 256
  users, fitted on the device (``ops.trees.fit_gbrt``) on every (user,
  item) pair of the batch, labelled by the user's train items (built on
  the device).  ``marcus`` fits once on each user's positives and
  ``max(1, neg_samples)`` negatives a positive, drawn from
  ``np.random.RandomState(seed)`` in the JAX package's call order, so its
  rows are the JAX package's bit for bit.
* Neither machine has xgboost: ``xgboost``, ``xgboost_pop`` (and
  ``marcus``, which the reference forces to xgboost) log the JAX
  package's warning and fit the least-squares ensemble, as the JAX package
  falls back to scikit-learn's.  The port never uses an ``XGBRanker``.
* Serving scores every catalogue item through the forest
  (``ops.trees.forest_predict``), masks the train items and takes the top
  k with ties to the lower index (tree scores are piecewise constant: ties
  at the k-th place are the rule).  With no fitted forest it raises; there
  is no host ``predict``.  While ``score_with_head`` is off (the
  ``--load_base`` evaluation of the base) the model scores as ``lgcn``.

On a mesh (``parallel.mesh.shard_model``: the tables on K2's source
shards, the text and popularity buffers whole) the fit is replicated:
``compute_reprs`` gathers the whole propagated tables, so every rank
builds the same feature rows (and ``marcus`` the same ``RandomState``
draws) and ``fit_gbrt``, which is deterministic, fits the same forest on
each.  None is broadcast; one all-reduce of the forest's digest raises on
a rank that diverged.  Rank 0 alone writes ``forest.npz``; every rank
reads it.  Serving scores this rank's own catalogue rows through the
forest and merges the ranks' candidates
(``parallel.sharded.sharded_topk_of_scores``) with ties to the lower
index: the single card's top-k, ties included.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..ops.retrieval import (catalog_scores, mask_train_items,
                             top_k_lower_index)
from ..ops.trees import GBRTState, compile_forest, fit_gbrt, forest_predict
from ..parallel.sharded import (ranks_agree, shard_columns,
                                sharded_topk_of_scores)
from ..train.checkpoint import FOREST_NAME, load_forest, run_dir, save_forest
from ..train.trainer import Trainer
from ..weights import forest_from_tree_pkl
from .ltr import LTRLinear

log = logging.getLogger('textgcn_tpu_torch')

TREE_PKL = 'tree.pkl'       # the JAX package's pickled estimator
XGBOOST_WARNING = ('xgboost not available; using the least-squares '
                   'GradientBoostingRegressor (ops.trees.fit_gbrt) instead')


class LTRGradientBoosted(LTRLinear):
    """Tree head over the LTR feature crosses."""

    tree_params = dict(n_estimators=10, max_depth=3)
    fit_batch_users = 256
    # tree scores are no factorable product: no LTR factors to export
    supports_fused_sharded_topk = False

    def __init__(self, cfg, data, *, device=None, generator=None):
        super().__init__(cfg, data, device=device, generator=generator)
        if self.uses_xgboost(cfg):
            log.warning(XGBOOST_WARNING)
        self._state: GBRTState | None = None
        self._forest = None

    @staticmethod
    def uses_xgboost(cfg) -> bool:
        return 'xgboost' in cfg.model

    # --- the ensemble ------------------------------------------------------

    @property
    def forest_state(self) -> GBRTState | None:
        return self._state

    @forest_state.setter
    def forest_state(self, state: GBRTState | None):
        if state is not None and state.n_features != self.n_features:
            raise ValueError(f'the ensemble has {state.n_features} '
                             f'features, the model {self.n_features}')
        self._state = state
        self._forest = None

    @property
    def forest(self):
        """The fitted ensemble compiled for ``forest_predict`` (once)."""
        if self._state is None:
            raise RuntimeError('no fitted forest: fit the trees or load a '
                               f'run directory that holds {FOREST_NAME}')
        if self._forest is None:
            self._forest = compile_forest(self._state, self.device)
        return self._forest

    def on_evaluate(self):
        """The tower is untrained for a tree head: nothing to log (the
        importances are logged after ``fit_trees``)."""

    # --- features ----------------------------------------------------------

    def compute_reprs(self):
        """The whole propagated ``(users, items)`` tables, eval mode: on a
        mesh gathered from every rank's rows, the phantom rows dropped."""
        with torch.no_grad():
            users_repr, items_repr = self.representation()
            return (self.gathered(users_repr, self.n_users),
                    self.gathered(items_repr, self.n_items))

    def batch_features(self, reprs, batch_users,
                       cols: slice = slice(None)) -> torch.Tensor:
        """``(B, C, F)`` features of a user batch against the catalogue
        items ``cols`` (all of them by default; ``reprs``' item table holds
        just those rows): one ``(B, d) @ (d, C)`` product a cross."""
        users_repr, items_repr = reprs
        u_rev = self.users_as_avg_reviews[batch_users]
        u_desc = self.users_as_avg_desc[batch_users]
        i_rev = self.items_as_avg_reviews[cols]
        i_desc = self.items_as_desc[cols]
        feats = torch.stack([
            catalog_scores(users_repr[batch_users], items_repr),
            catalog_scores(u_rev, i_rev),
            catalog_scores(u_desc, i_desc),
            catalog_scores(u_rev, i_desc),
            catalog_scores(u_desc, i_rev),
        ], dim=-1)
        return self._append_popularity(feats, batch_users, cols)

    def _append_popularity(self, feats, batch_users, cols):
        return feats      # LTRGradientBoostedWPop appends two columns

    def labels(self, users: torch.Tensor, pos_padded: torch.Tensor,
               pos_degree: torch.Tensor) -> torch.Tensor:
        """``(B, n_items)`` float64 multi-hot train items of ``users``."""
        pad = pos_padded[users]
        keep = (torch.arange(pad.shape[1], device=pad.device)[None]
                < pos_degree[users][:, None])
        cols = torch.where(keep, pad, self.n_items).to(torch.int64)
        y = torch.zeros(len(users), self.n_items + 1, dtype=torch.float64,
                        device=pad.device)
        return y.scatter_(1, cols, 1.0)[:, :self.n_items]

    # --- the fit -----------------------------------------------------------

    def fit_trees(self, pos_padded, pos_degree):
        """One pass over the users, ``fit_batch_users`` at a time, each
        batch's every (user, item) pair a row: 10 more warm-started trees
        a batch.  Returns ``[(feature name, importance)]``."""
        bs = self.fit_batch_users
        dev = self.device
        pos_padded = torch.as_tensor(np.asarray(pos_padded), device=dev)
        pos_degree = torch.as_tensor(np.asarray(pos_degree), device=dev)
        reprs = self.compute_reprs()
        state = None
        with torch.no_grad():
            for start in range(0, self.n_users, bs):
                users = torch.arange(start, min(start + bs, self.n_users),
                                     device=dev)
                x = self.batch_features(reprs, users)
                y = self.labels(users, pos_padded, pos_degree)
                state = fit_gbrt(x.reshape(-1, x.shape[-1]), y.reshape(-1),
                                 state, **self.tree_params)
        self.forest_state = state
        self.check_ranks_agree()
        return list(zip(self.feature_names,
                        state.feature_importances().tolist()))

    def check_ranks_agree(self):
        """On a mesh, raise unless every rank fitted the same forest (one
        all-reduce of its digest)."""
        if self.mesh is not None and not ranks_agree(
                float(self._state.digest()), self.device):
            raise RuntimeError(
                f'rank {self.mesh.rank} fitted another forest than a rank '
                'beside it: the replicated fit diverged')

    # --- scoring -----------------------------------------------------------

    def tree_scores(self, reprs, batch_users,
                    cols: slice = slice(None)) -> torch.Tensor:
        """``(B, C)`` float32 scores of the items ``cols`` (see
        ``batch_features``) through the fitted forest."""
        feats = self.batch_features(reprs, batch_users, cols)
        scores = forest_predict(self.forest, feats.reshape(-1,
                                                           feats.shape[-1]))
        return scores.reshape(feats.shape[:2])

    def score_batchwise(self, reprs, users: torch.Tensor) -> torch.Tensor:
        if not self.score_with_head:
            return super().score_batchwise(reprs, users)
        return self.tree_scores(reprs, users)

    def topk_for_users(self, reprs, batch_users: torch.Tensor, k: int):
        """The forest's top-k, ties to the lower index; on a mesh from
        ``scoring_reprs``' item rows of this rank, merged over the
        ranks."""
        if not self.score_with_head:
            return super().topk_for_users(reprs, batch_users, k)
        if self.mesh is not None:
            users_repr, items_repr = reprs
            shard = items_repr.shape[0]
            offset, n_real = shard_columns(self.mesh, shard, self.n_items)
            scores = self.tree_scores((users_repr, items_repr[:n_real]),
                                      batch_users,
                                      slice(offset, offset + n_real))
            return sharded_topk_of_scores(self.mesh, scores, shard,
                                          self.pos_padded[batch_users], k,
                                          lower_index=True)
        scores = mask_train_items(self.tree_scores(reprs, batch_users),
                                  self.pos_padded[batch_users], self.n_items)
        return top_k_lower_index(scores, k)


class LTRGradientBoostedWPop(LTRGradientBoosted):
    """+ the user's and the item's popularity as features 6 and 7."""

    n_extra_features = 2

    def __init__(self, cfg, data, *, device=None, generator=None):
        super().__init__(cfg, data, device=device, generator=generator)
        for name in ('popularity_users', 'popularity_items'):
            self.device_buffer(name, getattr(data, name))

    def _append_popularity(self, feats, batch_users, cols):
        b, c = feats.shape[:2]
        pop_u = self.popularity_users[batch_users][:, None, :].expand(
            b, c, 1)
        pop_i = self.popularity_items[cols][None].expand(b, c, 1)
        return torch.cat([feats, pop_u, pop_i], dim=-1)


class MarcusGradientBoosted(LTRGradientBoosted):
    """Per-positive negative sampling: each user's positives and
    ``max(1, neg_samples)`` sampled negatives a positive, one fit on
    ``O(n_train * (1 + neg))`` rows instead of every (user, item) pair.
    The reference forces the xgboost ranker here; the port fits the
    least-squares ensemble, as the JAX package does without xgboost."""

    @staticmethod
    def uses_xgboost(cfg) -> bool:
        return True

    def sample_rows(self, pos_padded, pos_degree):
        """``(users, items, y)`` numpy rows: per user with train items its
        positives, then its negatives, drawn from
        ``np.random.RandomState(seed)`` with up to 8 rounds that redraw
        the negatives that hit a positive (the JAX package's draws, in its
        order)."""
        rng = np.random.RandomState(self.cfg.seed)
        pos_padded = np.asarray(pos_padded)
        pos_degree = np.asarray(pos_degree)
        neg_k = max(1, self.cfg.neg_samples)
        rows_u, rows_i, rows_y = [], [], []
        for u in range(self.n_users):
            deg = int(pos_degree[u])
            if not deg:
                continue
            pos_items = pos_padded[u][:deg]
            negs = rng.randint(0, self.n_items, deg * neg_k)
            for _ in range(8):
                bad = np.isin(negs, pos_items)
                if not bad.any():
                    break
                negs[bad] = rng.randint(0, self.n_items, int(bad.sum()))
            items = np.concatenate([pos_items, negs]).astype(np.int32)
            rows_u.append(np.full(len(items), u, np.int32))
            rows_i.append(items)
            rows_y.append(np.concatenate([np.ones(deg, np.float32),
                                          np.zeros(len(negs), np.float32)]))
        return (np.concatenate(rows_u), np.concatenate(rows_i),
                np.concatenate(rows_y))

    def pair_features(self, reprs, users, items,
                      chunk: int = 4096) -> torch.Tensor:
        """``(R, F)`` features of (user, item) rows, ``chunk`` at a time."""
        users_repr, items_repr = reprs
        out = []
        with torch.no_grad():
            for s in range(0, len(users), chunk):
                u, i = users[s:s + chunk], items[s:s + chunk]
                out.append(self.features_pairwise(users_repr[u],
                                                  items_repr[i], u, i))
        return torch.cat(out)

    def fit_trees(self, pos_padded, pos_degree):
        users, items, y = self.sample_rows(pos_padded, pos_degree)
        dev = self.device
        users_t = torch.as_tensor(users, dtype=torch.int64, device=dev)
        items_t = torch.as_tensor(items, dtype=torch.int64, device=dev)
        x = self.pair_features(self.compute_reprs(), users_t, items_t)
        self.forest_state = fit_gbrt(x, torch.as_tensor(y, device=dev),
                                     **self.tree_params)
        self.check_ranks_agree()
        return list(zip(self.feature_names,
                        self.forest_state.feature_importances().tolist()))


class BoostedTrainer(Trainer):
    """The ``Trainer`` of the tree heads: ``fit`` is one tree-fitting
    pass, then the evaluation at epoch 1 and the checkpoint; the
    checkpoint adds ``forest.npz``; ``load`` restores it before its
    evaluation."""

    def fit(self) -> list:
        importances = self.model.fit_trees(self.data.pos_padded,
                                           self.data.pos_degree)
        log.info('feature importances: %s', importances)
        self.evaluate(1)
        self.checkpoint(1)
        return self.loss_history

    def checkpoint(self, epoch: int = 1):
        """``Trainer.checkpoint`` and the fitted ensemble as
        ``forest.npz`` (rank 0 writes it), beside either backend's
        files."""
        super().checkpoint(epoch)
        state = self.model.forest_state
        if self.cfg.save and self.primary and state is not None:
            save_forest(self.cfg.save_path, state)

    def load(self, load_path: str):
        """Restore a run's fitted ensemble, then ``Trainer.load`` (its
        evaluation scores through the restored trees): the port's
        ``forest.npz`` first, else the JAX package's ``tree.pkl`` (a
        pickled scikit-learn estimator, read by
        ``weights.forest_from_tree_pkl`` without scikit-learn).  A run
        with neither evaluates its tables with plain scoring.  Every rank
        of a mesh reads the file."""
        folder = run_dir(load_path)
        forest = os.path.join(folder, FOREST_NAME)
        tree_pkl = os.path.join(folder, TREE_PKL)
        if os.path.exists(forest):
            self.model.forest_state = load_forest(forest)
            log.info('Restored the fitted tree ensemble from %s', forest)
            return super().load(load_path)
        if os.path.exists(tree_pkl):
            self.model.forest_state = forest_from_tree_pkl(tree_pkl)
            log.info('Restored the fitted tree ensemble from %s (the JAX '
                     'package\'s pickled estimator)', tree_pkl)
            return super().load(load_path)
        model = self.model
        head = model.score_with_head
        model.score_with_head = False
        try:
            super().load(load_path)
        finally:
            model.score_with_head = head
