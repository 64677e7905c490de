"""LightGCN: embedding tables + K-hop propagation + BPR training.

Counterpart of ``textgcn_tpu/models/lightgcn.py`` as an ``nn.Module``.
The tables hold the real rows only: the JAX package pads them to 4096
rows for its TPU kernel, the port does not (``weights.params_from_jax``
slices a padded checkpoint).  ``loss`` is the BPR + L2 loss of one batch
after one full-graph propagation with hash edge dropout;
``sample_batches`` draws an epoch of batches on the device.

On a mesh (``parallel.mesh.shard_model``) ``mesh`` is set, the tables
hold this rank's rows of the zero-padded tables and ``graph_op`` is a
``MeshGraphOp``.  Every rank draws the same epochs; ``loss`` takes this
rank's part of each batch, gathers the rows it needs from all ranks and
divides by the whole batch, so the ranks' losses sum to the single-card
loss and the gradient of each rank's rows is the single-card gradient of
those rows.  Scoring runs the catalogue-sharded top-k.

Cached propagation (``--refresh_every``): while ``cached_rest`` holds a
stale ``propagate_rest``, the training representation is the fresh ego
tables plus that rest (``cached_reprs``), so the loss's gradients reach
the layer-0 tables only; evaluation always propagates exactly
(``textgcn_tpu/models/lightgcn.py:139-186``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import Config, resolve_device
from ..data.core import InteractionData
from ..ops.propagate import propagate_rest as _propagate_rest
from ..ops.propagate import representation as _representation
from ..ops.retrieval import catalog_scores, score_and_topk
from ..ops.sampling import (batch_epoch, num_batches, positive_keys,
                            sample_epoch)
from ..ops.spmm import GraphOp
from ..parallel.sharded import all_gather_rows, sharded_topk
from ..utils.profiling import span
from ..weights import RowShard
from .losses import bpr_loss, reg_loss


class LightGCN(nn.Module):

    # per-step loss components, logged as running sums by the Trainer
    loss_components = ('bpr', 'reg')
    # --refresh_every: the trainer binds a stale rest here between refreshes
    supports_cached_propagation = True
    cached_rest = None
    # dropout salt pairs the trainer draws a step (one a propagation)
    salt_pairs_per_step = 1
    # a model's own device generator of random draws, which a resume
    # restores (adv_sampling's)
    generator = None

    def __init__(self, cfg: Config, data: InteractionData, *, device=None,
                 generator: torch.Generator | None = None):
        """``device=None`` is the card; ``generator`` (default: seeded
        with ``cfg.seed``) draws the N(0, 0.1) init, users then items."""
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_users = data.n_users
        self.n_items = data.n_items
        self.n_layers = cfg.n_layers
        self.single = cfg.single
        self.dropout = cfg.dropout
        self.reg_lambda = cfg.reg_lambda
        self.bucket_len = data.n_train // data.n_users
        self.iterable_len = self.bucket_len * data.n_users
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        self.init_generator = generator
        d = cfg.emb_size
        self.user_emb = nn.Parameter(
            (0.1 * torch.randn(self.n_users, d, generator=generator,
                               device=generator.device)).to(self.device))
        self.item_emb = nn.Parameter(
            (0.1 * torch.randn(self.n_items, d, generator=generator,
                               device=generator.device)).to(self.device))
        # the single-card op is built at first use: shard_model replaces
        # it on a mesh before any, so it is never built there
        self._graph = data.graph
        self._graph_op = None
        self.mesh = None
        self.device_buffer('pos_padded', data.pos_padded)
        self.device_buffer('pos_degree', data.pos_degree)
        self.register_buffer(
            'pos_keys', positive_keys(self.pos_padded, self.n_items),
            persistent=False)

    def device_buffer(self, name: str, array: np.ndarray):
        """``array`` as the non-persistent buffer ``name`` on the
        model's device."""
        self.register_buffer(name, torch.from_numpy(array).to(self.device),
                             persistent=False)

    def graph_edge_weight(self, graph) -> np.ndarray:
        """The edge weights of ``graph_op``: LightGCN's normalisation."""
        return graph.edge_weight

    @property
    def graph_op(self):
        if self._graph_op is None:
            g = self._graph
            self._graph_op = GraphOp(g.edge_user, g.edge_item,
                                     self.graph_edge_weight(g), self.n_users,
                                     self.n_items, self.device)
        return self._graph_op

    @graph_op.setter
    def graph_op(self, op):
        self._graph_op = op

    def rank_share(self, parts):
        """``(count, parts)`` of a step's batch tensors ``parts``: without a
        mesh ``(None, parts)``; on a mesh the whole batch's row count and
        this rank's ``tensor_split`` of each, so that a loss over the share
        that divides by ``count`` is this rank's part of the batch's."""
        if self.mesh is None:
            return None, parts
        return parts[0].shape[0], tuple(
            t.tensor_split(self.mesh.size)[self.mesh.rank] for t in parts)

    def whole_tables(self, *tables):
        """``tables`` whole, for global ids: on a mesh gathered from every
        rank's rows (the backward reduce-scatters the gradient, so each
        rank gets the sum over all ranks' losses for its rows)."""
        if self.mesh is None:
            return tables
        return tuple(all_gather_rows(t, self.mesh) for t in tables)

    def gathered(self, table: torch.Tensor, n: int) -> torch.Tensor:
        """The first ``n`` rows of a whole table: on a mesh gathered from
        every rank's rows (a collective), else ``table`` itself."""
        if self.mesh is None:
            return table
        return all_gather_rows(table, self.mesh)[:n]

    # --- parameters --------------------------------------------------------

    def param_tree(self, shards: bool = False) -> dict:
        """The parameters in the JAX package's tree (on a mesh, the whole
        real tables: every rank must call it; with ``shards``, this rank's
        rows as ``weights.RowShard``s instead, which a cooperative
        checkpoint writes)."""
        if shards and self.mesh is not None:
            return {'user_emb': RowShard(self.user_emb.detach(),
                                         self.n_users),
                    'item_emb': RowShard(self.item_emb.detach(),
                                         self.n_items)}
        return {'user_emb': self.gathered(self.user_emb, self.n_users),
                'item_emb': self.gathered(self.item_emb, self.n_items)}

    @torch.no_grad()
    def load_params(self, params: dict):
        """Copy loaded ``(n_users, d)``/``(n_items, d)`` tables in (other
        keys of ``params`` are the subclasses'); on a mesh, this rank's
        rows of them, zero-padded."""
        for param, name, n in ((self.user_emb, 'user_emb', self.n_users),
                               (self.item_emb, 'item_emb', self.n_items)):
            value = params[name]
            if tuple(value.shape) != (n, param.shape[1]):
                raise ValueError(f'{name}: checkpoint table '
                                 f'{tuple(value.shape)} does not fit '
                                 f'{(n, param.shape[1])}')
            param.copy_(self.local_rows(value, param.shape[0]))

    def local_rows(self, value: torch.Tensor, n_local: int) -> torch.Tensor:
        """This rank's ``n_local`` rows of a whole table's real rows
        ``value``, zero-padded (``value`` itself without a mesh)."""
        if self.mesh is None:
            return value
        n_padded = n_local * self.mesh.size
        padded = value.new_zeros((n_padded, *value.shape[1:]))
        padded[:value.shape[0]] = value
        return padded[self.mesh.rows(n_padded)]

    # --- representation ----------------------------------------------------

    def representation(self, *, training: bool = False,
                       generator: torch.Generator | None = None,
                       w_pairs=None):
        """Propagated ``(users_repr, items_repr)``; edge dropout only in
        training, with salts drawn from ``generator`` or given as
        ``w_pairs = ((salt, keep), (salt, keep))`` (to_user, to_item).
        In training with ``cached_rest`` bound, ``cached_reprs`` of it."""
        if training and self.cached_rest is not None:
            return self.cached_reprs(self.cached_rest)
        return _representation(
            self.user_emb, self.item_emb, self.graph_op, self.n_layers,
            single=self.single,
            dropout=self.dropout if training else 0.0, generator=generator,
            w_pairs=w_pairs if training else None)

    def propagate_rest(self, w_pairs):
        """The cacheable ``(sum_l u_l, sum_l i_l)``, l = 1..L, with the
        training dropout's salts ``w_pairs``."""
        return _propagate_rest(self.user_emb, self.item_emb, self.graph_op,
                               self.n_layers, dropout=self.dropout,
                               w_pairs=w_pairs)

    def cached_reprs(self, rest):
        """The layer mean from the fresh ego tables and a stale ``rest``:
        gradients reach the layer-0 tables only."""
        if self.single:
            raise ValueError('cached propagation needs the layer mean '
                             '(--single has no ego term to keep fresh)')
        inv = 1.0 / (self.n_layers + 1)
        return ((self.user_emb + rest[0]) * inv,
                (self.item_emb + rest[1]) * inv)

    # --- scoring -----------------------------------------------------------

    def scoring_reprs(self):
        """The propagated tables as ``topk_for_users`` takes them: on a
        mesh the whole user table (one gather) and this rank's items."""
        users_repr, items_repr = self.representation()
        return self.gathered(users_repr, self.n_users), items_repr

    def score_pairwise(self, users_emb, items_emb, users, items):
        """Scores of (user, item) pairs from gathered propagated rows
        (broadcast over leading axes): the dot product.  ``users`` and
        ``items`` are the pairs' ids, for subclasses that add to it."""
        return (users_emb * items_emb).sum(dim=-1)

    def score_batchwise(self, reprs, users: torch.Tensor) -> torch.Tensor:
        """(B, n_items) scores of a user batch against the catalogue."""
        users_repr, items_repr = reprs
        return catalog_scores(users_repr[users], items_repr)

    def topk_for_users(self, reprs, batch_users: torch.Tensor, k: int):
        """Train-masked full-catalogue top-k for a batch of users, from
        ``scoring_reprs``; on a mesh catalogue-sharded and the same on
        every rank."""
        users_repr, items_repr = reprs
        if self.mesh is not None:
            return sharded_topk(self.mesh, users_repr[batch_users],
                                items_repr, self.pos_padded[batch_users], k,
                                self.n_items)
        return score_and_topk(users_repr[batch_users], items_repr,
                              self.pos_padded[batch_users], k=k,
                              n_items=self.n_items)

    # --- loss --------------------------------------------------------------

    def loss(self, batch, *, generator: torch.Generator | None = None,
             w_pairs=None):
        """``(loss, {'bpr', 'reg'})`` of one batch ``(users, pos, negs[,
        mask])``: one full-graph propagation with edge dropout, BPR over
        ``selu(neg - pos)`` of ``score_pairwise`` and L2 on the layer-0
        rows.  On a mesh, this rank's share of the batch's loss (see the
        module docstring)."""
        users, pos, negs = batch[:3]
        mask = batch[3] if len(batch) > 3 else None
        users_repr, items_repr = self.representation(
            training=True, generator=generator, w_pairs=w_pairs)
        count, (users, pos, negs), (users_repr, items_repr, user_emb,
                                    item_emb) = self.mesh_step(
            (users, pos, negs), mask, users_repr, items_repr)
        u = users_repr[users]
        pos_scores = self.score_pairwise(u, items_repr[pos], users, pos)
        neg_scores = self.score_pairwise(u[:, None, :], items_repr[negs],
                                         users[:, None], negs)
        l_bpr = bpr_loss(pos_scores, neg_scores, mask, count)
        l_reg = reg_loss(user_emb, item_emb, users, pos, negs,
                         self.reg_lambda, mask, count)
        return l_bpr + l_reg, {'bpr': l_bpr, 'reg': l_reg}

    def mesh_step(self, parts, mask, users_repr, items_repr):
        """``(count, parts, tables)``: ``rank_share`` of a step's batch
        ``parts`` and ``whole_tables`` of the propagated and the layer-0
        tables ``(users_repr, items_repr, user_emb, item_emb)``.  A mesh
        step takes ragged batches, not masked ones."""
        if self.mesh is not None and mask is not None:
            raise ValueError('a mesh step takes ragged batches, not masked '
                             'ones')
        count, parts = self.rank_share(parts)
        return count, parts, self.whole_tables(users_repr, items_repr,
                                               self.user_emb, self.item_emb)

    # --- epoch sampling -----------------------------------------------------

    def num_batches(self, batch_size: int) -> int:
        return num_batches(self.iterable_len, batch_size)

    def sample_batches(self, generator: torch.Generator, batch_size: int):
        """One permuted epoch as a list of ``(users, pos, negs)`` batches,
        drawn on the device from ``generator``."""
        with span('train.sample_epoch'):
            users, pos, negs = sample_epoch(
                generator, self.pos_padded, self.pos_degree,
                bucket_len=self.bucket_len,
                neg_samples=self.cfg.neg_samples, n_items=self.n_items,
                keys=self.pos_keys)
            return batch_epoch(users, pos, negs, batch_size=batch_size)
