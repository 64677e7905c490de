"""LightGCN: embedding tables + K-hop propagation + BPR training.

Counterpart of ``textgcn_tpu/models/lightgcn.py`` as an ``nn.Module``.
The tables hold the real rows only: the JAX package pads them to 4096
rows for its TPU kernel, the port does not (``weights.params_from_jax``
slices a padded checkpoint).  ``loss`` is the BPR + L2 loss of one batch
after one full-graph propagation with hash edge dropout;
``sample_batches`` draws an epoch of batches on the device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import Config, resolve_device
from ..data.core import InteractionData
from ..ops.propagate import representation as _representation
from ..ops.retrieval import score_and_topk
from ..ops.sampling import (batch_epoch, num_batches, positive_keys,
                            sample_epoch)
from ..ops.spmm import GraphOp
from .losses import bpr_loss, reg_loss


class LightGCN(nn.Module):

    # per-step loss components, logged as running sums by the Trainer
    loss_components = ('bpr', 'reg')

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
        g = data.graph
        self.graph_op = GraphOp(g.edge_user, g.edge_item,
                                self.graph_edge_weight(g), self.n_users,
                                self.n_items, self.device)
        for name, value in (('pos_padded', data.pos_padded),
                            ('pos_degree', data.pos_degree)):
            self.register_buffer(name, torch.from_numpy(value).to(
                self.device), persistent=False)
        self.register_buffer(
            'pos_keys', positive_keys(self.pos_padded, self.n_items),
            persistent=False)

    def graph_edge_weight(self, graph) -> np.ndarray:
        """The edge weights of ``graph_op``: LightGCN's normalisation."""
        return graph.edge_weight

    # --- parameters --------------------------------------------------------

    def param_tree(self) -> dict:
        """The parameters in the JAX package's tree."""
        return {'user_emb': self.user_emb, 'item_emb': self.item_emb}

    @torch.no_grad()
    def load_params(self, params: dict):
        """Copy loaded ``(n_users, d)``/``(n_items, d)`` tables in (other
        keys of ``params`` are the subclasses')."""
        for param, name in ((self.user_emb, 'user_emb'),
                            (self.item_emb, 'item_emb')):
            value = params[name]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f'{name}: checkpoint table '
                                 f'{tuple(value.shape)} does not fit '
                                 f'{tuple(param.shape)}')
            param.copy_(value)

    # --- representation ----------------------------------------------------

    def representation(self, *, training: bool = False,
                       generator: torch.Generator | None = None,
                       w_pairs=None):
        """Propagated ``(users_repr, items_repr)``; edge dropout only in
        training, with salts drawn from ``generator`` or given as
        ``w_pairs = ((salt, keep), (salt, keep))`` (to_user, to_item)."""
        return _representation(
            self.user_emb, self.item_emb, self.graph_op, self.n_layers,
            single=self.single,
            dropout=self.dropout if training else 0.0, generator=generator,
            w_pairs=w_pairs if training else None)

    # --- scoring -----------------------------------------------------------

    def score_batchwise(self, reprs, users: torch.Tensor) -> torch.Tensor:
        """(B, n_items) scores of a user batch against the catalogue."""
        users_repr, items_repr = reprs
        return users_repr[users] @ items_repr.T

    def topk_for_users(self, reprs, batch_users: torch.Tensor, k: int):
        """Train-masked full-catalogue top-k for a batch of users."""
        users_repr, items_repr = reprs
        return score_and_topk(users_repr[batch_users], items_repr,
                              self.pos_padded[batch_users], k=k,
                              n_items=self.n_items)

    # --- loss --------------------------------------------------------------

    def loss(self, batch, *, generator: torch.Generator | None = None,
             w_pairs=None):
        """``(loss, {'bpr', 'reg'})`` of one batch ``(users, pos, negs[,
        mask])``: one full-graph propagation with edge dropout, BPR over
        ``selu(neg - pos)`` and L2 on the layer-0 rows."""
        users, pos, negs = batch[:3]
        mask = batch[3] if len(batch) > 3 else None
        users_repr, items_repr = self.representation(
            training=True, generator=generator, w_pairs=w_pairs)
        u = users_repr[users]
        pos_scores = (u * items_repr[pos]).sum(dim=-1)
        neg_scores = (u[:, None, :] * items_repr[negs]).sum(dim=-1)
        l_bpr = bpr_loss(pos_scores, neg_scores, mask)
        l_reg = reg_loss(self.user_emb, self.item_emb, users, pos, negs,
                         self.reg_lambda, mask)
        return l_bpr + l_reg, {'bpr': l_bpr, 'reg': l_reg}

    # --- epoch sampling -----------------------------------------------------

    def num_batches(self, batch_size: int) -> int:
        return num_batches(self.iterable_len, batch_size)

    def sample_batches(self, generator: torch.Generator, batch_size: int):
        """One permuted epoch as a list of ``(users, pos, negs)`` batches,
        drawn on the device from ``generator``."""
        users, pos, negs = sample_epoch(
            generator, self.pos_padded, self.pos_degree,
            bucket_len=self.bucket_len, neg_samples=self.cfg.neg_samples,
            n_items=self.n_items, keys=self.pos_keys)
        return batch_epoch(users, pos, negs, batch_size=batch_size)
