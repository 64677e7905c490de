"""LightGCN: embedding tables + K-hop propagation + catalogue retrieval.

Counterpart of ``textgcn_tpu/models/lightgcn.py`` as an ``nn.Module``.
The tables hold the real rows only: the JAX package pads them to 4096
rows for its TPU kernel, the port does not (``weights.params_from_jax``
slices a padded checkpoint).  Training (sampling, BPR loss, the SpMM
backward) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config, resolve_device
from ..data.core import InteractionData
from ..ops.propagate import representation as _representation
from ..ops.retrieval import score_and_topk
from ..ops.spmm import GraphOp


class LightGCN(nn.Module):

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
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        d = cfg.emb_size
        self.user_emb = nn.Parameter(
            (0.1 * torch.randn(self.n_users, d, generator=generator,
                               device=generator.device)).to(self.device))
        self.item_emb = nn.Parameter(
            (0.1 * torch.randn(self.n_items, d, generator=generator,
                               device=generator.device)).to(self.device))
        g = data.graph
        self.graph_op = GraphOp(g.edge_user, g.edge_item, g.edge_weight,
                                self.n_users, self.n_items, self.device)
        self.register_buffer(
            'pos_padded', torch.from_numpy(data.pos_padded).to(self.device),
            persistent=False)

    @torch.no_grad()
    def load_tables(self, user_emb: torch.Tensor, item_emb: torch.Tensor):
        """Copy loaded ``(n_users, d)``/``(n_items, d)`` tables in."""
        for param, value, name in ((self.user_emb, user_emb, 'user_emb'),
                                   (self.item_emb, item_emb, 'item_emb')):
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f'{name}: checkpoint table '
                                 f'{tuple(value.shape)} does not fit '
                                 f'{tuple(param.shape)}')
            param.copy_(value)

    def representation(self, *, training: bool = False,
                       generator: torch.Generator | None = None):
        """Propagated ``(users_repr, items_repr)``; edge dropout only in
        training."""
        return _representation(
            self.user_emb, self.item_emb, self.graph_op, self.n_layers,
            single=self.single,
            dropout=self.dropout if training else 0.0, generator=generator)

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
