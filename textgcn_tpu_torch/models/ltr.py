"""Learning-to-rank heads: the paper's TextGCN models.

Counterpart of ``textgcn_tpu/models/ltr.py`` as ``LightGCN`` subclasses.
``LTRLinear`` scores a (user, item) pair with a linear tower over five
cross features of the propagated tables and the text features, in the
reference order

    [gnn.gnn, reviews.reviews, desc.desc, reviews_u.desc_i, desc_u.reviews_i]

and ``LTRLinearWPop`` appends the user's and the item's popularity.  The
tower is a stack of ``nn.Linear`` without activations, so it collapses to
one weight vector and a bias (``collapse_tower``); the catalogue scores
are then one product ``u_cat @ i_cat.T + bias`` of ``(B, 3d')`` user
factors and ``(n_items, 3d')`` item factors (``fused_catalog_inputs``),
never the reference's ``(B, n_items, F)`` feature tensor.  Training
differentiates through every tower layer on the pairwise features
(``LightGCN.loss`` scores through ``score_pairwise``).

``--freeze`` sets ``requires_grad=False`` on the tables: Adam then steps
the tower only and the propagation runs no backward.  While
``score_with_head`` is off (the ``--load_base`` evaluation of the base)
the model scores as ``lgcn`` does.

On a mesh the tables are row-sharded as ``lgcn``'s (K2 over source
shards); the tower and the text and popularity buffers stay whole.  The
head's top-k is then the fused catalogue-sharded one: ``u_cat`` of the
batch's users against this rank's rows of ``i_cat`` through
``parallel.sharded.sharded_topk``, the bias added to the values
(``textgcn_tpu/train/trainer.py:287-300``); with the head off, the plain
sharded top-k.
"""

from __future__ import annotations

import logging
import math

import torch
from torch import nn

from ..ops.retrieval import catalog_scores, mask_train_items
from ..parallel.sharded import sharded_topk
from .lightgcn import LightGCN

log = logging.getLogger('textgcn_tpu_torch')

FEATURE_NAMES = [
    'lightgcn score',
    'reviews',
    'desc',
    'reviews-description',
    'description-reviews',
]
TEXT_FEATURES = ('items_as_desc', 'items_as_avg_reviews',
                 'users_as_avg_reviews', 'users_as_avg_desc')


def collapse_tower(tower) -> tuple[torch.Tensor, torch.Tensor]:
    """``(w_eff (F,), b_eff ())`` of a stack of ``nn.Linear`` layers with
    no activation between them: ``tower(x) == x @ w_eff + b_eff``."""
    a = tower[0].weight.T
    b = tower[0].bias
    for layer in tower[1:]:
        a = a @ layer.weight.T
        b = b @ layer.weight.T + layer.bias
    return a[:, 0], b[0]


class LTRLinear(LightGCN):

    n_extra_features = 0
    # scores are one product u_cat @ i_cat.T + bias: export_reprs writes
    # the factors (the JAX package's flag for its fused sharded top-k)
    supports_fused_sharded_topk = True

    def __init__(self, cfg, data, *, device=None, generator=None):
        """The tables as ``LightGCN`` draws them, then each tower layer's
        weight ``(fan_in, fan_out)`` and bias from U(+-1/sqrt(fan_in)),
        from the same generator."""
        super().__init__(cfg, data, device=device, generator=generator)
        self.feature_names = list(FEATURE_NAMES)
        if self.n_extra_features:
            self.feature_names += ['user popularity', 'item popularity']
        self.n_features = len(self.feature_names)
        self.ltr_layers = tuple(cfg.ltr_layers)
        self.freeze = cfg.freeze
        for name in TEXT_FEATURES:
            self.device_buffer(name, getattr(data, name))
        sizes = [self.n_features, *self.ltr_layers, 1]
        gen = self.init_generator
        self.tower = nn.ModuleList()
        for fan_in, fan_out in zip(sizes, sizes[1:]):
            bound = 1.0 / math.sqrt(fan_in)
            lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out,
                                     device=self.device)
            with torch.no_grad():
                w = torch.rand(fan_in, fan_out, generator=gen,
                               device=gen.device) * (2 * bound) - bound
                b = torch.rand(fan_out, generator=gen,
                               device=gen.device) * (2 * bound) - bound
                lin.weight.copy_(w.T)
                lin.bias.copy_(b)
            self.tower.append(lin)
        if self.freeze:
            self.user_emb.requires_grad_(False)
            self.item_emb.requires_grad_(False)
        # off while --load_base evaluates the base with plain scoring
        self.score_with_head = True

    # --- parameters --------------------------------------------------------

    def param_tree(self, shards: bool = False) -> dict:
        tree = super().param_tree(shards)
        tree['tower'] = [{'w': lin.weight.T, 'b': lin.bias}
                         for lin in self.tower]
        return tree

    @torch.no_grad()
    def load_params(self, params: dict):
        """Tables, and the tower when the checkpoint has one (a plain
        ``lgcn`` checkpoint fills the tables; the tower keeps its init)."""
        super().load_params(params)
        tower = params.get('tower')
        if tower is None:
            return
        if len(tower) != len(self.tower):
            raise ValueError(f'checkpoint has {len(tower)} tower layers, '
                             f'the model {len(self.tower)}')
        for lin, layer in zip(self.tower, tower):
            if tuple(layer['w'].shape) != tuple(lin.weight.T.shape):
                raise ValueError(f'tower w: checkpoint '
                                 f'{tuple(layer["w"].shape)} does not fit '
                                 f'{tuple(lin.weight.T.shape)}')
            lin.weight.copy_(layer['w'].T)
            lin.bias.copy_(layer['b'])

    # --- features ----------------------------------------------------------

    def features_pairwise(self, users_emb, items_emb, users, items):
        """``(..., F)`` cross features of gathered propagated rows and the
        text rows of ``users``/``items`` (broadcast over leading axes), in
        the reference order."""
        u_rev = self.users_as_avg_reviews[users]
        u_desc = self.users_as_avg_desc[users]
        i_rev = self.items_as_avg_reviews[items]
        i_desc = self.items_as_desc[items]
        return torch.stack([
            (users_emb * items_emb).sum(-1),
            (u_rev * i_rev).sum(-1),
            (u_desc * i_desc).sum(-1),
            (u_rev * i_desc).sum(-1),
            (u_desc * i_rev).sum(-1),
        ], dim=-1)

    def apply_tower(self, features: torch.Tensor) -> torch.Tensor:
        x = features
        for lin in self.tower:
            x = lin(x)
        return x[..., 0]

    def score_pairwise(self, users_emb, items_emb, users, items):
        """Head scores of (user, item) pairs (the dot product while the
        head is off)."""
        if not self.score_with_head:
            return super().score_pairwise(users_emb, items_emb, users, items)
        return self.apply_tower(
            self.features_pairwise(users_emb, items_emb, users, items))

    # --- catalogue scoring -------------------------------------------------

    def fused_catalog_inputs(self, reprs, batch_users):
        """``(u_cat, i_cat, bias)`` with catalogue scores exactly
        ``u_cat @ i_cat.T + bias`` under the collapsed tower.  ``reprs``
        as ``scoring_reprs`` gives them: on a mesh ``i_cat`` holds this
        rank's item rows (``local_rows`` of the whole item buffers)."""
        users_repr, items_repr = reprs
        w, b = collapse_tower(self.tower)
        u_emb = users_repr[batch_users]
        u_rev = self.users_as_avg_reviews[batch_users]
        u_desc = self.users_as_avg_desc[batch_users]
        u_cat = torch.cat([w[0] * u_emb, w[1] * u_rev + w[4] * u_desc,
                           w[2] * u_desc + w[3] * u_rev], dim=-1)
        n = items_repr.shape[0]
        i_cat = torch.cat([items_repr,
                           self.local_rows(self.items_as_avg_reviews, n),
                           self.local_rows(self.items_as_desc, n)], dim=-1)
        u_cat, i_cat = self._popularity_factors(u_cat, i_cat, w,
                                                batch_users)
        return u_cat, i_cat, b

    def _popularity_factors(self, u_cat, i_cat, w, batch_users):
        return u_cat, i_cat   # LTRLinearWPop appends two columns

    def fused_batch_scores(self, reprs, batch_users) -> torch.Tensor:
        """``(B, n_items)`` head scores through the fused product."""
        u_cat, i_cat, b = self.fused_catalog_inputs(reprs, batch_users)
        return catalog_scores(u_cat, i_cat) + b

    def score_batchwise(self, reprs, users: torch.Tensor) -> torch.Tensor:
        if not self.score_with_head:
            return super().score_batchwise(reprs, users)
        return self.fused_batch_scores(reprs, users)

    def topk_for_users(self, reprs, batch_users: torch.Tensor, k: int):
        if not self.score_with_head:
            return super().topk_for_users(reprs, batch_users, k)
        if self.mesh is not None:
            u_cat, i_cat, b = self.fused_catalog_inputs(reprs, batch_users)
            vals, idx = sharded_topk(self.mesh, u_cat, i_cat,
                                     self.pos_padded[batch_users], k,
                                     self.n_items)
            return vals + b, idx
        scores = mask_train_items(self.fused_batch_scores(reprs, batch_users),
                                  self.pos_padded[batch_users], self.n_items)
        return torch.topk(scores, k, dim=1)

    # --- observability -----------------------------------------------------

    def on_evaluate(self):
        """Log the feature weights of a one-layer tower."""
        if len(self.tower) == 1:
            w = self.tower[0].weight.detach()[0].cpu().tolist()
            log.info('Feature weights from the top layer:')
            for name, weight in zip(self.feature_names, w):
                log.info('%-20s %.4g', name, weight)


class LTRLinearWPop(LTRLinear):
    """``LTRLinear`` with the user's and the item's popularity as two more
    features."""

    n_extra_features = 2

    def __init__(self, cfg, data, *, device=None, generator=None):
        super().__init__(cfg, data, device=device, generator=generator)
        for name in ('popularity_users', 'popularity_items'):
            self.device_buffer(name, getattr(data, name))

    def features_pairwise(self, users_emb, items_emb, users, items):
        base = super().features_pairwise(users_emb, items_emb, users, items)
        pop = torch.broadcast_tensors(self.popularity_users[users],
                                      self.popularity_items[items])
        return torch.cat([base, *pop], dim=-1)

    def _popularity_factors(self, u_cat, i_cat, w, batch_users):
        """The popularity terms are rank 1 under the collapsed tower
        (``w5 * pop_u`` by rows, ``w6 * pop_i`` by columns): two more
        columns of the product."""
        ones_u = torch.ones_like(u_cat[:, :1])
        ones_i = torch.ones_like(i_cat[:, :1])
        pop_i = self.local_rows(self.popularity_items, i_cat.shape[0])
        u_cat = torch.cat([u_cat, w[5] * self.popularity_users[batch_users],
                           ones_u], dim=-1)
        i_cat = torch.cat([i_cat, ones_i, w[6] * pop_i], dim=-1)
        return u_cat, i_cat
