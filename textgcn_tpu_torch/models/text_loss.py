"""The text-loss family: BPR + a semantic regulariser over text vectors.

Counterpart of ``textgcn_tpu/models/text_loss.py``:

* ``TextLossModel``: per negative column, the BPR term gets a semantic
  term ``mean(weight * distance)``: ``distance`` compares the text
  distance b of (pos, neg) with their layer-0 embedding distance g through
  ``DISTANCE_FORMULAS[--distance]`` (b and g each by ``DIST_FNS[--dist_fn]``),
  and ``weight`` is ``WEIGHT_FORMULAS[--weight]`` of the (pos, neg) score
  pair;
* ``TextModelKG`` (``kg``): items as their description vectors;
* ``TextModelReviews`` (``reviews``): items as their mean review vectors,
  or on the positive side, with ``pos='user'``, the vector of the review
  the sampled user wrote about the item (zeros for a pair with no train
  review);
* ``TextModel`` (``text``): the diamond of the two, whose ``--pos kg`` and
  ``--neg kg`` switch either side to the descriptions;
* ``probe_text_representations`` (``text_probe``): the metrics of the four
  (user text, item text) combinations as the scoring representation,
  without training.

The ``(item, user)`` review lookup is one ``searchsorted`` over sorted
int64 keys ``item * n_users + user``: the JAX package bisects an int32
row-pointer instead (``text_loss.py:181-211``) because its int64 keys
would wrap to int32.  Only ``pos='user'`` moves the pair vectors to the
device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .lightgcn import LightGCN
from .losses import bpr_loss, reg_loss


def _euclid(x, y):
    return torch.sqrt((x - y).square().sum(dim=-1) + 1e-12)


def _cosine_minus(x, y):
    xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    yn = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-12)
    return -(xn * yn).sum(dim=-1)


DIST_FNS = {'euclid': _euclid, 'cosine_minus': _cosine_minus}

DISTANCE_FORMULAS = {
    'max(b-g)': lambda b, g: F.relu(b - g),
    'max(g-b)': lambda b, g: F.relu(g - b),
    '(b-g)': lambda b, g: b - g,
    '(g-b)': lambda b, g: g - b,
    '|b-g|': lambda b, g: (b - g).abs(),
    '|g-b|': lambda b, g: (g - b).abs(),
    'selu(g-b)': lambda b, g: F.selu(g - b),
    'selu(b-g)': lambda b, g: F.selu(b - g),
}

WEIGHT_FORMULAS = {
    'max(p-n)': lambda p, n: F.relu(p - n),
    '|p-n|': lambda p, n: (p - n).abs(),
    '(p-n)': lambda p, n: p - n,
    '1': lambda p, n: 1.0,
    '0': lambda p, n: 0.0,
}


def _formula(table: dict, flag: str, name: str):
    if name not in table:
        raise KeyError(f'{flag} {name!r}: one of {", ".join(table)}')
    return table[name]


class TextLossModel(LightGCN):
    """Abstract: subclasses give the items' text on the positive and the
    negative side (``pos_items_reprs``, ``neg_items_reprs``)."""

    loss_components = ('bpr', 'sem', 'reg')

    def __init__(self, cfg, data, *, device=None, generator=None,
                 weight: str | None = None, distance: str | None = None,
                 dist_fn: str | None = None):
        """The formulas default to ``--weight``, ``--distance`` and
        ``--dist_fn``; an unknown name raises ``KeyError``."""
        super().__init__(cfg, data, device=device, generator=generator)
        self.weight_formula = _formula(
            WEIGHT_FORMULAS, '--weight', cfg.weight if weight is None
            else weight)
        self.distance_formula = _formula(
            DISTANCE_FORMULAS, '--distance', cfg.distance if distance is None
            else distance)
        self.dist_fn = _formula(DIST_FNS, '--dist_fn', cfg.dist_fn
                                if dist_fn is None else dist_fn)

    def pos_items_reprs(self, items, users):
        raise NotImplementedError

    def neg_items_reprs(self, items, users):
        raise NotImplementedError

    def semantic_loss(self, users, pos, negs, pos_scores, neg_scores,
                      mask=None, item_emb=None, count=None):
        """The mean over the negative columns of the batch mean of
        ``weight * distance``: ``pos``/``pos_scores`` (B,),
        ``negs``/``neg_scores`` (B, K); ``item_emb`` the whole layer-0 item
        table (default ``self.item_emb``), ``count`` the rows the mean
        divides by (default the batch's; on a mesh the whole batch's)."""
        if item_emb is None:
            item_emb = self.item_emb
        b = self.dist_fn(self.pos_items_reprs(pos, users)[:, None, :],
                         self.neg_items_reprs(negs, users[:, None]))
        g = self.dist_fn(item_emb[pos][:, None, :], item_emb[negs])
        val = (self.weight_formula(pos_scores[:, None], neg_scores)
               * self.distance_formula(b, g))
        if mask is not None:
            val = torch.where(mask[:, None], val, 0.0)
            count = mask.to(val.dtype).sum().clamp(min=1.0)
        elif count is None:
            count = float(max(val.shape[0], 1))
        return (val.sum(dim=0) / count).mean()

    def loss(self, batch, *, generator: torch.Generator | None = None,
             w_pairs=None):
        """``(loss, {'bpr', 'sem', 'reg'})`` of one batch ``(users, pos,
        negs[, mask])``: one propagation with edge dropout, BPR,
        ``semantic_loss`` and L2 on the layer-0 rows; on a mesh this
        rank's share, as ``LightGCN.loss``."""
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
        l_sem = self.semantic_loss(users, pos, negs, pos_scores, neg_scores,
                                   mask, item_emb, count)
        l_reg = reg_loss(user_emb, item_emb, users, pos, negs,
                         self.reg_lambda, mask, count)
        return l_bpr + l_sem + l_reg, {'bpr': l_bpr, 'sem': l_sem,
                                       'reg': l_reg}


class TextModelKG(TextLossModel):
    """Items as their description vectors."""

    def __init__(self, cfg, data, **kw):
        super().__init__(cfg, data, **kw)
        self.device_buffer('items_as_desc', data.items_as_desc)

    def pos_items_reprs(self, items, users):
        return self.items_as_desc[items]

    neg_items_reprs = pos_items_reprs


class TextModelReviews(TextLossModel):
    """Items as their mean review vectors; with ``pos='user'`` the
    positive side reads the (item, user) review.  ``reviews`` always takes
    ``avg``; only ``text`` reads ``--pos``."""

    def __init__(self, cfg, data, pos: str | None = None, **kw):
        super().__init__(cfg, data, **kw)
        self.device_buffer('items_as_avg_reviews', data.items_as_avg_reviews)
        if pos is None:
            pos = cfg.pos if cfg.model != 'reviews' else 'avg'
        self.pos_mode = pos
        if pos == 'user':
            self.device_buffer('pair_keys', data.review_pair_items.astype(
                np.int64) * self.n_users + data.review_pair_users)
            self.device_buffer('pair_vectors', data.review_pair_vectors)

    def item_reviews_user(self, items, users):
        """The vector of the review ``users`` wrote about ``items`` (the
        first in the loader's order), zeros where there is none."""
        q = items.to(torch.int64) * self.n_users + users
        idx = torch.searchsorted(self.pair_keys, q).clamp(
            max=self.pair_keys.numel() - 1)
        found = self.pair_keys[idx] == q
        return torch.where(found[..., None], self.pair_vectors[idx], 0.0)

    def pos_items_reprs(self, items, users):
        if self.pos_mode == 'user':
            return self.item_reviews_user(items, users)
        return self.items_as_avg_reviews[items]

    def neg_items_reprs(self, items, users):
        return self.items_as_avg_reviews[items]


class TextModel(TextModelReviews, TextModelKG):
    """The diamond: review vectors by default, ``--pos kg`` / ``--neg kg``
    switch either side to the descriptions."""

    def __init__(self, cfg, data, pos: str | None = None,
                 neg: str | None = None, **kw):
        kg_pos = pos is None and cfg.pos == 'kg'
        super().__init__(cfg, data, pos='avg' if kg_pos else pos, **kw)
        if kg_pos:
            self.pos_mode = 'kg'
        self.neg_mode = cfg.neg if neg is None else neg

    def pos_items_reprs(self, items, users):
        if self.pos_mode == 'kg':
            return self.items_as_desc[items]
        return super().pos_items_reprs(items, users)

    def neg_items_reprs(self, items, users):
        if self.neg_mode == 'kg':
            return self.items_as_desc[items]
        return self.items_as_avg_reviews[items]


TEXT_COMBOS = {
    'rev_rev': ('users_as_avg_reviews', 'items_as_avg_reviews'),
    'kg_kg': ('users_as_avg_desc', 'items_as_desc'),
    'rev_kg': ('users_as_avg_reviews', 'items_as_desc'),
    'kg_rev': ('users_as_avg_desc', 'items_as_avg_reviews'),
}


def probe_text_representations(data, trainer) -> dict[str, dict]:
    """``{combo: metrics}`` of the four ``TEXT_COMBOS`` (user text, item
    text) of ``data`` as the scoring representation, evaluated without
    training: no propagation, so no kernel runs.  On a mesh the
    representation is this rank's rows of the zero-padded text tables, as
    a propagation's would be (``data``'s text holds the real rows)."""
    model = trainer.model
    results = {}
    try:
        for name, (u_attr, i_attr) in TEXT_COMBOS.items():
            u, i = (model.local_rows(
                torch.from_numpy(getattr(data, a)).to(model.device),
                table.shape[0]) for a, table in ((u_attr, model.user_emb),
                                                 (i_attr, model.item_emb)))
            model.representation = lambda u=u, i=i, **kw: (u, i)
            results[name] = trainer.evaluate()
    finally:
        model.__dict__.pop('representation', None)
    return results
