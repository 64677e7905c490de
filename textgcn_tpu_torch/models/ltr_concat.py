"""Concatenated-space scorers: ``ltr_reviews``, ``ltr_kg``, ``ltr_simple``.

Counterpart of ``textgcn_tpu/models/ltr_concat.py``.  ``LTRCosine``
trains LightGCN from scratch and takes every score, in training too, in
the space ``[gnn ++ text]``:

    score(u, i) = gnn_u . gnn_i + text_u . text_i

with ``text_u`` the user's mean review vector and ``text_i`` the item's
mean review vector (``ltr_reviews``) or its description vector
(``ltr_kg``).  The catalogue scores are one product ``u_cat @ i_cat.T`` of
the concatenated factors (``fused_catalog_inputs``, bias 0).  While
``score_with_head`` is off (the ``--load_base`` evaluation of the base)
the model scores as ``lgcn`` does.

``LTRSimple`` (``ltr_simple``) trains nothing: the CLI loads a base and
``probe_concat_scoring`` evaluates the concat scores with each item text.

On a mesh the tables are row-sharded as ``lgcn``'s (K2 over source
shards) and the text buffers stay whole: training scores pairs through
``score_pairwise`` with global ids, and the top-k is the fused
catalogue-sharded one, ``u_cat`` against this rank's rows of ``i_cat``
(``parallel.sharded.sharded_topk``); with the head off, the plain
sharded top-k.
"""

from __future__ import annotations

import torch

from ..ops.retrieval import catalog_scores, score_and_topk
from ..parallel.sharded import sharded_topk
from .lightgcn import LightGCN

ITEM_TEXT = {'reviews': 'items_as_avg_reviews', 'kg': 'items_as_desc'}


class LTRCosine(LightGCN):
    """LightGCN scored in ``[gnn ++ text]`` space."""

    # scores are one product u_cat @ i_cat.T: export_reprs writes the
    # factors (the JAX package's flag for its fused sharded top-k)
    supports_fused_sharded_topk = True

    def __init__(self, cfg, data, *, device=None, generator=None):
        super().__init__(cfg, data, device=device, generator=generator)
        for name in ('users_as_avg_reviews', *ITEM_TEXT.values()):
            self.device_buffer(name, getattr(data, name))
        self.set_items_text_mode('kg' if cfg.model == 'ltr_kg'
                                 else 'reviews')
        # off while --load_base evaluates the base with plain scoring
        self.score_with_head = True

    def set_items_text_mode(self, mode: str):
        """The item text of the scores: ``'reviews'`` or ``'kg'``."""
        if mode not in ITEM_TEXT:
            raise ValueError(f'item text mode {mode!r}: one of '
                             f'{", ".join(ITEM_TEXT)}')
        self.items_text_mode = mode

    @property
    def items_text(self) -> torch.Tensor:
        return getattr(self, ITEM_TEXT[self.items_text_mode])

    def score_pairwise(self, users_emb, items_emb, users, items):
        gnn = super().score_pairwise(users_emb, items_emb, users, items)
        if not self.score_with_head:
            return gnn
        txt = (self.users_as_avg_reviews[users]
               * self.items_text[items]).sum(dim=-1)
        return gnn + txt

    def fused_catalog_inputs(self, reprs, batch_users):
        """``(u_cat, i_cat, bias)``: the catalogue scores are exactly
        ``u_cat @ i_cat.T + bias``, bias 0.  ``reprs`` as
        ``scoring_reprs`` gives them: on a mesh ``i_cat`` holds this
        rank's item rows (``local_rows`` of the whole item text)."""
        users_repr, items_repr = reprs
        u_cat = torch.cat([users_repr[batch_users],
                           self.users_as_avg_reviews[batch_users]], dim=-1)
        i_cat = torch.cat([items_repr, self.local_rows(
            self.items_text, items_repr.shape[0])], dim=-1)
        return u_cat, i_cat, u_cat.new_zeros(())

    def score_batchwise(self, reprs, users: torch.Tensor) -> torch.Tensor:
        if not self.score_with_head:
            return super().score_batchwise(reprs, users)
        u_cat, i_cat, _ = self.fused_catalog_inputs(reprs, users)
        return catalog_scores(u_cat, i_cat)

    def topk_for_users(self, reprs, batch_users: torch.Tensor, k: int):
        if not self.score_with_head:
            return super().topk_for_users(reprs, batch_users, k)
        u_cat, i_cat, _ = self.fused_catalog_inputs(reprs, batch_users)
        if self.mesh is not None:
            return sharded_topk(self.mesh, u_cat, i_cat,
                                self.pos_padded[batch_users], k, self.n_items)
        return score_and_topk(u_cat, i_cat, self.pos_padded[batch_users],
                              k=k, n_items=self.n_items)


class LTRSimple(LTRCosine):
    """Concat scoring over a loaded base, without training."""


def probe_concat_scoring(trainer) -> dict[str, dict]:
    """``{mode: metrics}`` of the concat scores with the mean review
    vectors (``'reviews'``), then the descriptions (``'kg'``), as item
    text; the model's mode is restored after."""
    model = trainer.model
    results = {}
    orig = model.items_text_mode
    try:
        for mode in ITEM_TEXT:
            model.set_items_text_mode(mode)
            results[mode] = trainer.evaluate()
    finally:
        model.set_items_text_mode(orig)
    return results
