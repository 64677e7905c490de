"""Full-catalogue scoring, train-item mask and exact top-k.

Counterpart of ``textgcn_tpu/ops/retrieval.py`` (``mask_train_items``,
``score_and_topk``), exact only: the JAX package's approximate serving
mode (``lax.approx_max_k``) is not ported.
"""

from __future__ import annotations

import torch


def mask_train_items(scores: torch.Tensor, batch_pos_padded: torch.Tensor,
                     n_items: int) -> torch.Tensor:
    """Set the scores of already-interacted items to -inf.

    ``scores``: (B, >= n_items), columns past ``n_items`` are sliced off.
    ``batch_pos_padded``: (B, max_deg), padded with ids >= ``n_items``.
    One scatter-``amin``: a real position contributes -inf, a padding slot
    contributes +inf at column ``n_items - 1`` and so changes nothing.
    """
    scores = scores[:, :n_items]
    valid = batch_pos_padded < n_items
    cols = torch.where(valid, batch_pos_padded,
                       torch.full_like(batch_pos_padded, n_items - 1))
    fill = torch.where(valid, -torch.inf, torch.inf).to(scores.dtype)
    return scores.scatter_reduce(1, cols.to(torch.int64), fill, 'amin')


def score_and_topk(users_emb: torch.Tensor, items_emb: torch.Tensor,
                   batch_pos_padded: torch.Tensor, *, k: int, n_items: int):
    """Dot-product scores of a user batch against the whole catalogue,
    train-masked, and the top-k ``(values, indices)``.

    The product runs in full float32: TF32 is switched off explicitly.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    scores = torch.matmul(users_emb, items_emb[:n_items].T)
    scores = mask_train_items(scores, batch_pos_padded, n_items)
    return torch.topk(scores, k, dim=1)
