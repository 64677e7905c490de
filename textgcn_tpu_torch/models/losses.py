"""BPR + L2 regularisation losses.

Counterpart of ``textgcn_tpu/models/losses.py``:

* BPR: the mean over the negative columns of the batch mean of
  ``selu(neg_score - pos_score)``;
* reg: ``reg_lambda * (sum |E_u[users]|^2 + sum |E_i[pos]|^2 + sum
  |E_i[negs]|^2) / batch / 2`` on the layer-0 tables.

Both take an optional per-sample mask, for a batch padded as the JAX
package pads its last one; without it every row of the batch counts, which
is the same mean over a ragged last batch.  ``count`` overrides the number
of rows the mean divides by: on a mesh each rank passes its part of a batch
with the whole batch's count, so the ranks' losses sum to the batch's mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _count(mask, n: int, like: torch.Tensor, count: int | None = None):
    if count is not None:
        return float(max(count, 1))
    if mask is None:
        return float(max(n, 1))
    return mask.to(like.dtype).sum().clamp(min=1.0)


def bpr_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
             mask: torch.Tensor | None = None,
             count: int | None = None) -> torch.Tensor:
    """``pos_scores``: (B,); ``neg_scores``: (B, n_neg); ``mask``: (B,)."""
    diff = F.selu(neg_scores - pos_scores[:, None])
    if mask is not None:
        diff = torch.where(mask[:, None], diff, 0.0)
    per_neg = diff.sum(dim=0)
    return (per_neg / _count(mask, diff.shape[0], diff, count)).mean()


def reg_loss(user_emb0: torch.Tensor, item_emb0: torch.Tensor,
             users: torch.Tensor, pos: torch.Tensor, negs: torch.Tensor,
             reg_lambda: float,
             mask: torch.Tensor | None = None,
             count: int | None = None) -> torch.Tensor:
    """L2 regularisation on the gathered layer-0 embedding rows."""
    u_sq = user_emb0[users].square().sum(dim=1)
    p_sq = item_emb0[pos].square().sum(dim=1)
    n_sq = item_emb0[negs].square().sum(dim=2).sum(dim=1)
    per_row = u_sq + p_sq + n_sq
    if mask is not None:
        per_row = per_row * mask.to(per_row.dtype)
    count = _count(mask, users.shape[0], per_row, count)
    return reg_lambda * per_row.sum() / count / 2.0
