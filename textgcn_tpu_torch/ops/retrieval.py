"""Full-catalogue scoring, train-item mask, exact top-k and negative mining.

Counterpart of ``textgcn_tpu/ops/retrieval.py`` (``mask_train_items``,
``score_and_topk``, ``mining_top_k``, and ``lax.top_k``'s tie order as
``top_k_lower_index``), exact only: the JAX package's
approximate serving mode and its approximate mining (``lax.approx_max_k``)
are not ported.

Every catalogue product of the port (serving, the LTR heads' fused
scores, the concat scorers, hard-negative mining, the sharded top-k) goes
through ``catalog_scores``, which runs it in full float32.
"""

from __future__ import annotations

import os

import torch

ADV_TOPK_ENV = 'TEXTGCN_TPU_ADV_TOPK'


def catalog_scores(users_emb: torch.Tensor,
                   items_emb: torch.Tensor) -> torch.Tensor:
    """``users_emb @ items_emb.T`` in full float32: TF32 is switched off
    (process-wide) here, for every caller alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(users_emb, items_emb.T)


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
    train-masked, and the top-k ``(values, indices)``."""
    scores = catalog_scores(users_emb, items_emb[:n_items])
    scores = mask_train_items(scores, batch_pos_padded, n_items)
    return torch.topk(scores, k, dim=1)


def check_adv_topk_env():
    """``TEXTGCN_TPU_ADV_TOPK``: empty or ``exact`` (the port mines
    exactly); a recall target, the JAX package's approximate mining, is
    refused."""
    env = os.environ.get(ADV_TOPK_ENV, '')
    if env not in ('', 'exact'):
        raise NotImplementedError(
            f'{ADV_TOPK_ENV}={env!r}: approximate negative mining is not '
            'ported yet (the port mines exactly: leave it empty or set '
            'exact)')


def _ordered_bits(scores: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(bits, width)``: int32 keys in the order of the float32 or
    bfloat16 ``scores`` (-0 below +0), ``width`` bits wide: the bits as a
    signed integer, the magnitude bits flipped where the sign is set."""
    if scores.dtype == torch.bfloat16:
        bits, width = scores.view(torch.int16).to(torch.int32), 16
    elif scores.dtype == torch.float32:
        bits, width = scores.view(torch.int32), 32
    else:
        raise TypeError(f'mining takes float32 or bfloat16 scores, not '
                        f'{scores.dtype}')
    return bits ^ ((bits >> 31) & ((1 << (width - 1)) - 1)), width


def mining_top_k(scores: torch.Tensor, k: int):
    """``top_k_lower_index`` for hard-negative mining: at the k-th place a
    tie decides which item is a negative at all.  Refuses an approximate
    ``TEXTGCN_TPU_ADV_TOPK``."""
    check_adv_topk_env()
    return top_k_lower_index(scores, k)


def top_k_lower_index(scores: torch.Tensor, k: int):
    """Exact top-k ``(values, indices)`` over the last axis, ties to the
    lower index, as ``lax.top_k`` breaks them (``torch.topk`` promises no
    order among equals).  One ``torch.topk`` over unique integer keys: the
    score's ordered bits above the complement of the index, in int32 when
    they fit (bf16 scores of up to 65,536 items), else int64."""
    n = scores.shape[-1]
    shift = max(1, (n - 1).bit_length())
    bits, width = _ordered_bits(scores)
    low = (1 << shift) - 1
    dtype = torch.int32 if width + shift <= 32 else torch.int64
    idx = torch.arange(n, device=scores.device, dtype=dtype)
    keys = bits.to(dtype) * (1 << shift) + (low - idx)
    top = torch.topk(keys, k, dim=-1).values
    indices = (low - (top & low)).to(torch.int64)
    return scores.gather(-1, indices), indices
