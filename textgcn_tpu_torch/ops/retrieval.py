"""Full-catalogue scoring, train-item mask, top-k and negative mining.

Counterpart of ``textgcn_tpu/ops/retrieval.py``: ``mask_train_items``,
``score_and_topk`` (with its serving mode), ``env_recall``,
``mining_top_k``, and ``lax.top_k``'s tie order as ``top_k_lower_index``.

Every catalogue product of the port (serving, the LTR heads' fused
scores, the concat scorers, hard-negative mining, the sharded top-k) goes
through ``catalog_scores``, which runs it in full float32.

**Serving mode** (``--approx_topk R``, exported as
``TEXTGCN_TPU_APPROX_TOPK``, or ``approx=R``; a recall target in (0, 1)):
the JAX package emits bfloat16 scores there and selects with
``lax.approx_max_k``.  The port rounds its float32 product to bfloat16 the
same way and selects the **exact** top-k of the rounded scores, ties to the
lower index: an exact selection meets any recall target.  The same holds
for ``TEXTGCN_TPU_ADV_TOPK``'s mining target, which the port reads as the
JAX package does and then mines exactly (logged once).
``TEXTGCN_TPU_BLOCKED_TOPK`` (a TPU workaround, exact in the JAX package
too) is accepted and ignored.
"""

from __future__ import annotations

import logging
import os

import torch

from ..utils.profiling import span

ADV_TOPK_ENV = 'TEXTGCN_TPU_ADV_TOPK'
APPROX_TOPK_ENV = 'TEXTGCN_TPU_APPROX_TOPK'
# the JAX package's mining target when the variable names none it can use
DEFAULT_ADV_RECALL = 0.95

log = logging.getLogger('textgcn_tpu_torch')
_logged_adv_targets: set[str] = set()


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


def env_recall() -> float:
    """The ``TEXTGCN_TPU_APPROX_TOPK`` serving opt-in as a recall target
    (0: exact scoring), parsed as the JAX package parses it."""
    try:
        return float(os.environ.get(APPROX_TOPK_ENV, ''))
    except ValueError:
        return 0.0


def serving_mode(approx: float | None) -> bool:
    """Whether ``approx`` (``None``: the environment's) asks for serving
    mode: a recall target in (0, 1)."""
    approx = env_recall() if approx is None else approx
    return 0.0 < approx < 1.0


def score_and_topk(users_emb: torch.Tensor, items_emb: torch.Tensor,
                   batch_pos_padded: torch.Tensor, *, k: int, n_items: int,
                   approx: float | None = None):
    """Dot-product scores of a user batch against the whole catalogue,
    train-masked, and the top-k ``(values, indices)``, values float32.

    In serving mode (``approx``, or the environment's target) the scores
    are rounded to bfloat16 and the exact top-k of them is taken with ties
    to the lower index.  Spans: ``retrieve.scores``, ``retrieve.mask``
    (with the cast), ``retrieve.topk``."""
    with span('retrieve.scores'):
        scores = catalog_scores(users_emb, items_emb[:n_items])
    if serving_mode(approx):
        with span('retrieve.mask'):
            scores = mask_train_items(scores.to(torch.bfloat16),
                                      batch_pos_padded, n_items)
        with span('retrieve.topk'):
            vals, idx = top_k_lower_index(scores, k)
            return vals.float(), idx
    with span('retrieve.mask'):
        scores = mask_train_items(scores, batch_pos_padded, n_items)
    with span('retrieve.topk'):
        return torch.topk(scores, k, dim=1)


def adv_recall_target() -> float | None:
    """``TEXTGCN_TPU_ADV_TOPK`` as the JAX package reads it: ``None`` for
    empty or ``exact``, else the recall target, an unparsable or
    out-of-range value read as 0.95."""
    env = os.environ.get(ADV_TOPK_ENV, '')
    if env in ('', 'exact'):
        return None
    try:
        recall = float(env)
    except ValueError:
        return DEFAULT_ADV_RECALL
    return recall if 0.0 < recall < 1.0 else DEFAULT_ADV_RECALL


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
    tie decides which item is a negative at all.  A
    ``TEXTGCN_TPU_ADV_TOPK`` recall target is met by the exact selection;
    the first call under each value logs so."""
    env = os.environ.get(ADV_TOPK_ENV, '')
    target = adv_recall_target()
    if target is not None and env not in _logged_adv_targets:
        _logged_adv_targets.add(env)
        log.info('%s=%s: recall target %g; hard negatives are mined '
                 'exactly (an exact top-k meets any recall target)',
                 ADV_TOPK_ENV, env, target)
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
