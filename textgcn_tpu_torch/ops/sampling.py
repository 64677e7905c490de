"""BPR triple sampling for one epoch, on the device.

Counterpart of ``textgcn_tpu/ops/sampling.py``: every user contributes
``bucket_len = n_train // n_users`` triples per epoch, positives are drawn
uniformly (with replacement) from the user's train items, negatives
uniformly from the catalogue without the user's train items, and the
epoch is permuted as a whole.  Negatives take ``REJECTION_ROUNDS`` redraws;
a survivor of all of them is replaced by an exact uniform draw from the
user's complement, found by bisection on its rank, so no negative is ever
a positive.

Every draw comes from the caller's ``torch.Generator``, on the device the
tables live on.  ``jax.random`` and torch give other numbers from one
seed, so the tests check properties, not values.

Membership and rank queries run ``torch.searchsorted`` over the padded
positive rows flattened into one sorted key vector, ``key = u * (n_items
+ 1) + pos_padded[u, j]``: each row is sorted and padded with ``n_items``,
so the keys are sorted, and a user's queries land in its own row.

``batch_epoch`` cuts the epoch into batches of ``batch_size`` with a
ragged last batch instead of the JAX package's padded tail and mask: the
mean over a ragged batch is the masked mean over a padded one
(``models/losses.py``).
"""

from __future__ import annotations

import torch

REJECTION_ROUNDS = 8


def positive_keys(pos_padded: torch.Tensor, n_items: int) -> torch.Tensor:
    """``(n_users * width,)`` int64 sorted keys of the padded positive
    rows."""
    n_users = pos_padded.shape[0]
    base = torch.arange(n_users, device=pos_padded.device) * (n_items + 1)
    return (base[:, None] + pos_padded.to(torch.int64)).reshape(-1)


def is_positive(keys: torch.Tensor, users: torch.Tensor,
                cand: torch.Tensor, n_items: int) -> torch.Tensor:
    """``cand[b, k]`` is one of ``users[b]``'s train items."""
    q = users[:, None] * (n_items + 1) + cand
    idx = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return keys[idx] == q


def complement_rank(keys: torch.Tensor, width: int, users: torch.Tensor,
                    r: torch.Tensor, n_items: int) -> torch.Tensor:
    """The ``r[b, k]``-th item (from 0) that is not a train item of
    ``users[b]``.

    ``g(x) = (x + 1) - |positives <= x|`` counts the non-positives in
    ``[0, x]`` and does not decrease, so the least ``x`` with ``g(x) = r +
    1`` is the answer: bisection in ``ceil(log2(n_items))`` steps.
    """
    base = users[:, None] * (n_items + 1)
    start = users[:, None] * width
    lo = torch.zeros_like(r)
    hi = torch.full_like(r, n_items - 1)
    for _ in range(max(1, int(n_items - 1).bit_length())):
        mid = (lo + hi) // 2
        n_pos_le = torch.searchsorted(keys, base + mid, right=True) - start
        right = (mid + 1 - n_pos_le) < r + 1
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    return lo


def sample_epoch(generator: torch.Generator, pos_padded: torch.Tensor,
                 pos_degree: torch.Tensor, *, bucket_len: int,
                 neg_samples: int, n_items: int,
                 keys: torch.Tensor | None = None):
    """One epoch of training triples, permuted: ``(users, pos, negs)`` of
    shapes ``(N,)``, ``(N,)``, ``(N, neg_samples)``, int64, with ``N =
    n_users * bucket_len``.  ``keys`` is ``positive_keys(pos_padded,
    n_items)``, made here when not given."""
    dev = pos_padded.device
    n_users, width = pos_padded.shape
    n = n_users * bucket_len
    if keys is None:
        keys = positive_keys(pos_padded, n_items)

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator,
                             device=dev)

    users = torch.arange(n_users, device=dev).repeat_interleave(bucket_len)
    deg = pos_degree.to(torch.int64)[users]
    pos = pos_padded[users, randint(1 << 30, (n,)) % deg.clamp(min=1)]
    pos = pos.to(torch.int64)

    cand = torch.zeros((n, neg_samples), dtype=torch.int64, device=dev)
    bad = torch.ones((n, neg_samples), dtype=torch.bool, device=dev)
    for _ in range(REJECTION_ROUNDS):
        cand = torch.where(bad, randint(n_items, cand.shape), cand)
        bad = is_positive(keys, users, cand, n_items)

    n_free = (n_items - deg).clamp(min=1)
    r = randint(1 << 30, cand.shape) % n_free[:, None]
    cand = torch.where(bad, complement_rank(keys, width, users, r, n_items),
                       cand)

    perm = torch.randperm(n, generator=generator, device=dev)
    return users[perm], pos[perm], cand[perm]


def num_batches(n: int, batch_size: int) -> int:
    return max(1, -(-n // batch_size))


def batch_epoch(users, pos, negs, *, batch_size: int):
    """The epoch as a list of ``(users, pos, negs)`` batches (views), the
    last one ragged."""
    return list(zip(torch.split(users, batch_size),
                    torch.split(pos, batch_size),
                    torch.split(negs, batch_size)))
