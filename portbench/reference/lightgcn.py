"""The plain reference of the cells: LightGCN propagation with the hash
edge dropout, the BPR + L2 losses of ``lgcn`` and ``adv_sampling``, the
hard-negative mining, Adam, and the masked full-catalogue scores.

Plain PyTorch on whatever device it is given, in the dtype of the tables
it is handed (float64 for the comparisons), with no kernel, no cache and
no batching of the program.  It imports nothing of the program and takes
no table, CSR, mask or id map from it: everything is rebuilt from the
generated pairs (``graphgen.Interactions``) and the benchmark's own
inputs.  The hash is a frozen copy of the one the program and the JAX
package share (``pallas_spmm.py``'s ``edge_dropout_scale``).

Ids: the program numbers users and items in order of first appearance
in the train table sorted by (user_id, asin) as strings; the generated
ids are zero-padded, so string order is id order, and ``RefGraph``
numbers rows the same way from the pairs alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

_M1 = 2654435761
_M2 = 2246822519
_F1 = 0x7FEB352D
_F2 = 0x846CA68B
_U32 = 0xFFFFFFFF
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# advanced_sampling.py: max_neg_samples, pos_samples
MAX_NEG_CANDIDATES = 1000
POS_SAMPLES = 5
POS_DRAW_RANGE = 1 << 30
SIGMAS = 7.0


def hash_kept(user: torch.Tensor, item: torch.Tensor, salt: int,
              keep: float) -> torch.Tensor:
    """Whether the hash dropout keeps each (user, item) edge under
    ``(salt, keep)``: the murmur-style finalizer's top 23 bits as a
    float32 uniform, below ``float32(keep)``; every edge at keep >= 1."""
    keep32 = np.float32(keep)
    if keep32 >= 1.0:
        return torch.ones(user.shape, dtype=torch.bool, device=user.device)
    u = user.to(torch.int64) & _U32
    i = item.to(torch.int64) & _U32
    h = ((u * _M1) & _U32) ^ ((i * _M2) & _U32) ^ (int(salt) & _U32)
    h = h ^ (h >> 16)
    h = (h * _F1) & _U32
    h = h ^ (h >> 15)
    h = (h * _F2) & _U32
    h = h ^ (h >> 16)
    unif = (h >> 9).to(torch.float32) * (1.0 / 8388608.0)
    return unif < float(keep32)


def inverse_keep(keep: float) -> float:
    """The scale of a kept edge, ``1 / keep`` in float32."""
    return float(np.float32(1.0) / np.float32(keep))


@dataclass
class RefGraph:
    """The train graph in the program's row numbering."""
    n_users: int
    n_items: int
    edge_user: torch.Tensor     # (E,) int64
    edge_item: torch.Tensor     # (E,) int64
    edge_weight: torch.Tensor   # (E,) float64, 1/sqrt(deg_u deg_i)
    pos_ptr: torch.Tensor       # (n_users + 1,) int64
    pos_items: torch.Tensor     # (E,) int64, each user's items ascending
    user_of_generated: np.ndarray   # generated user id -> row, -1 if none
    item_of_generated: np.ndarray

    @classmethod
    def build(cls, train_user: np.ndarray, train_item: np.ndarray,
              n_users_generated: int, n_items_generated: int,
              device) -> 'RefGraph':
        train_user = np.asarray(train_user, np.int64)
        train_item = np.asarray(train_item, np.int64)
        order = np.lexsort((train_item, train_user))
        su, si = train_user[order], train_item[order]
        users = np.unique(su)
        user_of = np.full(n_users_generated, -1, np.int64)
        user_of[users] = np.arange(len(users))
        items, first = np.unique(si, return_index=True)
        by_first = items[np.argsort(first, kind='stable')]
        item_of = np.full(n_items_generated, -1, np.int64)
        item_of[by_first] = np.arange(len(by_first))
        eu, ei = user_of[su], item_of[si]
        nu, ni = len(users), len(by_first)
        du = np.bincount(eu, minlength=nu).astype(np.float64)
        di = np.bincount(ei, minlength=ni).astype(np.float64)
        w = 1.0 / np.sqrt(du[eu] * di[ei])
        o2 = np.lexsort((ei, eu))
        ptr = np.zeros(nu + 1, np.int64)
        np.cumsum(du.astype(np.int64), out=ptr[1:])

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(nu, ni, t(eu), t(ei), t(w), t(ptr), t(ei[o2]),
                   user_of, item_of)

    @property
    def degree(self) -> torch.Tensor:
        return self.pos_ptr[1:] - self.pos_ptr[:-1]

    def train_cells(self, users: torch.Tensor):
        """``(row, item)`` of every train pair of the batch ``users``:
        ``row`` indexes ``users``."""
        deg = self.degree[users]
        rows = torch.repeat_interleave(
            torch.arange(len(users), device=users.device), deg)
        starts = torch.repeat_interleave(self.pos_ptr[users], deg)
        first = torch.repeat_interleave(torch.cumsum(deg, 0) - deg, deg)
        offs = torch.arange(len(rows), device=users.device) - first
        return rows, self.pos_items[starts + offs]

    def is_train(self, users: torch.Tensor,
                 items: torch.Tensor) -> torch.Tensor:
        """Whether ``items[b, ...]`` is a train item of ``users[b]``."""
        keys = self.edge_user * self.n_items + self.edge_item
        keys = torch.sort(keys).values
        q = users.reshape(-1, *([1] * (items.dim() - 1))) * self.n_items \
            + items
        at = torch.searchsorted(keys, q).clamp(max=len(keys) - 1)
        return keys[at] == q

    def masked(self, scores: torch.Tensor,
               users: torch.Tensor) -> torch.Tensor:
        """``scores`` (B, n_items) with the train items set to -inf."""
        rows, items = self.train_cells(users)
        out = scores.clone()
        out[rows, items] = -torch.inf
        return out


def propagate(g: RefGraph, user_emb: torch.Tensor, item_emb: torch.Tensor,
              n_layers: int, salts=None):
    """The layer mean of ``n_layers`` propagations; with ``salts =
    ((salt_to_user, keep), (salt_to_item, keep))`` each direction keeps
    the edges the hash keeps, scaled by ``1 / keep``.  Differentiable."""
    w_u = w_i = g.edge_weight.to(user_emb.dtype)
    if salts is not None:
        (s_u, k_u), (s_i, k_i) = salts
        w_u = w_u * torch.where(hash_kept(g.edge_user, g.edge_item, s_u,
                                          k_u), inverse_keep(k_u), 0.0)
        w_i = w_i * torch.where(hash_kept(g.edge_user, g.edge_item, s_i,
                                          k_i), inverse_keep(k_i), 0.0)
    u, i = user_emb, item_emb
    acc_u, acc_i = user_emb, item_emb
    for _ in range(n_layers):
        u, i = (torch.zeros_like(u).index_add(0, g.edge_user,
                                              i[g.edge_item] * w_u[:, None]),
                torch.zeros_like(i).index_add(0, g.edge_item,
                                              u[g.edge_user] * w_i[:, None]))
        acc_u = acc_u + u
        acc_i = acc_i + i
    inv = 1.0 / (n_layers + 1)
    return acc_u * inv, acc_i * inv


def bpr_loss(reprs, emb0, users, pos, negs, reg_lambda: float):
    """``lgcn``'s loss: the mean over negative columns of the batch mean
    of ``selu(neg - pos)``, plus ``reg_lambda`` times the squared norms
    of the batch's layer-0 rows over the batch, halved."""
    ur, ir = reprs
    u0, i0 = emb0
    u = ur[users]
    pos_s = (u * ir[pos]).sum(-1)
    neg_s = (u[:, None, :] * ir[negs]).sum(-1)
    b = len(users)
    bpr = (F.selu(neg_s - pos_s[:, None]).sum(0) / b).mean()
    reg = reg_lambda * (u0[users].square().sum() + i0[pos].square().sum()
                        + i0[negs].square().sum()) / b / 2.0
    return bpr + reg


def expanded_loss(reprs, emb0, users, pos, negs, neg_valid,
                  reg_lambda: float):
    """``adv_sampling``'s loss over the (B, P, K) grid of each user's
    positives and valid negatives, each layer-0 row counted once a pair
    it is in."""
    ur, ir = reprs
    u0, i0 = emb0
    p = pos.shape[1]
    u = ur[users]
    pos_s = (u[:, None, :] * ir[pos]).sum(-1)
    neg_s = (u[:, None, :] * ir[negs]).sum(-1)
    diff = F.selu(neg_s[:, None, :] - pos_s[:, :, None])
    valid = neg_valid[:, None, :].expand_as(diff)
    denom = valid.sum().clamp(min=1).to(diff.dtype)
    bpr = torch.where(valid, diff, 0.0).sum() / denom
    kv = neg_valid.sum(1).to(diff.dtype)
    u_sq = (u0[users].square().sum(1) * p * kv).sum()
    p_sq = (i0[pos].square().sum(2).sum(1) * kv).sum()
    n_sq = ((i0[negs].square().sum(2) * neg_valid).sum(1) * p).sum()
    return bpr + reg_lambda * (u_sq + p_sq + n_sq) / denom / 2.0


def lower_index_top(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest ``values`` a row, ties to the lower
    index."""
    return torch.sort(values, dim=1, descending=True,
                      stable=True).indices[:, :k]


def mined_scores(g: RefGraph, reprs, users, candidates) -> torch.Tensor:
    """The exact scores hard-negative mining ranks: each user against the
    catalogue, -inf where an item is no candidate or a train item."""
    ur, ir = reprs
    scores = g.masked(ur[users] @ ir.T, users)
    return scores.masked_fill(~candidates, -torch.inf)


def draws_bad(masks: list[torch.Tensor], ridx: list[torch.Tensor],
              n_items: int) -> int:
    """Rows of the hard-negative draws, one mask and one positive draw a
    step, that no sampler of ``min(n_items, MAX_NEG_CANDIDATES)``
    candidates a user expected (each item a candidate with p = that over
    ``n_items``) and ``POS_SAMPLES`` uniform positive draws would give,
    beyond ``SIGMAS`` standard deviations: a user's count of candidates;
    the batch's mean count (all its rows); a set that shares with the
    next user's of its step, or with its own row's of the next step, more
    than half-way from chance to the whole set; a positive draw out of
    range or a wrong count of them, and repeats beyond chance (all the
    step's rows)."""
    p = min(n_items, MAX_NEG_CANDIDATES) / n_items
    want, sd = n_items * p, (n_items * p * (1 - p)) ** 0.5
    bad = 0
    for k, keep in enumerate(masks):
        b = keep.shape[0]
        if keep.shape[1] != n_items:
            return b
        count = keep.sum(1, dtype=torch.float64)
        bad += int(((count - want).abs() > SIGMAS * sd + 1e-6).sum())
        if abs(float(count.mean()) - want) > SIGMAS * sd / b ** 0.5 + 1e-6:
            bad += b
        pairs = [(keep[1:], keep[:-1], count[1:])]
        if k + 1 < len(masks) and masks[k + 1].shape == keep.shape:
            pairs.append((keep, masks[k + 1], count))
        for a, other, n_a in pairs:
            shared = (a & other).sum(1, dtype=torch.float64)
            bad += int((shared > n_a * p + n_a * (1 - p) / 2).sum())
    for r in ridx:
        n = r.numel()
        if r.shape[1:] != (POS_SAMPLES,):
            bad += r.shape[0]
            continue
        bad += int(((r < 0) | (r >= POS_DRAW_RANGE)).sum())
        chance = n * n / 2 / POS_DRAW_RANGE     # expected repeats
        if n - torch.unique(r).numel() > 4 + SIGMAS * (chance
                                                       + chance ** 0.5):
            bad += r.shape[0]
    return bad


class Adam:
    """``torch.optim.Adam``'s update (lr, betas, eps; no weight decay),
    written out."""

    def __init__(self, params, lr: float):
        self.params = list(params)
        self.lr = lr
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        b1, b2 = ADAM_BETAS
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 ** 0.5 + ADAM_EPS))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest: what a TF32 product multiplies."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8_rowwise(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 after scaling each row's largest
    magnitude to the format's 448, and scaled back."""
    finite = torch.where(torch.isfinite(x), x.abs(), 0.0)
    scale = finite.amax(dim=1, keepdim=True).clamp(min=1e-30) / 448.0
    y = (x / scale).clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
    return torch.where(torch.isfinite(x), y.to(x.dtype) * scale, x)
