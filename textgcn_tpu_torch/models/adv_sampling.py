"""Adversarial (hard-negative) sampling: ``adv_sampling``.

Counterpart of ``textgcn_tpu/models/adv_sampling.py``.  Per training user,
``min(n_items, 1000)`` candidate items are drawn (a Bernoulli mask with
p = ``n_candidates / n_items`` over the catalogue), positives are masked
out, the ``min(max(k), n_candidates)`` highest-scoring candidates become
the user's negatives, and ``POS_SAMPLES`` positives drawn with replacement
pair with each of them in a BPR + L2 loss over the (B, P, K) grid.

A step propagates twice: a rank pass without gradient that scores the
candidates, and the loss pass, each with its own dropout salts
(``salt_pairs_per_step``; the trainer draws the rank pass's first).  The
mining scores are rounded to bfloat16 as the JAX package rounds them, and
the top-k is exact with ties to the lower index (``ops.retrieval
.mining_top_k``).  The candidate mask and the positive draws come from
the model's own device generator (``generator``, seeded with ``cfg.seed
+ 2``), which a resume restores.

On a mesh every rank draws the whole batch's candidate mask and positive
draws, so the draws, and the generator's state, are the single card's;
it keeps its ``tensor_split`` of the batch's rows.  The rank pass
propagates on K2's source shards and gathers the whole propagated
tables once; each rank mines its own users' rows against the whole item
table (the single card's selection, ties included: no catalogue-sharded
merge).  The loss pass gathers the tables as ``LightGCN.loss`` does and
divides by the whole batch's count of valid pairs, summed over the
ranks, so the ranks' losses sum to the single card's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.retrieval import catalog_scores, mask_train_items, mining_top_k
from ..parallel.sharded import all_reduce_sum
from ..utils.profiling import span
from .lightgcn import LightGCN

POS_SAMPLES = 5
MAX_NEG_CANDIDATES = 1000


class AdvSamplModel(LightGCN):

    # the rank pass's salts, then the loss pass's
    salt_pairs_per_step = 2

    def __init__(self, cfg, data, *, device=None, generator=None):
        super().__init__(cfg, data, device=device, generator=generator)
        self.n_candidates = min(self.n_items, MAX_NEG_CANDIDATES)
        self.pos_samples = POS_SAMPLES
        self.n_hard_negs = min(max(cfg.k), self.n_candidates)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 2)

    def sample_batches(self, generator: torch.Generator, batch_size: int):
        """One permuted epoch of user rows (``bucket_len`` a user) as a
        list of ``(users,)`` batches, the last one ragged."""
        with span('train.sample_epoch'):
            users = torch.arange(self.n_users, device=self.device
                                 ).repeat_interleave(self.bucket_len)
            perm = torch.randperm(self.iterable_len, generator=generator,
                                  device=self.device)
            return [(b,) for b in torch.split(users[perm], batch_size)]

    def loss(self, batch, *, generator: torch.Generator | None = None,
             w_pairs=None):
        """``(loss, {'bpr', 'reg'})`` of a batch ``(users,)``: the
        candidate mask and positive draws from ``self.generator``, the two
        passes' salts ``w_pairs = (w_rank, w_loss)`` (or drawn from
        ``generator``, rank pass first), then ``loss_given``."""
        users = batch[0]
        if w_pairs is None:
            w_pairs = tuple(self.graph_op.weights(generator, self.dropout)
                            for _ in range(self.salt_pairs_per_step))
        b, p = users.shape[0], self.n_candidates / self.n_items
        keep = torch.rand((b, self.n_items), generator=self.generator,
                          device=self.device) < p
        ridx = torch.randint(0, 1 << 30, (b, self.pos_samples),
                             generator=self.generator, device=self.device)
        return self.loss_given(users, keep, ridx, *w_pairs)

    def hard_negatives(self, users_repr, items_repr, users, keep):
        """``(negs, neg_valid)``, ``(B, n_hard_negs)``: the top-scoring
        candidates of each user that are no train item, scored in float32
        and rounded to bfloat16; ``neg_valid`` is False where fewer
        candidates were left.  Spans: ``mining``, and in it
        ``mining.scores``, ``mining.mask`` and ``mining.topk``."""
        with span('mining'):
            with span('mining.scores'):
                scores = catalog_scores(users_repr[users], items_repr)
            with span('mining.mask'):
                scores = mask_train_items(scores.to(torch.bfloat16),
                                          self.pos_padded[users],
                                          self.n_items)
                scores = scores.masked_fill(~keep, -torch.inf)
            with span('mining.topk'):
                top, negs = mining_top_k(scores, self.n_hard_negs)
            return negs, top > -torch.inf

    def loss_given(self, users, keep, ridx, w_rank, w_loss):
        """The loss with the random draws given: ``keep`` (B, n_items) the
        candidate mask, ``ridx`` (B, P) the positive draws (taken modulo
        the user's degree), ``w_rank`` and ``w_loss`` the passes' salt
        pairs; on a mesh the whole batch's, of which this rank takes its
        share (see the module docstring)."""
        _, (users, keep, ridx) = self.rank_share((users, keep, ridx))
        with torch.no_grad():
            users_r, items_r = self.representation(training=True,
                                                   w_pairs=w_rank)
            negs, neg_valid = self.hard_negatives(
                self.gathered(users_r, self.n_users),
                self.gathered(items_r, self.n_items), users, keep)
        users_repr, items_repr, user_emb, item_emb = self.whole_tables(
            *self.representation(training=True, w_pairs=w_loss),
            self.user_emb, self.item_emb)
        l_bpr, l_reg = self.expanded_loss(users_repr, items_repr, users,
                                          self.positives(users, ridx), negs,
                                          neg_valid, user_emb, item_emb)
        return l_bpr + l_reg, {'bpr': l_bpr, 'reg': l_reg}

    def positives(self, users, ridx):
        """(B, P) train items of ``users``: ``ridx`` modulo the degree."""
        deg = self.pos_degree[users].to(torch.int64).clamp(min=1)
        return self.pos_padded[users].gather(1, ridx % deg[:, None]).to(
            torch.int64)

    def expanded_loss(self, users_repr, items_repr, users, pos, negs,
                      neg_valid, user_emb=None, item_emb=None):
        """``(bpr, reg)`` over the (B, P, K) grid of each user's positives
        and valid negatives: the base losses of the flat expanded batch,
        each row's layer-0 norms counted once per pair it is in.  The
        layer-0 tables default to the model's; on a mesh they are the
        gathered whole ones and the count of valid pairs the loss divides
        by is summed over the ranks."""
        if user_emb is None:
            user_emb, item_emb = self.user_emb, self.item_emb
        p = pos.shape[1]
        u = users_repr[users]
        pos_s = self.score_pairwise(u[:, None, :], items_repr[pos],
                                    users[:, None], pos)
        neg_s = self.score_pairwise(u[:, None, :], items_repr[negs],
                                    users[:, None], negs)
        diff = F.selu(neg_s[:, None, :] - pos_s[:, :, None])
        valid = neg_valid[:, None, :].expand_as(diff)
        denom = valid.sum()
        if self.mesh is not None:
            denom = all_reduce_sum(denom)
        denom = denom.clamp(min=1).to(diff.dtype)
        l_bpr = torch.where(valid, diff, 0.0).sum() / denom

        kv = neg_valid.sum(dim=1).to(diff.dtype)
        u_sq = (user_emb[users].square().sum(1) * p * kv).sum()
        p_sq = (item_emb[pos].square().sum(2).sum(1) * kv).sum()
        n_sq = ((item_emb[negs].square().sum(2) * neg_valid).sum(1)
                * p).sum()
        l_reg = self.reg_lambda * (u_sq + p_sq + n_sq) / denom / 2.0
        return l_bpr, l_reg
