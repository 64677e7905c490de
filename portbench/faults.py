"""Faults planted in the program's objects, for the readings that set the
limits and for the test that sees ``correct`` come out false.

* ``unchanged``: a step that returns its state unchanged (training: Adam
  steps nothing; serving: the propagation returns the layer-0 tables);
* ``half_batch``: half of the batch left out (training: the loss of the
  first half of each batch, its mean over that half; serving: each
  batch's second half answered with the first half's rows);
* ``answer_altered``: an answer altered where it is produced (serving:
  each user's best item replaced by its 40th; ``adv_sampling``: each
  user's first mined negative moved to the next item);
* ``adv_sampling``'s draws broken where they are made (``model.loss``):
  ``candidates_all`` every item a candidate, ``candidates_fixed`` the
  first row's candidates for every user of every step,
  ``positives_fixed`` every positive draw 0.

Each replaces a method on the instance only; the class is untouched.
"""

from __future__ import annotations

import torch

DRAW_FAULTS = ('candidates_all', 'candidates_fixed', 'positives_fixed')


def plant(ctx, fault: str):
    kind = ctx.cell.traffic['kind']
    model, trainer = ctx.model, ctx.trainer
    if fault == 'unchanged' and kind == 'train':
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == 'unchanged' and kind == 'serve':
        model.scoring_reprs = lambda: (model.user_emb, model.item_emb)
    elif fault == 'half_batch' and kind == 'train':
        loss = model.loss

        def half_loss(batch, **kw):
            return loss(tuple(t[:max(1, len(t) // 2)] for t in batch), **kw)
        model.loss = half_loss
    elif fault == 'half_batch' and kind == 'serve':
        topk = model.topk_for_users

        def half_topk(reprs, users, k):
            h = max(1, len(users) // 2)
            v, i = topk(reprs, users[:h], k)
            rep = torch.arange(len(users), device=users.device) % h
            return v[rep], i[rep]
        model.topk_for_users = half_topk
    elif fault == 'answer_altered' and kind == 'serve':
        topk = model.topk_for_users

        def altered(reprs, users, k):
            v, i = topk(reprs, users, k)
            v, i = v.clone(), i.clone()
            v[:, 0], i[:, 0] = v[:, -1], i[:, -1]
            return v, i
        model.topk_for_users = altered
    elif fault == 'answer_altered' and hasattr(model, 'hard_negatives'):
        mine = model.hard_negatives

        def altered_negs(*args):
            negs, valid = mine(*args)
            negs = negs.clone()
            negs[:, 0] = (negs[:, 0] + 1) % model.n_items
            return negs, valid
        model.hard_negatives = altered_negs
    elif fault in DRAW_FAULTS and hasattr(model, 'hard_negatives'):
        model.loss = broken_draws(model, fault)
    else:
        raise ValueError(f'{fault!r} is no fault of a {kind} cell of '
                         f'{ctx.cell.config["model"]}')


def broken_draws(model, fault: str):
    """``model.loss`` of ``adv_sampling`` with its draws made as the
    program makes them, then broken by ``fault``; the loss goes on
    through ``model.loss_given`` as the program's does."""
    first = {}

    def loss(batch, *, generator=None, w_pairs=None):
        users = batch[0]
        b, n = users.shape[0], model.n_items
        keep = torch.rand((b, n), generator=model.generator,
                          device=model.device) < model.n_candidates / n
        ridx = torch.randint(0, 1 << 30, (b, model.pos_samples),
                             generator=model.generator, device=model.device)
        if fault == 'candidates_all':
            keep = torch.ones_like(keep)
        elif fault == 'candidates_fixed':
            row = first.setdefault('keep', keep[:1].clone())
            keep = row.expand(b, n).contiguous()
        else:
            ridx = torch.zeros_like(ridx)
        return model.loss_given(users, keep, ridx, *w_pairs)
    return loss
