"""The training window: a closed loop over ``Trainer.epoch_step``.

Set-up samples the first epoch with ``model.sample_batches`` from the
trainer's generator and drives the first ``check_steps`` steps through
the same call the window makes, recording what the reference needs: the
dropout salts the trainer draws, the batches, and for ``adv_sampling``
the candidate masks, the positive draws and the mined negatives; the
program's loss per step, its first gradient per table (Adam's first
moment after one step over ``1 - beta1``) and each table's change after
the check steps.  Then ``warmup_steps`` more steps.

The window goes on from there, step after step, resampling at each
epoch's end and fetching the epoch's loss sum as ``Trainer.train_epoch``
and ``fit`` do, until ``--seconds`` have passed; it ends in a
synchronise.  ``train_examples_per_s`` is ``batch_size`` for each step
completed (``fit``'s count) over the window's seconds.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import work
from ..harness import (Ctx, activities, id_map_bad, patched, ranged,
                       window_range)
from ..reference import lightgcn as ref
from ..tracing import Trace

ADAM_BETA1 = 0.9


@dataclass
class State:
    gen_s: float = 0.0
    batches: list = field(default_factory=list)
    pos: int = 0
    epoch_losses: list = field(default_factory=list)
    nan_epochs: int = 0
    # the check steps
    salts: list = field(default_factory=list)
    feeds: list = field(default_factory=list)       # the batches fed
    inputs: list = field(default_factory=list)      # adv: what loss_given got
    mined: list = field(default_factory=list)       # (negs, valid) a step
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)  # per table
    change_norms: list = field(default_factory=list)


def is_adv(ctx: Ctx) -> bool:
    return hasattr(ctx.model, 'hard_negatives')


def step(ctx: Ctx, st: State):
    """One step of the loop: a new epoch when the last one is done (its
    loss sum fetched and checked, as ``fit`` does once an epoch)."""
    if st.pos == len(st.batches):
        new_epoch(ctx, st)
    loss, _ = ctx.trainer.epoch_step(st.pos, st.batches[st.pos])
    st.epoch_losses.append(loss)
    st.pos += 1


def new_epoch(ctx: Ctx, st: State):
    finish_epoch(st)
    st.batches = ctx.model.sample_batches(ctx.trainer.generator,
                                          ctx.cfg.batch_size)
    st.pos = 0


def finish_epoch(st: State):
    if st.epoch_losses:
        if not math.isfinite(float(torch.stack(st.epoch_losses).sum())):
            st.nan_epochs += 1
        st.epoch_losses = []


def setup(ctx: Ctx) -> State:
    st = State()
    trainer, model = ctx.trainer, ctx.model
    st.batches = model.sample_batches(trainer.generator, ctx.cfg.batch_size)
    n_check = ctx.cell.traffic['check_steps']

    draw_salts = trainer.step_salts

    def recorded_salts():
        w = draw_salts()
        st.salts.append(w)
        return w

    patches = [patched(trainer, 'step_salts', recorded_salts)]
    if is_adv(ctx):
        loss_given, hard_negatives = model.loss_given, model.hard_negatives

        def recorded_loss(users, keep, ridx, w_rank, w_loss):
            st.inputs.append((users.cpu(), keep.cpu(), ridx.cpu()))
            return loss_given(users, keep, ridx, w_rank, w_loss)

        def recorded_negatives(*args):
            negs, valid = hard_negatives(*args)
            st.mined.append((negs.cpu(), valid.cpu()))
            return negs, valid

        patches += [patched(model, 'loss_given', recorded_loss),
                    patched(model, 'hard_negatives', recorded_negatives)]
    params = (model.user_emb, model.item_emb)
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        for k in range(n_check):
            st.feeds.append(tuple(t.cpu() for t in st.batches[st.pos]))
            step(ctx, st)
            st.losses.append(float(st.epoch_losses[-1]))
            if k == 0:
                opt = trainer.optimizer.state
                st.grad_norms = [norm(opt[p]['exp_avg']) / (1 - ADAM_BETA1)
                                 if p in opt else 0.0 for p in params]
    st.change_norms = [norm(p.detach() - t0.to(p.device))
                       for p, t0 in zip(params, ctx.tables0)]
    for _ in range(ctx.cell.traffic['warmup_steps']):
        step(ctx, st)
    ctx.sync()
    return st


def norm(x: torch.Tensor) -> float:
    """The 2-norm of ``x`` summed in float64: a float32 sum over millions
    of entries can be off by 1e-4 on the host."""
    return float(x.double().norm())


def step_work(ctx: Ctx) -> work.Work:
    s, f = ctx.shape(), ctx.settings
    if is_adv(ctx):
        m = ctx.model
        return work.adv_step(s, f['batch_size'], m.n_candidates,
                             m.pos_samples, m.n_hard_negs)
    return work.lgcn_step(s, f['batch_size'], f['neg_samples'])


def window(ctx: Ctx, st: State, seconds: float) -> dict:
    host = []
    ctx.sync()
    t0 = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - t0 < seconds:
        h0 = time.perf_counter()
        step(ctx, st)
        host.append(time.perf_counter() - h0)
        n += 1
    ctx.sync()
    window_s = time.perf_counter() - t0
    finish_epoch(st)
    return {'window_s': window_s, 'count': n, 'host_s': host,
            'work_s': n * step_work(ctx).least_s(),
            'failed': st.nan_epochs}


def traced(ctx: Ctx, st: State):
    """The first ``trace_steps`` steps of a new epoch under the profiler,
    the mining in its own range (``hard_negatives``, on the instance);
    returns the trace, the steps and the keep of their launches.  The
    epoch is sampled before the profiler starts, so every seed traces the
    same work, with no resampling in it (an epoch is over a thousand
    steps)."""
    from torch.profiler import profile, record_function
    model = ctx.model
    n = ctx.cell.traffic['trace_steps']
    new_epoch(ctx, st)
    if len(st.batches) < n:
        raise ValueError(f'an epoch of {len(st.batches)} steps holds no '
                         f'{n} traced steps')
    with contextlib.ExitStack() as stack:
        if is_adv(ctx):
            stack.enter_context(ranged(model, 'hard_negatives'))
        ctx.sync()
        with profile(activities=activities(ctx)) as prof:
            with window_range():
                for _ in range(n):
                    with record_function('step'):
                        step(ctx, st)
                ctx.sync()
    return Trace.collect(prof), n, ctx.shape().keep


def end_to_end(ctx: Ctx, st: State, win: dict, setup_s: float) -> dict:
    rate = win['count'] * ctx.settings['batch_size'] / win['window_s']
    return {'train_examples_per_s': {'value': rate, 'unit': 'examples/s'},
            'setup_s': {'value': setup_s, 'unit': 's'}}


def leaf_gap(prog: list[float], want: list[float]) -> float:
    """The worst table's gap between the program's norm and the
    reference's, over the reference's norm of that table or the median
    table's, whichever is larger."""
    med = float(np.median(want))
    return max(abs(p - r) / max(r, med, 1e-30) for p, r in zip(prog, want))


def check(ctx: Ctx, st: State) -> dict:
    """The check steps again in the plain reference, in float64, from the
    benchmark's tables, the recorded salts and draws; the numbers
    compared with their limits.  For ``adv_sampling`` the mined negatives
    are judged by themselves against the exact scores (``mining_gap``),
    and the loss then takes the program's: the selection is discrete, and
    a bfloat16 tie resolved otherwise at a rounding boundary would move
    the loss by one pair's term."""
    dev, f = ctx.device, ctx.settings
    inter = ctx.inter
    g = ref.RefGraph.build(inter.train_user, inter.train_item,
                           inter.n_users, inter.n_items, dev)
    out = {'id_map_bad': float(id_map_bad(ctx, g))}
    u0, i0 = (t.to(dev, torch.float64) for t in ctx.tables0)
    tables = [u0.clone().requires_grad_(), i0.clone().requires_grad_()]
    adam = ref.Adam(tables, f['lr'])
    losses, grad_norms, mining_gap, bad = [], None, 0.0, 0
    adv = bool(st.mined)
    for k, salts in enumerate(st.salts):
        if adv:
            users, keep, ridx = (t.to(dev) for t in st.inputs[k])
            fed = st.feeds[k][0].to(dev)
            if users.shape != fed.shape or not torch.equal(users, fed):
                # the step did not take the batch it was fed
                bad += len(fed)
                losses.append(math.inf)
                break
            w_rank, w_loss = salts
            negs, valid = (t.to(dev) for t in st.mined[k])
            with torch.no_grad():
                rank = ref.propagate(g, *tables, f['n_layers'], w_rank)
                scores = ref.mined_scores(g, rank, users, keep)
                mining_gap = max(mining_gap, mined_gap(scores, negs, valid))
                deg = g.degree[users]
                pos = g.pos_items[g.pos_ptr[users][:, None]
                                  + ridx % deg[:, None]]
            reprs = ref.propagate(g, *tables, f['n_layers'], w_loss)
            loss = ref.expanded_loss(reprs, tables, users, pos, negs, valid,
                                     f['reg_lambda'])
        else:
            users, pos, negs = (t.to(dev) for t in st.feeds[k])
            bad += int((~g.is_train(users, pos)).sum())
            bad += int(g.is_train(users, negs).sum())
            reprs = ref.propagate(g, *tables, f['n_layers'], salts)
            loss = ref.bpr_loss(reprs, tables, users, pos, negs,
                                f['reg_lambda'])
        grads = torch.autograd.grad(loss, tables)
        losses.append(float(loss.detach()))
        if k == 0:
            grad_norms = [float(x.norm()) for x in grads]
        adam.step(grads)
    if adv:
        bad += ref.draws_bad([x[1].to(dev) for x in st.inputs],
                             [x[2].to(dev) for x in st.inputs], g.n_items)
    out['sample_bad'] = float(bad)
    if bad:
        return {**out, 'loss_gap': math.inf, 'grad_gap': math.inf,
                'change_gap': math.inf, **({'mining_gap': math.inf}
                                           if adv else {})}
    change = [float((t.detach() - t0).norm())
              for t, t0 in zip(tables, (u0, i0))]
    out['loss_gap'] = max(abs(p - r) / abs(r)
                          for p, r in zip(st.losses, losses))
    out['grad_gap'] = leaf_gap(st.grad_norms, grad_norms)
    out['change_gap'] = leaf_gap(st.change_norms, change)
    if adv:
        out['mining_gap'] = mining_gap
    return out


def mined_gap(scores: torch.Tensor, prog: torch.Tensor,
              valid: torch.Tensor) -> float:
    """The widest gap, over users and places, between the reference's
    best candidates by the exact score and the program's negatives sorted
    by it, over the user's best score's magnitude: the program's choice
    may differ only within the bfloat16 rounding.  A negative that is a
    train item or no candidate scores -inf (an infinite gap), and so does
    a user whose negatives the program marks valid or invalid otherwise
    than the exact scores do."""
    want = torch.topk(scores, prog.shape[1], dim=1).values
    picked = scores.gather(1, prog)
    got = torch.sort(picked, dim=1, descending=True).values
    scale = want[:, :1].abs().clamp(min=1e-30)
    both = torch.isinf(want) & torch.isinf(got) & (want == got)
    gap = torch.where(both, 0.0, (want - got) / scale)
    if not torch.equal(valid, torch.isfinite(picked)):
        return math.inf
    return float(gap.max())
