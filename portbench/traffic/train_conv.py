"""The training window of a model with a learned graph conv (``gat``):
``train.py``'s closed loop over ``Trainer.epoch_step``, with the conv
layers' weights drawn by the benchmark and every leaf of the model
checked.

Set-up draws each conv layer's ``w``, ``a_src``, ``a_dst`` and ``b`` on
the device from a generator seeded by the run's seed (``w`` and the two
attention vectors glorot-uniform, as ``init_conv_layer`` draws them;
``b`` N(0, 0.01), not the program's zeros, so that its path is checked too,
and small beside the rows' spread, so that a row's logits keep both signs
and the softmax still sees ``a_dst``: at N(0, 0.1) the bias shifted every
logit of the last layer to one side of 0 on a small skewed draw, and that
layer's ``a_dst`` gradient vanished) and loads them beside the benchmark's
tables; the CPU copies stay in the state.  It
then drives the ``check_steps`` steps as ``train.setup`` does, recording
the salts, the batches fed and the losses, and for every leaf (the two
tables and ``w``, ``a_src``, ``a_dst``, ``b`` a layer) its first gradient
(Adam's first moment after one step over ``1 - beta1``) and its change
after those steps; then ``warmup_steps`` more steps.

The window, the traced sub-window and the end-to-end metrics are
``train.py``'s; the window's work is ``work_gat.step``'s count.  The check
replays the check steps in ``reference/gat.py`` in float64.

Set-up relabels the cell's traffic kind ``train`` for the rest of the run:
the per-layer readers of a training cell (``metrics/*.py``) read a cell of
that kind.  The control is looked up before, under this module's kind.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .. import faults, work_gat
from ..harness import Ctx, id_map_bad, log, patched
from ..reference import gat as ref
from . import train
from .train import end_to_end, leaf_gap, norm  # noqa: F401  the harness's

# the conv weights' stream: apart from the one that draws the tables
CONV_STREAM = 1 << 40
B_SCALE = 0.01


@dataclass
class State(train.State):
    convs0: list = field(default_factory=list)  # each layer's leaves, CPU


def draw_convs(seed: int, n_layers: int, d: int, device) -> list[dict]:
    """Each layer's ``{w, a_src, a_dst, b}`` on ``device`` from the run's
    seed."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + CONV_STREAM)

    def glorot(*shape):
        bound = math.sqrt(6.0 / (shape[0] + shape[-1]))
        u = torch.rand(shape, generator=gen, device=device)
        return (2.0 * u - 1.0) * bound

    return [{'w': glorot(d, d), 'a_src': glorot(d, 1)[:, 0],
             'a_dst': glorot(d, 1)[:, 0],
             'b': B_SCALE * torch.randn(d, generator=gen, device=device)}
            for _ in range(n_layers)]


def leaves(model) -> list[torch.Tensor]:
    """The model's leaves in the reference's order: the user and item
    tables, then ``ref.LEAVES`` of each layer."""
    return [model.user_emb, model.item_emb] + [
        lp[k] for lp in model.convs for k in ref.LEAVES]


def setup(ctx: Ctx) -> State:
    ctx.cell.traffic['kind'] = 'train'
    st = State()
    trainer, model = ctx.trainer, ctx.model
    convs = draw_convs(ctx.seed, len(model.convs), ctx.settings['emb_size'],
                       ctx.device)
    model.load_params({**model.param_tree(), 'convs': convs})
    st.convs0 = [{k: v.cpu() for k, v in lp.items()} for lp in convs]
    st.batches = model.sample_batches(trainer.generator, ctx.cfg.batch_size)
    draw_salts = trainer.step_salts

    def recorded_salts():
        w = draw_salts()
        st.salts.append(w)
        return w

    params = leaves(model)
    start = [p.detach().clone() for p in params]
    with patched(trainer, 'step_salts', recorded_salts):
        for k in range(ctx.cell.traffic['check_steps']):
            st.feeds.append(tuple(t.cpu() for t in st.batches[st.pos]))
            train.step(ctx, st)
            st.losses.append(float(st.epoch_losses[-1]))
            if k == 0:
                opt = trainer.optimizer.state
                st.grad_norms = [norm(opt[p]['exp_avg'])
                                 / (1 - train.ADAM_BETA1)
                                 if p in opt else 0.0 for p in params]
    st.change_norms = [norm(p.detach() - p0) for p, p0 in zip(params, start)]
    for _ in range(ctx.cell.traffic['warmup_steps']):
        train.step(ctx, st)
    ctx.sync()
    return st


def window(ctx: Ctx, st: State, seconds: float) -> dict:
    """``train.window``, its work counted by ``work_gat.step``."""
    win = train.window(ctx, st, seconds)
    f = ctx.settings
    win['work_s'] = win['count'] * work_gat.step(
        ctx.shape(), f['batch_size'], f['neg_samples']).least_s()
    return win


def launches() -> dict[str, int]:
    """K3's and K4's launch counters, and those of their launches over a
    CSR with a row longer than K1's split length (a program without that
    counter reads -1)."""
    from textgcn_tpu_torch.ops import gat
    return {f'{name}.{key}': getattr(fn, key, -1)
            for name, fn in (('k3', gat.gat_fwd_cuda),
                             ('k4', gat.gat_bwd_cuda))
            for key in ('launches', 'long_row_launches')}


def traced(ctx: Ctx, st: State):
    """``train.traced``; logs the program's launch counts over the traced
    steps beside the kernels the trace holds."""
    before = launches()
    tr, n, keep = train.traced(ctx, st)
    counted = {k: v - before[k] if v >= 0 else v
               for k, v in launches().items()}
    log(f'traced {n} steps: program counts {counted}; trace K3 '
        f'{tr.count(work_gat.K3_KERNEL)}, K4 {tr.count(work_gat.K4_KERNEL)}')
    return tr, n, keep


def check(ctx: Ctx, st: State) -> dict:
    """The check steps again in ``reference/gat.py``, in float64, from the
    benchmark's tables and conv weights, the recorded salts and batches:
    the loss of each step, the first gradient and the change of every leaf
    against the program's, as ``train.check`` holds ``lgcn``'s."""
    dev, f = ctx.device, ctx.settings
    inter = ctx.inter
    g = ref.RefGraph.build(inter.train_user, inter.train_item,
                           inter.n_users, inter.n_items, dev)
    out = {'id_map_bad': float(id_map_bad(ctx, g))}

    def leaf(t):
        return t.to(dev, torch.float64).clone().requires_grad_()
    tables = [leaf(t) for t in ctx.tables0]
    convs = [{k: leaf(lp[k]) for k in ref.LEAVES} for lp in st.convs0]
    params = tables + [lp[k] for lp in convs for k in ref.LEAVES]
    start = [p.detach().clone() for p in params]
    adam = ref.Adam(params, f['lr'])
    losses, grad_norms, bad = [], None, 0
    for k, salts in enumerate(st.salts):
        users, pos, negs = (t.to(dev) for t in st.feeds[k])
        bad += int((~g.is_train(users, pos)).sum())
        bad += int(g.is_train(users, negs).sum())
        loss = ref.loss(g, tables, convs, salts, users, pos, negs,
                        f['reg_lambda'])
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if k == 0:
            grad_norms = [float(x.norm()) for x in grads]
        adam.step(grads)
    out['sample_bad'] = float(bad)
    if bad:
        return {**out, 'loss_gap': math.inf, 'grad_gap': math.inf,
                'change_gap': math.inf}
    change = [float((p.detach() - p0).norm()) for p, p0 in zip(params, start)]
    out['loss_gap'] = max(abs(p - r) / abs(r)
                          for p, r in zip(st.losses, losses))
    out['grad_gap'] = leaf_gap(st.grad_norms, grad_norms)
    out['change_gap'] = leaf_gap(st.change_norms, change)
    return out


def plant_fault(ctx: Ctx, fault: str, plant=faults.plant):
    """``faults.plant`` of a training cell's ``fault`` in this cell's
    program (its trainer and ``model.loss`` are ``train.py``'s), the cell
    relabelled as set-up relabels it."""
    ctx.cell.traffic['kind'] = 'train'
    plant(ctx, fault)
