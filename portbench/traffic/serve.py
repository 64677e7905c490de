"""The serving window: one client, a closed loop of ``Trainer
._predict_users`` requests (the path ``evaluate`` and ``predict`` share:
one propagation, then the masked top-max(k) of each batch of up to
``batch_size`` users).

The requests are the same for every seed, in another order:
``pool_requests`` cohorts drawn once from ``users_seed``, their sizes
from a fixed log-uniform grid over ``cohort_min``..``cohort_max``
(``cohort_grid`` sizes, each block of that many requests a permutation
of the grid), their users without repeats in proportion to their train
degree (Efraimidis-Spirakis keys).  The run's seed orders the blocks,
the requests within each block and the users within each request; the
pool is sent in turn, and again from the start if the window outlasts
it.  Each request is timed
from the call to its numpy results.  Of each answer the rows of
``kept_rows`` users drawn from the seed are kept; after the window a
sample of ``check_requests`` answered requests drawn from the seed, the
largest cohort among them, is held against the reference.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import work
from ..harness import (Ctx, activities, control, id_map_bad, ranged,
                       window_range)
from ..reference import lightgcn as ref
from ..tracing import Trace


@dataclass
class Request:
    users: np.ndarray        # program rows (int64)
    keep: np.ndarray         # positions in ``users`` whose rows are kept


@dataclass
class State:
    gen_s: float = 0.0
    pool: list = field(default_factory=list)
    next: int = 0
    answers: list = field(default_factory=list)    # (request, idx, vals)


def cohort_grid(t: dict) -> np.ndarray:
    g = t['cohort_grid']
    q = (np.arange(g) + 0.5) / g
    lo, hi = t['cohort_min'], t['cohort_max']
    return np.round(lo * (hi / lo) ** q).astype(np.int64)


def make_pool(t: dict, train_user: np.ndarray, n_users_generated: int,
              seed: int) -> list[Request]:
    """The seed's requests (see the module docstring)."""
    fixed = np.random.default_rng([int(t['users_seed']), 0x5E7E])
    rng = np.random.default_rng([int(seed), 0x5E7E])
    users = np.unique(train_user)          # the program's rows, in order
    row_of = np.full(n_users_generated, -1, np.int64)
    row_of[users] = np.arange(len(users))
    weight = np.bincount(row_of[train_user], minlength=len(users))
    grid = cohort_grid(t)
    blocks = -(-t['pool_requests'] // len(grid))
    sizes = np.concatenate([fixed.permutation(grid) for _ in range(blocks)])
    sizes = np.minimum(sizes[:t['pool_requests']], len(users))
    cohorts = []
    for n in sizes.tolist():
        keys = np.log(fixed.random(len(users))) / np.maximum(weight, 1)
        keys[weight == 0] = -np.inf
        cohorts.append(np.argpartition(-keys, n - 1)[:n].astype(np.int64))
    order = np.concatenate([b * len(grid) + rng.permutation(len(grid))
                            for b in rng.permutation(blocks)])
    pool = []
    for i in order[order < len(cohorts)].tolist():
        chosen = rng.permutation(cohorts[i])
        n = len(chosen)
        keep = rng.choice(n, min(n, t['kept_rows']), replace=False)
        pool.append(Request(chosen, np.sort(keep)))
    return pool


def setup(ctx: Ctx) -> State:
    st = State()
    t = ctx.cell.traffic
    t0 = time.perf_counter()
    st.pool = make_pool(t, ctx.inter.train_user, ctx.inter.n_users,
                        ctx.seed)
    st.gen_s = time.perf_counter() - t0
    by_size = sorted(range(len(st.pool)), key=lambda i: len(st.pool[i].users))
    warm = [by_size[-1], by_size[0], *by_size[::max(1, len(by_size)
                                                     // t['warmup_requests'])]]
    for i in warm[:t['warmup_requests']]:
        ctx.trainer._predict_users(st.pool[i].users)
    ctx.sync()
    return st


def answer(ctx: Ctx, st: State) -> tuple[Request, float, int]:
    """Send the next request; keep its sampled rows; its latency and
    whether its answer was malformed."""
    req = st.pool[st.next % len(st.pool)]
    st.next += 1
    t0 = time.perf_counter()
    idx, vals = ctx.trainer._predict_users(req.users)
    lat = time.perf_counter() - t0
    k = max(ctx.settings['k'])
    bad = int(idx.shape != (len(req.users), k) or vals.shape != idx.shape)
    if not bad:
        st.answers.append((req, idx[req.keep], vals[req.keep]))
    return req, lat, bad


def window(ctx: Ctx, st: State, seconds: float) -> dict:
    if ctx.mode == 'control':
        return control_window(ctx, st)
    s, f = ctx.shape(), ctx.settings
    lat, users, failed, least = [], 0, 0, 0.0
    ctx.sync()
    t0 = time.perf_counter()
    while not lat or time.perf_counter() - t0 < seconds:
        req, dt, bad = answer(ctx, st)
        lat.append(dt)
        failed += bad
        users += 0 if bad else len(req.users)
        least += work.serve_request(len(req.users), s, f['batch_size'],
                                    max(f['k'])).least_s()
    window_s = time.perf_counter() - t0
    return {'window_s': window_s, 'count': len(lat), 'host_s': lat,
            'users': users, 'work_s': least, 'failed': failed}


def traced(ctx: Ctx, st: State):
    """The pool's first block of requests (every size of the grid once)
    under the profiler, with the propagation (``scoring_reprs``) and the
    retrieval (``topk_for_users``) in ranges of their names on the
    instance."""
    from torch.profiler import profile, record_function
    n = ctx.cell.traffic['cohort_grid']
    st.next = 0
    with contextlib.ExitStack() as stack:
        stack.enter_context(ranged(ctx.model, 'scoring_reprs'))
        stack.enter_context(ranged(ctx.model, 'topk_for_users'))
        ctx.sync()
        with profile(activities=activities(ctx)) as prof:
            with window_range():
                for _ in range(n):
                    with record_function('request'):
                        answer(ctx, st)
                ctx.sync()
    return Trace.collect(prof), n, 1.0


def end_to_end(ctx: Ctx, st: State, win: dict, setup_s: float) -> dict:
    return {'serve_users_per_s': {'value': win['users'] / win['window_s'],
                                  'unit': 'users/s'},
            'serve_p95_ms': {'value': float(np.percentile(win['host_s'], 95))
                             * 1e3, 'unit': 'ms'},
            'setup_s': {'value': setup_s, 'unit': 's'}}


def sample(ctx: Ctx, st: State) -> list:
    """The answered requests held against the reference: a draw from the
    seed, and the largest cohort among those answered."""
    n = min(len(st.answers), ctx.cell.traffic['check_requests'])
    rng = np.random.default_rng([int(ctx.seed), 0xC4EC])
    picked = set(rng.choice(len(st.answers), n, replace=False).tolist())
    picked.add(max(range(len(st.answers)),
                   key=lambda i: len(st.answers[i][0].users)))
    return [st.answers[i] for i in sorted(picked)]


def reference_top(ctx: Ctx, g: ref.RefGraph, reprs, users: torch.Tensor,
                  k: int):
    """``(scores, top)``: the users' exact masked scores against the
    catalogue and their ``k`` best values."""
    ur, ir = reprs
    scores = g.masked(ur[users] @ ir.T, users)
    return scores, torch.topk(scores, k, dim=1).values


def check(ctx: Ctx, st: State) -> dict:
    """Each sampled answer against the float64 reference: the widest gap
    by which a served item's exact score lies below the reference's at
    its place (``rank_gap``), the widest gap between a served score and
    the item's exact one (``value_gap``), both over the user's best
    score's magnitude; malformed rows (``answer_bad``: a repeated or
    unknown item, and in serving mode ties not in index order)."""
    dev, f = ctx.device, ctx.settings
    inter = ctx.inter
    g = ref.RefGraph.build(inter.train_user, inter.train_item,
                           inter.n_users, inter.n_items, dev)
    u0, i0 = (t.to(dev, torch.float64) for t in ctx.tables0)
    with torch.no_grad():
        reprs = ref.propagate(g, u0, i0, f['n_layers'])
    k = max(f['k'])
    approx = bool(f['approx_topk'])
    rank_gap = value_gap = 0.0
    bad = 0
    for req, idx, vals in sample(ctx, st):
        users = torch.from_numpy(req.users[req.keep]).to(dev)
        idx = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
        vals = torch.from_numpy(np.asarray(vals, np.float64)).to(dev)
        unknown = (idx < 0) | (idx >= g.n_items)
        bad += int(unknown.any(dim=1).sum())
        idx = idx.clamp(0, g.n_items - 1)
        srt = torch.sort(idx, dim=1).values
        bad += int((srt[:, 1:] == srt[:, :-1]).any(dim=1).sum())
        if approx:
            tied = vals[:, 1:] == vals[:, :-1]
            bad += int((tied & (idx[:, 1:] <= idx[:, :-1])).any(dim=1).sum())
        with torch.no_grad():
            scores, top = reference_top(ctx, g, reprs, users, k)
        got = scores.gather(1, idx)
        scale = top[:, :1].abs().clamp(min=1e-30)
        rank_gap = max(rank_gap, float(((top - got) / scale).max()))
        value_gap = max(value_gap, float(((vals - got).abs() / scale).max()))
    return {'id_map_bad': float(id_map_bad(ctx, g)), 'rank_gap': rank_gap,
            'value_gap': value_gap, 'answer_bad': float(bad)}


def control_window(ctx: Ctx, st: State) -> dict:
    """The control in the program's place: the reference in float32 with
    the catalogue scores in the precision the configuration's control
    names (``reference_scores``: ``tf32``, the product in TF32, or
    ``fp8``, the scores rounded to float8 e4m3 a row), answering the
    first ``check_requests`` requests; no timing."""
    dev, f = ctx.device, ctx.settings
    inter = ctx.inter
    g = ref.RefGraph.build(inter.train_user, inter.train_item,
                           inter.n_users, inter.n_items, dev)
    k = max(f['k'])
    lower = control(ctx.cell)['reference_scores']
    if lower not in ('tf32', 'fp8'):
        raise ValueError(f'reference_scores {lower!r}: tf32 or fp8')
    t0 = time.perf_counter()
    with torch.no_grad():
        ur, ir = ref.propagate(g, *(t.to(dev) for t in ctx.tables0),
                               f['n_layers'])
        for req in st.pool[:ctx.cell.traffic['check_requests']]:
            users = torch.from_numpy(req.users[req.keep]).to(dev)
            if lower == 'fp8':
                scores = ref.fp8_rowwise(ur[users] @ ir.T)
            else:
                scores = ref.tf32(ur[users]) @ ref.tf32(ir).T
            scores = g.masked(scores, users)
            top = ref.lower_index_top(scores, k)
            st.answers.append((req, top.cpu().numpy(),
                               scores.gather(1, top).cpu().numpy()))
    n = len(st.answers)
    return {'window_s': time.perf_counter() - t0, 'count': n,
            'host_s': [0.0] * n, 'users': n, 'work_s': 0.0, 'failed': 0}
