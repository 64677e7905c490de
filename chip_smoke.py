#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``textgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (in parallel):
   ``spmm_dropout.cu`` (K1), ``gat_fwd.cu`` (K3), ``gat_bwd.cu`` (K4);
3. kernel: holds K1 (``spmm_dropout``) against its plain torch version on
   the S1 graph, both directions, keep 1.0 and 0.6 with a salt whose high
   bit is set, within atol = rtol = 1e-5 (the summation order is the only
   difference; one flipped mask bit is ~0.1), and times the kernel, the
   plain version and ``torch.sparse.mm`` (a yardstick the port never
   calls) with CUDA events;
4. gat kernel: holds K3 against ``gat_att_plain`` (atol = rtol = 1e-5) and
   K4 against ``gat_bwd_plain`` (atol = rtol = 1e-4: K4 sums dd with
   float atomics in a changing order, and its sums run over up to ~100
   terms of magnitude ~10 here) on the S1 graph, both directions, keep 1.0
   and 0.6, with unit-scale random inputs, and times kernel and plain;
5. small: serves ``data/dummy`` through the CLI on the card and on the
   CPU (the plain path the CPU tests tie to the JAX package): the metrics
   agree within 1e-6 and the predictions up to ties;
6. serve: S1 (60,000 users x 25,000 items, ~600k edges, d = 64, 3 layers)
   served through ``textgcn_tpu_torch.cli.main`` from a JAX-format pickle
   (tables padded to 4096 rows): K1 launches exactly 12 times (eval and
   predict, 3 layers x 2 directions each), ``predictions.tsv`` has one row
   per user, the metrics are finite, and the served top-40 of 256 users
   equals the top-40 of a plain-SpMM propagation on the card up to ties;
7. train lgcn: S1 trained through ``cli.main`` for 2 epochs (batch 2048,
   dropout 0.4, eval every epoch): K1 launches exactly ``steps x 12 + 2
   evals x 6`` (6 forward and 6 backward a step), the loss sums are
   finite and fall, ``best.pkl`` serves through the CLI with the metrics
   of its epoch, and one step with the kernels agrees with one step with
   the plain versions on the card (same params, batch and salts: loss and
   gradients within atol = rtol = 1e-4, the f32 reordering of ~600k-term
   sums through 3 layers forward and back);
8. train gat: the same for ``--model gat --aggr mean``: K3 launches
   ``steps x 6 + 6`` per eval, K4 ``steps x 6``;
9. timing: ms per training step and examples/s of each model at S1, split
   into sampling, forward, backward and Adam (host clock around
   synchronised work), the host's enqueue share of an unsynchronised run
   of steps, and the device's busy time per step from a ``torch.profiler``
   trace of 10 more.

The line before the last is ``{"kernels": [...]}`` with each ported
kernel's launches on the main paths, error, times and bound; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import csv
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# S1: the JAX package's bench shape (bench.py, tools/scale_bench.py)
S1_USERS, S1_ITEMS, S1_DEG = 60_000, 25_000, 10
D, LAYERS, BATCH, KS = 64, 3, 2048, (20, 40)
HOLDOUT = 0.1
SALT = 0x9E3779B9            # high bit set: exercises the uint32 hash path
KEEP_DROPOUT = float(np.float32(1.0 - 0.4))   # float32(1 - p), p = 0.4
TOL = 1e-5
GAT_BWD_TOL = 1e-4
STEP_TOL = 1e-4
TRAIN_EPOCHS = 2
N_CHECK_USERS = 256
TIMED_LAUNCHES = 20
SPIN_CYCLES = 200_000_000    # ~0.1 s at the H100's 1.98 GHz SM clock
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def log(msg: str):
    print(msg, flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise SystemExit(f'chip_smoke FAILED: {msg}')


def synth_edges(n_users, n_items, avg_deg, seed=0):
    """Unique random (user, item) pairs with 1/sqrt(deg_u deg_i) weights:
    the generator of ``tools/scale_bench.py`` (``synth_edges``)."""
    rng = np.random.RandomState(seed)
    n_edges = n_users * avg_deg
    eu = rng.randint(0, n_users, n_edges).astype(np.int32)
    ei = rng.randint(0, n_items, n_edges).astype(np.int32)
    pairs = np.unique(np.stack([eu, ei], 1), axis=0)
    eu, ei = pairs[:, 0], pairs[:, 1]
    du = np.bincount(eu, minlength=n_users)
    di = np.bincount(ei, minlength=n_items)
    with np.errstate(divide='ignore'):
        w = 1.0 / np.sqrt(du[eu].astype(np.float64) * di[ei])
    w[~np.isfinite(w)] = 0
    return eu, ei, w.astype(np.float32)


def write_dataset(root: str, n_users: int, n_items: int, avg_deg: int,
                  seed: int = 0) -> str:
    """S1 interactions as ``train.tsv``/``test.tsv`` under ``root/s1``.

    Every user keeps at least one train edge (a user without any edge
    gets one random item); about ``HOLDOUT`` of each user's other edges
    go to the test file, and only items that keep a train edge.
    """
    rng = np.random.RandomState(seed)
    eu, ei, _ = synth_edges(n_users, n_items, avg_deg, seed)
    missing = np.setdiff1d(np.arange(n_users), eu)
    if missing.size:
        extra = rng.randint(0, n_items, missing.size)
        pairs = np.unique(np.concatenate(
            [np.stack([eu, ei], 1), np.stack([missing, extra], 1)]), axis=0)
        eu, ei = pairs[:, 0], pairs[:, 1]
    first = np.r_[True, eu[1:] != eu[:-1]]      # pairs are sorted by user
    test = (rng.rand(len(eu)) < HOLDOUT) & ~first
    has_train = np.zeros(n_items, bool)
    has_train[ei[~test]] = True
    test &= has_train[ei]
    out = os.path.join(root, 's1')
    os.makedirs(out, exist_ok=True)
    for name, sel in (('train.tsv', ~test), ('test.tsv', test)):
        lines = [f'u{u}\ti{i}' for u, i in zip(eu[sel].tolist(),
                                               ei[sel].tolist())]
        with open(os.path.join(out, name), 'w') as f:
            f.write('user_id\tasin\n' + '\n'.join(lines) + '\n')
    return out


def write_jax_checkpoint(path: str, n_users: int, n_items: int, d: int,
                         seed: int = 0):
    """A pickle in the JAX package's format: N(0, 0.1) tables padded to a
    multiple of 4096 rows, as its Pallas backend writes them."""
    rng = np.random.RandomState(seed)
    pad = lambda n: -(-n // 4096) * 4096  # noqa: E731
    params = {
        'user_emb': (0.1 * rng.randn(pad(n_users), d)).astype(np.float32),
        'item_emb': (0.1 * rng.randn(pad(n_items), d)).astype(np.float32),
    }
    with open(path, 'wb') as f:
        pickle.dump({'params': params, 'epoch': 0, 'model': 'lgcn'}, f)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ['nvidia-smi', f'--query-gpu={fields}', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_name_and_power() -> str:
    return nvidia_smi('name,power.limit')


def time_ms(fns: dict, order: list[str], strict=('kernel',),
            reps: int = TIMED_LAUNCHES, warmup: int = 25) -> dict[str, float]:
    """Median device ms of single launches, timed with CUDA events, the
    variants run in turns (``order``, e.g. plain, kernel, kernel, plain).

    Each round starts with ``warmup`` untimed launches (clocks up, the
    round's working set back in L2).  Then a spin kernel holds the stream
    while the host enqueues the whole round, so every event pair brackets
    the launch's device time and not the host's launch overhead; the
    round of ``strict`` variants fails if the host took longer than the
    spin; for the others (a library call may synchronise) it is logged.
    """
    samples = {name: [] for name in fns}
    for name in order:
        fn = fns[name]
        for _ in range(warmup):
            fn()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps + 1)]
        torch.cuda.synchronize()
        spin_start, spin_end = events.pop()
        spin_start.record()
        torch.cuda._sleep(SPIN_CYCLES)
        spin_end.record()
        t0 = time.perf_counter()
        for start, end in events:
            start.record()
            fn()
            end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spin_start.elapsed_time(spin_end)
        log(f'timing {name}: host enqueue {host_ms / reps * 1e3:.1f} us per '
            f'launch')
        if host_ms >= spin_ms:
            msg = (f'timing {name}: enqueueing {reps} launches took '
                   f'{host_ms:.1f} ms, longer than the {spin_ms:.1f} ms spin')
            check(name not in strict, msg)
            log(msg + ': its time includes host overhead')
        samples[name] += [s.elapsed_time(e) for s, e in events]
    return {name: float(np.median(v)) for name, v in samples.items()}


def bound_ms(csr, d: int) -> tuple[float, str]:
    """Least time for one direction on the card: every input read once
    (x table, CSR), the output written once, and 2*E*d f32 operations,
    against the published peaks."""
    nbytes = 4 * (csr.n_src * d + csr.rowptr.numel() + csr.col.numel()
                  + csr.w.numel() + csr.n_dst * d)
    ops = 2 * csr.n_edges * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def kernel_phase(data, dev) -> dict:
    """K1 against spmm_plain on the S1 graph, then its times."""
    from textgcn_tpu_torch.ops.spmm import (GraphOp, spmm_dropout_cuda,
                                            spmm_plain)
    g = data.graph
    op = GraphOp(g.edge_user, g.edge_item, g.edge_weight, data.n_users,
                 data.n_items, dev)
    gen = torch.Generator().manual_seed(1)
    tables = {'to_user': torch.randn(data.n_items, D, generator=gen),
              'to_item': torch.randn(data.n_users, D, generator=gen)}
    max_err = 0.0
    result = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0, 'bound_ms': 0.0,
              'ms_keep_0_6': 0.0}
    bytes_bound = True
    for direction, csr in (('to_user', op.l_i2u), ('to_item', op.l_u2i)):
        x = tables[direction].to(dev)
        for keep in (1.0, KEEP_DROPOUT):
            got = spmm_dropout_cuda(csr, x, SALT, keep)
            want = spmm_plain(csr, x, SALT, keep)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            log(f'kernel {direction} keep={keep:.7g}: max_abs_err={err:.3e}')
            check(torch.allclose(got, want, atol=TOL, rtol=TOL),
                  f'K1 {direction} keep={keep} disagrees with spmm_plain '
                  f'(max abs err {err:.3e})')
        with warnings.catch_warnings():   # "sparse CSR is in beta"
            warnings.simplefilter('ignore', UserWarning)
            lib = torch.sparse_csr_tensor(csr.rowptr, csr.col, csr.w,
                                          size=(csr.n_dst, csr.n_src))
        t = time_ms({'plain': lambda: spmm_plain(csr, x, 0, 1.0),
                     'kernel': lambda: spmm_dropout_cuda(csr, x, 0, 1.0),
                     'library': lambda: torch.sparse.mm(lib, x)},
                    ['plain', 'kernel', 'library', 'library', 'kernel',
                     'plain'])
        t_drop = time_ms({'kernel': lambda: spmm_dropout_cuda(
            csr, x, SALT, KEEP_DROPOUT)}, ['kernel', 'kernel'])
        b, by = bound_ms(csr, D)
        bytes_bound &= by == 'bytes'
        log(f'timing {direction} (E={csr.n_edges}, {csr.n_dst}x{csr.n_src}, '
            f'd={D}): kernel {t["kernel"]:.4f} ms, kernel keep=0.6 '
            f'{t_drop["kernel"]:.4f} ms, plain {t["plain"]:.4f} ms, '
            f'torch.sparse.mm {t["library"]:.4f} ms, bound {b:.4f} ms '
            f'({by})')
        result['ms'] += t['kernel']
        result['ms_keep_0_6'] += t_drop['kernel']
        result['plain_ms'] += t['plain']
        result['library_ms'] += t['library']
        result['bound_ms'] += b
    log('clocks after timing (sm, max sm, power, temperature): '
        + nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu'))
    result['max_abs_err'] = max_err
    result['bound_by'] = 'bytes' if bytes_bound else 'operations'
    return result


def cli_run(data_dir: str, argv: list[str], platform: str):
    """``cli.main(argv)`` from inside ``data_dir``'s parent, as a user runs
    it; returns the trainer and the run directory."""
    from textgcn_tpu_torch import cli
    old_cwd, old_env = os.getcwd(), os.environ.get('TEXTGCN_TPU_PLATFORM')
    os.chdir(os.path.dirname(data_dir))
    os.environ['TEXTGCN_TPU_PLATFORM'] = platform
    try:
        trainer = cli.main(['--data', data_dir, *argv])
        if platform == 'cuda':
            torch.cuda.synchronize()
        return trainer, os.path.join(os.getcwd(), trainer.cfg.save_path)
    finally:
        os.chdir(old_cwd)
        if old_env is None:
            os.environ.pop('TEXTGCN_TPU_PLATFORM', None)
        else:
            os.environ['TEXTGCN_TPU_PLATFORM'] = old_env


def serve(data_dir: str, uid: str, argv_extra: list[str], platform: str,
          model: tuple[str, ...] = ('--model', 'lgcn')):
    return cli_run(data_dir, [*model, '--no_train', '--uid', uid, '--quiet',
                              *argv_extra], platform)


def read_predictions(path: str):
    with open(path, newline='') as f:
        rows = list(csv.reader(f, delimiter='\t'))
    check(rows[0] == ['user_id', 'y_pred', 'scores'],
          f'predictions.tsv header {rows[0]}')
    # scores may hold -inf (masked items), which literal_eval refuses
    return [(r[0], ast.literal_eval(r[1]),
             [float(s) for s in r[2][1:-1].split(',') if s.strip()])
            for r in rows[1:]]


def same_up_to_ties(vals_a, items_a, vals_b, items_b, tol) -> bool:
    """Equal top-k lists up to the order of tied values: the values agree
    within ``tol`` position by position, and so does each item whose
    value is finite and apart from every other value of its row."""
    va, vb = np.asarray(vals_a, np.float64), np.asarray(vals_b, np.float64)
    if va.shape != vb.shape:
        return False
    both_inf = np.isinf(va) & np.isinf(vb) & (np.sign(va) == np.sign(vb))
    with np.errstate(invalid='ignore'):
        close = np.abs(va - vb) <= tol
    if not (both_inf | close).all():
        return False
    for row in range(va.shape[0]):
        v = va[row]
        for j in range(len(v)):
            apart = np.isfinite(v[j]) and (
                np.abs(np.delete(v, j) - v[j]) > 2 * tol).all()
            if apart and items_a[row][j] != items_b[row][j]:
                return False
    return True


def small_phase(root: str):
    """data/dummy served on the card and on the CPU: same metrics and
    predictions."""
    import shutil
    dummy = os.path.join(root, 'dummy')
    shutil.copytree(os.path.join(REPO, 'data', 'dummy'), dummy)
    ck = os.path.join(root, 'dummy_ck.pkl')
    from textgcn_tpu_torch.data.core import load_interactions
    data = load_interactions(dummy)
    write_jax_checkpoint(ck, data.n_users, data.n_items, 16, seed=3)
    argv = ['--load', ck, '--predict', '--emb_size', '16', '--batch_size',
            '16', '-k', '3', '5']
    runs = {}
    for platform in ('cuda', 'cpu'):
        trainer, run_dir = serve(dummy, f'small-{platform}', argv, platform)
        runs[platform] = (trainer.last_metrics, read_predictions(
            os.path.join(run_dir, 'predictions.tsv')))
    (m_gpu, p_gpu), (m_cpu, p_cpu) = runs['cuda'], runs['cpu']
    for name in m_cpu:
        check(np.allclose(m_gpu[name], m_cpu[name], atol=1e-6, rtol=0),
              f'dummy {name}: card {m_gpu[name]} vs CPU {m_cpu[name]}')
    check([r[0] for r in p_gpu] == [r[0] for r in p_cpu], 'dummy users')
    check(same_up_to_ties([r[2] for r in p_gpu], [r[1] for r in p_gpu],
                          [r[2] for r in p_cpu], [r[1] for r in p_cpu],
                          2e-4), 'dummy predictions differ beyond ties')
    log(f'small: dummy metrics card == CPU: {m_gpu}')


class PlainGraphOp:
    """A GraphOp whose two directions run ``spmm_plain``, the reference
    for the served top-k."""

    def __init__(self, op):
        self.op = op

    def weights(self, generator=None, dropout=0.0):
        return self.op.weights(generator, dropout)

    def to_user(self, item_emb, w_pair):
        from textgcn_tpu_torch.ops.spmm import spmm_plain
        return spmm_plain(self.op.l_i2u, item_emb, *w_pair)

    def to_item(self, user_emb, w_pair):
        from textgcn_tpu_torch.ops.spmm import spmm_plain
        return spmm_plain(self.op.l_u2i, user_emb, *w_pair)


def serve_phase(data_dir: str, ck: str) -> int:
    """S1 through the CLI; returns K1's launches in that run."""
    from textgcn_tpu_torch.ops.propagate import representation
    from textgcn_tpu_torch.ops.retrieval import mask_train_items
    from textgcn_tpu_torch.ops.spmm import spmm_dropout_cuda
    argv = ['--load', ck, '--predict', '--emb_size', str(D), '--n_layers',
            str(LAYERS), '--batch_size', str(BATCH),
            '-k', *map(str, KS)]
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = serve(data_dir, 'smoke', argv, 'cuda')
    seconds = time.perf_counter() - t0
    launches = spmm_dropout_cuda.launches
    check(counts()['gat_fwd'] == counts()['gat_bwd'] == 0,
          f'serving lgcn launched GAT kernels: {counts()}')
    log(f'serve: cli.main took {seconds:.3f} s; K1 launches {launches}')
    data, model = trainer.data, trainer.model
    check(launches == 2 * LAYERS * 2,
          f'K1 launched {launches} times, expected {2 * LAYERS * 2} '
          '(eval + predict, 3 layers x 2 directions)')
    metrics = trainer.last_metrics
    check(metrics is not None and all(np.isfinite(v).all()
                                      for v in metrics.values()),
          f'metrics not finite: {metrics}')
    log(f'serve: metrics {json.dumps(metrics)}')
    preds = read_predictions(os.path.join(run_dir, 'predictions.tsv'))
    check(len(preds) == S1_USERS == data.n_users,
          f'{len(preds)} prediction rows for {data.n_users} users')
    check(all(len(p[1]) == max(KS) for p in preds), 'top-k width')

    # the served top-40 against a plain-SpMM propagation on the card
    item_index = {ext: i for i, ext in data.item_id_map.items()}
    users = torch.arange(N_CHECK_USERS, device=model.device)
    with torch.no_grad():
        ur, ir = representation(model.user_emb, model.item_emb,
                                PlainGraphOp(model.graph_op), LAYERS,
                                single=False)
        scores = mask_train_items(ur[users] @ ir.T,
                                  model.pos_padded[users], data.n_items)
        plain_vals, plain_idx = torch.topk(scores, max(KS), dim=1)
        served = torch.tensor(
            [[item_index[e] for e in preds[u][1]]
             for u in range(N_CHECK_USERS)], device=model.device)
        served_vals = scores.gather(1, served)
    check([p[0] for p in preds[:N_CHECK_USERS]]
          == [data.user_id_map[u] for u in range(N_CHECK_USERS)],
          'prediction rows are not in user order')
    same = same_up_to_ties(served_vals.cpu().numpy(), served.tolist(),
                           plain_vals.cpu().numpy(), plain_idx.tolist(), TOL)
    exact = float((served == plain_idx).float().mean())
    log(f'serve: top-{max(KS)} of {N_CHECK_USERS} users vs plain '
        f'propagation: same up to ties={same}, identical positions '
        f'{exact:.4f}')
    check(same, 'served top-k differs from the plain propagation')
    serve_breakdown(trainer)
    return launches


def serve_breakdown(trainer):
    """Where the serving time goes, piece by piece, after the counted run:
    host clock around work that ends in ``torch.cuda.synchronize()``."""
    from textgcn_tpu_torch.ops.metrics import calculate_metrics
    model, data = trainer.model, trainer.data

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    users = torch.as_tensor(data.test_users.astype(np.int64),
                            device=model.device)
    with torch.no_grad():
        reprs, t_prop = timed(model.representation)

        def topk():
            return torch.cat([
                model.topk_for_users(reprs, users[s:s + BATCH], max(KS))[1]
                for s in range(0, len(users), BATCH)]).cpu().numpy()

        preds, t_topk = timed(topk)
    _, t_metrics = timed(lambda: calculate_metrics(preds, data.true_test, KS))
    _, t_eval = timed(trainer.evaluate)
    _, t_predict = timed(lambda: trainer.predict(range(data.n_users),
                                                 save=True))
    log(f'serve breakdown (ms): propagation {t_prop:.3f}, score+top-k of '
        f'{len(users)} test users {t_topk:.3f}, metrics {t_metrics:.3f}, '
        f'evaluate {t_eval:.3f}, predict+write of {data.n_users} users '
        f'{t_predict:.3f}')


def gat_bound_ms(csr, d: int, n_kept: int, backward: bool):
    """Least time for one K3 (``backward=False``) or K4 launch: every input
    read once, every output written once, against the published peaks.
    K3 reads h (n_src, d), s, d, the CSR and writes num (n_dst, d), den
    and m; K4 (over the transpose CSR: n_dst here is the forward's n_src)
    reads h and g_num, the CSR and five vectors and writes dh, ds and dd.
    Operations: 2d (K3) or 4d (K4) per kept edge, ~8 per edge for the
    hash, the logit and the exp."""
    rows, cols = csr.n_dst, csr.n_src
    csr_bytes = 4 * (csr.rowptr.numel() + csr.col.numel())
    if backward:
        nbytes = csr_bytes + 4 * (2 * rows * d + 2 * rows + cols * d
                                  + 4 * cols)
        ops = 4 * n_kept * d + 8 * csr.n_edges
    else:
        nbytes = csr_bytes + 4 * (cols * d + cols + rows * d + 3 * rows)
        ops = 2 * n_kept * d + 8 * csr.n_edges
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def gat_kernel_phase(data, dev) -> dict:
    """K3 and K4 against their plain versions on the S1 graph, then their
    times at keep 1.0 (eval) and 0.6 (training)."""
    from textgcn_tpu_torch.ops import gat
    from textgcn_tpu_torch.ops.spmm import GraphOp
    g = data.graph
    op = GraphOp(g.edge_user, g.edge_item, np.ones(g.n_edges, np.float32),
                 data.n_users, data.n_items, dev)
    gen = torch.Generator().manual_seed(2)
    res = {name: {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                  'ms_keep_1': 0.0, 'max_abs_err': 0.0, 'by': set()}
           for name in ('gat_fwd', 'gat_bwd')}
    for direction, fwd, bwd in (('to_user', op.l_i2u, op.l_u2i),
                                ('to_item', op.l_u2i, op.l_i2u)):
        n_src, n_dst = fwd.n_src, fwd.n_dst
        h = torch.randn(n_src, D, generator=gen).to(dev)
        s = torch.randn(n_src, generator=gen).to(dev)
        d = torch.randn(n_dst, generator=gen).to(dev)
        g_num = torch.randn(n_dst, D, generator=gen).to(dev)
        g_den = torch.randn(n_dst, generator=gen).to(dev)
        for keep in (1.0, KEEP_DROPOUT):
            got = gat.gat_fwd_cuda(fwd, h, s, d, SALT, keep)
            want = gat.gat_att_plain(fwd, h, s, d, SALT, keep)
            m = want[2]
            got_b = gat.gat_bwd_cuda(bwd, h, s, d, m, g_num, g_den, SALT,
                                     keep)
            want_b = gat.gat_bwd_plain(bwd, h, s, d, m, g_num, g_den, SALT,
                                       keep)
            torch.cuda.synchronize()
            for name, a, b, tol in (('gat_fwd', got, want, TOL),
                                    ('gat_bwd', got_b, want_b,
                                     GAT_BWD_TOL)):
                err = max(float((x - y).abs().max()) for x, y in zip(a, b))
                res[name]['max_abs_err'] = max(res[name]['max_abs_err'],
                                               err)
                log(f'{name} {direction} keep={keep:.7g}: '
                    f'max_abs_err={err:.3e} (outputs {", ".join(f"{float(y.abs().max()):.3g}" for y in b)} at most)')
                check(all(torch.allclose(x, y, atol=tol, rtol=tol)
                          for x, y in zip(a, b)),
                      f'{name} {direction} keep={keep} disagrees with its '
                      f'plain version (max abs err {err:.3e})')
        n_kept = int((gat._edges(fwd, SALT, KEEP_DROPOUT)[2]).sum())
        for name, csr, backward in (('gat_fwd', fwd, False),
                                    ('gat_bwd', bwd, True)):
            if backward:
                kern = lambda keep: gat.gat_bwd_cuda(  # noqa: E731
                    bwd, h, s, d, m, g_num, g_den, SALT, keep)
                plain = lambda: gat.gat_bwd_plain(  # noqa: E731
                    bwd, h, s, d, m, g_num, g_den, SALT, KEEP_DROPOUT)
            else:
                kern = lambda keep: gat.gat_fwd_cuda(  # noqa: E731
                    fwd, h, s, d, SALT, keep)
                plain = lambda: gat.gat_att_plain(  # noqa: E731
                    fwd, h, s, d, SALT, KEEP_DROPOUT)
            t = time_ms({'kernel': lambda: kern(KEEP_DROPOUT),
                         'kernel_keep_1': lambda: kern(1.0)},
                        ['kernel', 'kernel_keep_1', 'kernel_keep_1',
                         'kernel'], strict=('kernel', 'kernel_keep_1'))
            # the plain version launches ~50 kernels a call: 5 a round
            # keep the launch queue from filling up behind the spin
            t.update(time_ms({'plain': plain}, ['plain', 'plain'],
                             strict=(), reps=5))
            b, by = gat_bound_ms(csr, D, n_kept, backward)
            log(f'timing {name} {direction} (E={csr.n_edges}, kept '
                f'{n_kept}, {csr.n_dst}x{csr.n_src}, d={D}): kernel keep=0.6 '
                f'{t["kernel"]:.4f} ms, keep=1 {t["kernel_keep_1"]:.4f} ms, '
                f'plain keep=0.6 {t["plain"]:.4f} ms, bound {b:.4f} ms '
                f'({by})')
            r = res[name]
            r['ms'] += t['kernel']
            r['ms_keep_1'] += t['kernel_keep_1']
            r['plain_ms'] += t['plain']
            r['bound_ms'] += b
            r['by'].add(by)
    for r in res.values():
        by = r.pop('by')
        r['bound_by'] = 'bytes' if by == {'bytes'} else 'operations'
    return res


def counts() -> dict[str, int]:
    from textgcn_tpu_torch.ops import gat
    from textgcn_tpu_torch.ops.spmm import spmm_dropout_cuda
    return {'spmm_dropout': spmm_dropout_cuda.launches,
            'gat_fwd': gat.gat_fwd_cuda.launches,
            'gat_bwd': gat.gat_bwd_cuda.launches}


def reset_counts():
    from textgcn_tpu_torch.ops import gat
    from textgcn_tpu_torch.ops.spmm import spmm_dropout_cuda
    spmm_dropout_cuda.launches = 0
    gat.gat_fwd_cuda.launches = 0
    gat.gat_bwd_cuda.launches = 0


def best_row(recall_first_k: np.ndarray) -> int:
    """The eval whose checkpoint ``best.pkl`` holds: the last one that
    reached the running maximum of recall@smallest-k."""
    best, top = 0, -np.inf
    for i, v in enumerate(recall_first_k):
        if v >= top:
            best, top = i, v
    return best


def plain_kernels():
    """Swap every kernel wrapper for its plain version (same signature),
    for a run on the card that goes through no kernel; returns the undo."""
    from textgcn_tpu_torch.ops import gat, spmm
    saved = (spmm.spmm_dropout_cuda, gat.gat_fwd_cuda, gat.gat_bwd_cuda)
    spmm.spmm_dropout_cuda = spmm.spmm_plain
    gat.gat_fwd_cuda = gat.gat_att_plain
    gat.gat_bwd_cuda = gat.gat_bwd_plain

    def undo():
        spmm.spmm_dropout_cuda, gat.gat_fwd_cuda, gat.gat_bwd_cuda = saved
    return undo


def loss_and_grads(model, batch, w_pairs):
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch, w_pairs=w_pairs)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def step_vs_plain(trainer) -> float:
    """One S1 step's loss and gradients with the kernels and with the
    plain versions, from the same params, batch and salts."""
    model = trainer.model
    batch = model.sample_batches(
        torch.Generator(device=model.device).manual_seed(5), BATCH)[0]
    w_pairs = ((SALT, KEEP_DROPOUT), (SALT ^ 0x5A5A5A5A, KEEP_DROPOUT))
    k_loss, k_grads = loss_and_grads(model, batch, w_pairs)
    before = counts()
    undo = plain_kernels()
    try:
        p_loss, p_grads = loss_and_grads(model, batch, w_pairs)
    finally:
        undo()
    check(counts() == before, 'the plain step launched a kernel')
    model.zero_grad(set_to_none=True)
    err = float((k_loss - p_loss).abs())
    check(torch.allclose(k_loss, p_loss, atol=STEP_TOL, rtol=STEP_TOL),
          f'loss with kernels {float(k_loss)} vs plain {float(p_loss)}')
    for name, g in k_grads.items():
        e = float((g - p_grads[name]).abs().max())
        err = max(err, e)
        check(torch.allclose(g, p_grads[name], atol=STEP_TOL, rtol=STEP_TOL),
              f'gradient of {name}: kernels vs plain max abs err {e:.3e}')
    log(f'step vs plain ({model.cfg.model}): loss {float(k_loss):.6f} vs '
        f'{float(p_loss):.6f}, max abs err over loss and '
        f'{len(k_grads)} gradients {err:.3e}')
    return err


def train_phase(data_dir: str, model: str) -> dict:
    """S1 trained through the CLI for ``TRAIN_EPOCHS`` epochs, eval every
    epoch; the kernel launches of that run, read just after it."""
    flags = ('--model', 'gat', '--aggr', 'mean') if model == 'gat' else (
        '--model', 'lgcn')
    argv = [*flags, '--epochs', str(TRAIN_EPOCHS), '--evaluate_every', '1',
            '--emb_size', str(D), '--n_layers', str(LAYERS), '--batch_size',
            str(BATCH), '--dropout', '0.4', '-k', *map(str, KS), '--uid',
            f'train-{model}', '--quiet']
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = cli_run(data_dir, argv, 'cuda')
    seconds = time.perf_counter() - t0
    launches = counts()
    steps = trainer.model.num_batches(BATCH)
    m = trainer.model
    log(f'train {model}: cli.main took {seconds:.3f} s; {steps} steps an '
        f'epoch (bucket_len {m.bucket_len} x {m.n_users} users / {BATCH}); '
        f'launches {launches}')
    check(steps == -(-m.bucket_len * m.n_users // BATCH) == 264,
          f'{steps} steps an epoch, expected ceil(9 * 60000 / 2048) = 264')
    total = steps * TRAIN_EPOCHS
    if model == 'lgcn':
        want = {'spmm_dropout': total * 4 * LAYERS
                + TRAIN_EPOCHS * 2 * LAYERS, 'gat_fwd': 0, 'gat_bwd': 0}
    else:
        want = {'spmm_dropout': 0,
                'gat_fwd': total * 2 * LAYERS + TRAIN_EPOCHS * 2 * LAYERS,
                'gat_bwd': total * 2 * LAYERS}
    check(launches == want, f'train {model}: launches {launches}, expected '
          f'{want}')
    hist = trainer.loss_history
    log(f'train {model}: loss sums by epoch '
        f'{[round(h["loss"], 4) for h in hist]}')
    check(len(hist) == TRAIN_EPOCHS
          and all(np.isfinite(h['loss']) for h in hist),
          f'train {model}: loss sums {hist}')
    check(hist[1]['loss'] < hist[0]['loss'],
          f'train {model}: epoch 2 loss sum {hist[1]["loss"]} is not below '
          f'epoch 1 {hist[0]["loss"]}')
    rows = trainer.metrics_logger
    best = best_row(rows['recall'][:, 0])
    served, _ = serve(data_dir, f'best-{model}',
                      ['--load', run_dir, '--emb_size', str(D), '--n_layers',
                       str(LAYERS), '--batch_size', str(BATCH), '-k',
                       *map(str, KS)], 'cuda', model=flags)
    for name, got in served.last_metrics.items():
        check(np.allclose(got, rows[name][best], atol=1e-6, rtol=0),
              f'train {model}: best.pkl serves {name} {got}, its epoch '
              f'{best + 1} measured {rows[name][best]}')
    log(f'train {model}: best.pkl (epoch {best + 1}) serves the same '
        f'metrics: {json.dumps(served.last_metrics)}')
    return {'trainer': trainer, 'launches': launches, 'seconds': seconds,
            'step_err': step_vs_plain(trainer)}


def device_ms_per_step(trainer, batches, trace_dir: str) -> tuple:
    """Device time of ``len(batches)`` training steps from a
    ``torch.profiler`` trace: the summed durations of its kernel, memcpy
    and memset events (one stream, so they do not overlap) per step, the
    number of those events per step, and the five kernels that take most
    of the time."""
    from torch.profiler import ProfilerActivity, profile
    model = trainer.model
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            trainer.train_step(batch, model.graph_op.weights(
                trainer.salt_generator, model.dropout))
        torch.cuda.synchronize()
    path = os.path.join(trace_dir, f'trace_{model.cfg.model}.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    by_name, n_events = {}, 0
    for e in events:
        if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            n_events += 1
            name = e['name'].replace('(anonymous namespace)::', '')
            name = re.split(r'[(<]', name.removeprefix('void '))[0]
            by_name[name] = by_name.get(name, 0.0) + e['dur'] / 1e3
    n = len(batches)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (sum(by_name.values()) / n, n_events / n,
            [(name, ms / n) for name, ms in top])


def timing_phase(trainer, card: str, trace_dir: str,
                 n_steps: int = 30) -> dict:
    """Where a training step's time goes at S1, after the counted run:
    sampling an epoch, and forward, backward and Adam of ``n_steps`` steps,
    each piece timed by the host clock around synchronised work; then
    ``n_steps`` unsynchronised steps: ms per step, examples/s and the
    host's share (the time to enqueue them over the time to finish); then
    10 steps under ``torch.profiler``: the device's busy time per step,
    whose share of the unsynchronised step is the device busy share."""
    model = trainer.model
    gen = torch.Generator(device=model.device).manual_seed(7)

    def sync_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    batches, t_sample = sync_ms(lambda: model.sample_batches(gen, BATCH))
    pieces = {'forward': [], 'backward': [], 'adam': []}
    per_step = {}
    for i, batch in enumerate(batches[:n_steps + 3]):
        w_pairs = model.graph_op.weights(trainer.salt_generator,
                                         model.dropout)
        trainer.optimizer.zero_grad(set_to_none=True)
        c0 = counts()
        (loss, _), t_f = sync_ms(lambda: model.loss(batch, w_pairs=w_pairs))
        c1 = counts()
        _, t_b = sync_ms(loss.backward)
        c2 = counts()
        _, t_a = sync_ms(trainer.optimizer.step)
        per_step = {'forward': {k: c1[k] - c0[k] for k in c0},
                    'backward': {k: c2[k] - c1[k] for k in c0}}
        if i >= 3:   # warm-up steps
            pieces['forward'].append(t_f)
            pieces['backward'].append(t_b)
            pieces['adam'].append(t_a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[:n_steps]:
        trainer.train_step(batch, model.graph_op.weights(
            trainer.salt_generator, model.dropout))
    t_enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    out = {name: float(np.median(v)) for name, v in pieces.items()}
    out['sampling_epoch'] = t_sample
    out['sampling_per_step'] = t_sample / len(batches)
    out['step'] = t_total / n_steps * 1e3
    out['examples_per_s'] = BATCH * n_steps / t_total
    out['host_enqueue_share'] = t_enqueue / t_total
    out['launches_per_step'] = per_step
    out['device'], out['device_events'], top = device_ms_per_step(
        trainer, batches[n_steps:n_steps + 10], trace_dir)
    out['device_busy_share'] = out['device'] / out['step']
    log(f'timing train {model.cfg.model} at S1 ({card}): sampling '
        f'{t_sample:.3f} ms an epoch ({out["sampling_per_step"]:.4f} ms a '
        f'step); forward {out["forward"]:.3f} ms, backward '
        f'{out["backward"]:.3f} ms, Adam {out["adam"]:.3f} ms (medians of '
        f'{n_steps} synchronised steps); unsynchronised step '
        f'{out["step"]:.3f} ms, {out["examples_per_s"]:.0f} examples/s, '
        f'host enqueue share {out["host_enqueue_share"]:.3f}; launches a '
        f'step {json.dumps(per_step)}; device busy {out["device"]:.3f} ms '
        f'a step (share {out["device_busy_share"]:.3f}) in '
        f'{out["device_events"]:.0f} kernels and copies, most in '
        + ', '.join(f'{name} {ms:.3f} ms' for name, ms in top))
    return out



def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: CUDA is not available')
    sys.path.insert(0, REPO)
    from textgcn_tpu_torch import cuda_build
    from textgcn_tpu_torch.data.core import load_interactions
    dev = torch.device('cuda')
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')

    t = time.perf_counter()
    card = card_name_and_power()
    log(card)
    log(f'phase device: {time.perf_counter() - t:.3f} s')

    t = time.perf_counter()
    built = cuda_build.build()
    for name, text in cuda_build.build_logs.items():
        log(f'nvcc {name}:\n{text.strip()}')
    log(f'phase build: {time.perf_counter() - t:.3f} s '
        f'(per source: {built or "already built"})')

    os.makedirs(os.path.join(REPO, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, 'build')) as root:
        t = time.perf_counter()
        data_dir = write_dataset(root, S1_USERS, S1_ITEMS, S1_DEG)
        t_load = time.perf_counter()
        data = load_interactions(data_dir)
        log(f'load_interactions: {time.perf_counter() - t_load:.3f} s')
        check((data.n_users, data.n_items) == (S1_USERS, S1_ITEMS),
              f'S1 loaded as {data.n_users} x {data.n_items}')
        ck = os.path.join(root, 's1_ck.pkl')
        write_jax_checkpoint(ck, data.n_users, data.n_items, D)
        log(f'phase data: {time.perf_counter() - t:.3f} s '
            f'({data.n_users} users, {data.n_items} items, '
            f'{data.n_train} train / {data.n_test} test edges)')

        t = time.perf_counter()
        k1 = kernel_phase(data, dev)
        log(f'phase kernel: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        gat_k = gat_kernel_phase(data, dev)
        log(f'phase gat kernel: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        small_phase(root)
        log(f'phase small: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        launches = serve_phase(data_dir, ck)
        log(f'phase serve: {time.perf_counter() - t:.3f} s')

        trained, timing = {}, {}
        for model in ('lgcn', 'gat'):
            t = time.perf_counter()
            trained[model] = train_phase(data_dir, model)
            log(f'phase train {model}: {time.perf_counter() - t:.3f} s')
        for model in ('lgcn', 'gat'):
            t = time.perf_counter()
            timing[model] = timing_phase(trained[model].pop('trainer'), card,
                                         root)
            log(f'phase timing {model}: {time.perf_counter() - t:.3f} s')

    by_path = {path: {name: trained[path]['launches'][name]
                      for name in ('spmm_dropout', 'gat_fwd', 'gat_bwd')}
               for path in trained}
    kernels = [{
        'name': 'spmm_dropout',
        'route': 'cuda',
        'source': 'textgcn_tpu_torch/csrc/spmm_dropout.cu',
        'replaces': 'textgcn_tpu/ops/pallas_spmm.py:103',
        # the serving path's and the lgcn training path's launches, each
        # counted from 0 just before its run (forward and backward)
        'launches': launches + by_path['lgcn']['spmm_dropout'],
        'launches_by_path': {'serve_lgcn': launches,
                             'train_lgcn': by_path['lgcn']['spmm_dropout']},
        'launches_per_step': {
            part: timing['lgcn']['launches_per_step'][part]['spmm_dropout']
            for part in ('forward', 'backward')},
        'max_abs_err': k1['max_abs_err'],
        # times and bound: one layer, i.e. the to_user + to_item launches
        # at keep = 1 on S1, d = 64 (ms_keep_0_6: the same at keep 0.6)
        'ms': k1['ms'],
        'ms_keep_0_6': k1['ms_keep_0_6'],
        'plain_ms': k1['plain_ms'],
        'bound_ms': k1['bound_ms'],
        'bound_by': k1['bound_by'],
        'library_ms': k1['library_ms'],
    }]
    for name, replaces in (('gat_fwd', 'textgcn_tpu/ops/pallas_gat.py:201'),
                           ('gat_bwd', 'textgcn_tpu/ops/pallas_gat.py:293')):
        r = gat_k[name]
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': f'textgcn_tpu_torch/csrc/{name}.cu',
            'replaces': replaces,
            'launches': by_path['gat'][name],
            'launches_per_step': {
                part: timing['gat']['launches_per_step'][part][name]
                for part in ('forward', 'backward')},
            'max_abs_err': r['max_abs_err'],
            # times, plain and bound: one layer (to_user + to_item) at
            # keep 0.6, the training path, on S1, d = 64
            'ms': r['ms'],
            'ms_keep_1': r['ms_keep_1'],
            'plain_ms': r['plain_ms'],
            'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'],
            'library_ms': None,
            'library_note': 'no single PyTorch call computes the masked '
                            'edge-softmax aggregation or its gradient',
        })
    steps = {m: {'step_ms': timing[m]['step'],
                 'examples_per_s': timing[m]['examples_per_s'],
                 'host_enqueue_share': timing[m]['host_enqueue_share'],
                 'device_ms_per_step': timing[m]['device'],
                 'device_busy_share': timing[m]['device_busy_share'],
                 'step_vs_plain_max_abs_err': trained[m]['step_err']}
             for m in timing}
    log(json.dumps({'training_at_s1': steps, 'card': card}))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
