#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``textgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (in parallel):
   ``spmm_dropout.cu`` (K1), ``spmm_weighted.cu`` (K2), ``gat_fwd.cu``
   (K3), ``gat_bwd.cu`` (K4), ``gatv2_fwd.cu`` (K5), ``gatv2_bwd.cu`` (K6),
   ``spmm_lab.cu`` (L1), ``gather_lab.cu`` (L2, L3);
3. kernel: holds K1 (``spmm_dropout``) against its plain torch version on
   the S1 graph, both directions, keep 1.0 and 0.6 with a salt whose high
   bit is set, within atol = rtol = 1e-5 (the summation order is the only
   difference; one flipped mask bit is ~0.1), and times the kernel, the
   plain version and ``torch.sparse.mm`` (a yardstick the port never
   calls) with CUDA events; then holds K1 against ``spmm_plain`` at the
   widths that take its other instances (``K1_WIDTHS``: float4 rows of 8,
   16 and 32 lanes, float2 rows, two column strips), to_user at keep 0.6;
3b. K2 kernel: partitions each direction of the S1 graph by source range
   into W = 1 and W = 4 shards on the one card, as the mesh path does
   (``parallel.sharded_spmm.build_shard``), and holds K2
   (``spmm_weighted``) against ``spmm_weighted_plain`` on every shard at
   keep 1.0 and 0.6 (the hash mask multiplied into the weights), and the
   sum of the four shards' outputs against K1 on the full CSR with the
   same salt, all within atol = rtol = 1e-5; times K2 on one layer at W =
   1 and per shard at W = 4, the plain version and ``torch.sparse.mm``
   with the same weights (a yardstick the port never calls); K2 at W = 1
   must give K1's bits at both keeps (same weights, same order of sums);
4. gat kernel: holds K3 against ``gat_att_plain`` (atol = rtol = 1e-5) and
   K4 against ``gat_bwd_plain`` (atol = rtol = 1e-4: K4 sums dd with
   float atomics in a changing order, and its sums run over up to ~100
   terms of magnitude ~10 here) on the S1 graph, both directions, keep 1.0
   and 0.6, with unit-scale random inputs, and times kernel and plain;
   then K4 at the widths that take its other instances (``ATT_WIDTHS``:
   one, two, four and eight float2 a lane, two and four float4), to_user
   at keep 0.6, with ``g_num`` scaled by sqrt(64 / d) so that
   ``g_num . h`` spreads as at d = 64;
5. gatv2 kernel: the same for K5 against ``gatv2_att_plain`` (atol = rtol
   = 1e-5) and K6 against ``gatv2_bwd_plain`` (atol = rtol = 1e-4 for dhs
   and dhd, summed with float atomics; da, a sum over every kept edge, to
   1e-4 of its largest entry), then K5 and K6 at ``ATT_WIDTHS``, to_user
   at keep 0.6, with ``a`` and ``g_num`` scaled by sqrt(64 / d) so that
   the logits spread as at d = 64;
5b. labs: runs the two lab entry points at the JAX labs' full shapes, as
   a user runs them (``textgcn_tpu_torch.tools.kernel_lab.main`` with all
   five modes at bf16 and at f32 x, ``gather_lab.main`` with both modes):
   L1 (``spmm_lab``), L2 (``gather_rows``) and L3 (``gather_rows_bulk``)
   launch exactly as often as their timing takes; then holds L1 in every
   mode and dtype against ``spmm_lab_plain`` (atol = rtol =
   1e-5), ``full`` against ``torch.sparse.mm`` and K2 over the same edges
   as a CSR, and L2 and L3 bit for bit against ``index_select``, and times
   each with its plain version and its library yardstick;
6. small: serves ``data/dummy`` through the CLI on the card and on the
   CPU (the plain path the CPU tests tie to the JAX package): the metrics
   agree within 1e-6 and the predictions up to ties; then the same for
   ``graphsage --aggr max``, whose segment max is plain torch: it launches
   no kernel;
7. serve: S1 (60,000 users x 25,000 items, ~545k edges, d = 64, 3 layers)
   served through ``textgcn_tpu_torch.cli.main`` from a JAX-format pickle
   (tables padded to 4096 rows): K1 launches exactly 12 times (eval and
   predict, 3 layers x 2 directions each), ``predictions.tsv`` has one row
   per user, the metrics are finite, and the served top-40 of 256 users
   equals the top-40 of a plain-SpMM propagation on the card up to ties;
8. train lgcn: S1 trained through ``cli.main`` for 2 epochs (batch 2048,
   dropout 0.4, eval every epoch): K1 launches exactly ``steps x 12 + 2
   evals x 6`` (6 forward and 6 backward a step), the loss sums are
   finite and fall, ``best.pkl`` serves through the CLI with the metrics
   of its epoch, and one step with the kernels agrees with one step with
   the plain versions on the card (same params, batch and salts: loss and
   gradients within atol = rtol = 1e-4, the f32 reordering of ~545k-term
   sums through 3 layers forward and back);
9. train gcn, graphsage, gat, gatv2 (``--aggr mean``): the same; ``gcn``
   and ``graphsage`` run K1 on the unit-weight op (``steps x 12 + 6`` per
   eval), ``gat`` launches K3 ``steps x 6 + 6`` per eval and K4 ``steps x
   6``, ``gatv2`` K5 and K6 the same; no single-card path launches K2;
9b. mesh: ``lgcn --mesh 1x1`` trained through ``cli.main`` with the
   ``lgcn`` phase's flags and seed (a one-rank NCCL group that the CLI
   starts and destroys): K2 launches exactly ``steps x 12 + evals x 6`` and
   K1 none, the loss sums equal phase 8's within 1e-5 relative and every
   eval's metrics within 1e-6 (same batches and salts), and its
   ``best.pkl`` serves through the non-mesh CLI with its epoch's metrics;
   then ``--mesh 1x1 --no_train --load --predict`` in a group this script
   starts serves S1 with 12 K2 launches and those metrics, and that
   trainer is timed as in phase 10;
10. timing: ms per training step and examples/s of each model at S1, split
   into sampling, forward, backward and Adam (host clock around
   synchronised work), the host's enqueue share of an unsynchronised run
   of steps, and the device's busy time per step from a ``torch.profiler``
   trace of 10 more.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on the main paths (K1-K6) or the lab paths (L1-L3), error,
times and bound; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import csv
import json
import os
import pickle
import re
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
# widths that take the redesigned kernels' other instances, held against
# their plain versions on one direction at keep 0.6: K1 (vec, lanes)
# (ops/spmm.k1_layout) (4, 8), (4, 16) with idle lanes, (2, 32), (4, 32)
# and (4, 32) over two column strips; K4, K5 and K6 (vec, per)
# (ops/gat.att_layout) (2, 1), (2, 2), (2, 4), (4, 2), (2, 8) and (4, 4):
# with S1's (4, 1), every instance they build
K1_WIDTHS = (32, 48, 62, 128, 256)
ATT_WIDTHS = (30, 62, 126, 128, 254, 256)
STEP_TOL = 1e-4
TRAIN_EPOCHS = 2
N_CHECK_USERS = 256


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
                         seed: int = 0, model: str = 'lgcn',
                         conv_keys: tuple[str, ...] = (), layers: int = 0):
    """A pickle in the JAX package's format: N(0, 0.1) tables padded to a
    multiple of 4096 rows, as its Pallas backend writes them; with
    ``conv_keys``, ``layers`` conv layers of N(0, 0.2) weights, ``(d, d)``
    for a ``w*`` key and ``(d,)`` for the others."""
    rng = np.random.RandomState(seed)
    pad = lambda n: -(-n // 4096) * 4096  # noqa: E731
    params = {
        'user_emb': (0.1 * rng.randn(pad(n_users), d)).astype(np.float32),
        'item_emb': (0.1 * rng.randn(pad(n_items), d)).astype(np.float32),
    }
    if conv_keys:
        params['convs'] = [
            {k: (0.2 * rng.randn(*((d, d) if k.startswith('w') else (d,))))
             .astype(np.float32) for k in conv_keys}
            for _ in range(layers)]
    with open(path, 'wb') as f:
        pickle.dump({'params': params, 'epoch': 0, 'model': model}, f)


def nvidia_smi(fields: str) -> str:
    from textgcn_tpu_torch.tools import timing
    return timing.nvidia_smi(fields)


def card_name_and_power() -> str:
    return nvidia_smi('name,power.limit')


def time_ms(*args, **kwargs) -> dict[str, float]:
    """``textgcn_tpu_torch.tools.timing.time_ms``: median device ms of
    single launches behind a spin kernel, variants in turns."""
    from textgcn_tpu_torch.tools import timing
    return timing.time_ms(*args, **kwargs)


def bound_ms(csr, d: int) -> tuple[float, str]:
    """Least time for one direction on the card: every input read once
    (x table, CSR), the output written once, and 2*E*d f32 operations,
    against the published peaks."""
    nbytes = 4 * (csr.n_src * d + csr.rowptr.numel() + csr.col.numel()
                  + csr.w.numel() + csr.n_dst * d)
    from textgcn_tpu_torch.tools import timing
    return timing.bound_ms(nbytes, 2 * csr.n_edges * d)


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
    result['max_abs_err_by_width'] = {}
    for d in K1_WIDTHS:
        x = torch.randn(op.n_items, d, generator=gen).to(dev)
        got = spmm_dropout_cuda(op.l_i2u, x, SALT, KEEP_DROPOUT)
        want = spmm_plain(op.l_i2u, x, SALT, KEEP_DROPOUT)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        result['max_abs_err_by_width'][d] = err
        log(f'kernel to_user d={d} keep={KEEP_DROPOUT:.7g}: max_abs_err='
            f'{err:.3e}')
        check(torch.allclose(got, want, atol=TOL, rtol=TOL),
              f'K1 at d={d} disagrees with spmm_plain (max abs err '
              f'{err:.3e})')
    return result


def k2_phase(data, dev) -> dict:
    """K2 against spmm_weighted_plain on W = 1 and W = 4 source-range
    shards of the S1 graph, the four shards' sum against K1, then times.

    Returns one layer's (to_user + to_item) times and bound at W = 1, and
    the same per shard at W = 4 (the mean over the four shards)."""
    from textgcn_tpu_torch.ops.spmm import (GraphOp, edge_dropout_scale,
                                            spmm_dropout_cuda,
                                            spmm_weighted_cuda,
                                            spmm_weighted_plain)
    from textgcn_tpu_torch.parallel.sharded_spmm import build_shard
    g = data.graph
    op = GraphOp(g.edge_user, g.edge_item, g.edge_weight, data.n_users,
                 data.n_items, dev)
    gen = torch.Generator().manual_seed(4)
    res = {'max_abs_err': 0.0, 'max_abs_err_vs_k1': 0.0, 'ms': 0.0,
           'plain_ms': 0.0, 'library_ms': 0.0, 'bound_ms': 0.0,
           'ms_w4_per_shard': 0.0, 'plain_ms_w4_per_shard': 0.0,
           'bound_ms_w4_per_shard': 0.0}
    by = set()
    for direction, full, src, dst, n_src, n_dst, dst_is_user in (
            ('to_user', op.l_i2u, g.edge_item, g.edge_user, data.n_items,
             data.n_users, True),
            ('to_item', op.l_u2i, g.edge_user, g.edge_item, data.n_users,
             data.n_items, False)):
        for n_ranks in (1, 4):
            n_src_p = -(-n_src // n_ranks) * n_ranks
            n_dst_p = -(-n_dst // n_ranks) * n_ranks
            x = torch.zeros(n_src_p, D)
            x[:n_src] = torch.randn(n_src, D, generator=gen)
            x = x.to(dev)
            per = n_src_p // n_ranks
            shards = [build_shard(src, dst, g.edge_weight, n_src_p, n_dst_p,
                                  n_ranks, r, dst_is_user, dev)
                      for r in range(n_ranks)]
            weights = {}
            for keep in (1.0, KEEP_DROPOUT):
                total = torch.zeros(n_dst_p, D, device=dev)
                for r, sh in enumerate(shards):
                    w = sh.csr.w if keep >= 1.0 else sh.csr.w * \
                        edge_dropout_scale(sh.users, sh.items, SALT, keep)
                    weights[r, keep] = w
                    xr = x[r * per:(r + 1) * per]
                    got = spmm_weighted_cuda(sh.csr, w, xr)
                    want = spmm_weighted_plain(sh.csr, w, xr)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    res['max_abs_err'] = max(res['max_abs_err'], err)
                    check(torch.allclose(got, want, atol=TOL, rtol=TOL),
                          f'K2 {direction} W={n_ranks} shard {r} keep={keep}'
                          f' disagrees with spmm_weighted_plain (max abs err '
                          f'{err:.3e})')
                    total += got
                k1 = spmm_dropout_cuda(full, x[:n_src], SALT, keep)
                torch.cuda.synchronize()
                err_k1 = float((total[:n_dst] - k1).abs().max())
                log(f'K2 {direction} W={n_ranks} keep={keep:.7g}: max_abs_err '
                    f'vs plain {res["max_abs_err"]:.3e}, sum of shards vs K1 '
                    f'{err_k1:.3e}')
                check(torch.allclose(total[:n_dst], k1, atol=TOL, rtol=TOL)
                      and not total[n_dst:].any(),
                      f'K2 {direction} W={n_ranks} keep={keep}: the sum of '
                      f'the shards disagrees with K1 ({err_k1:.3e})')
                if n_ranks == 1:
                    # the same weights in the same order: K1's bits
                    check(torch.equal(total, k1),
                          f'K2 {direction} W=1 keep={keep} is not bit-equal '
                          f'to K1')
                else:
                    res['max_abs_err_vs_k1'] = max(res['max_abs_err_vs_k1'],
                                                   err_k1)
            if n_ranks == 1:
                csr, w = shards[0].csr, weights[0, 1.0]
                with warnings.catch_warnings():   # "sparse CSR is in beta"
                    warnings.simplefilter('ignore', UserWarning)
                    lib = torch.sparse_csr_tensor(csr.rowptr, csr.col, w,
                                                  size=(csr.n_dst, csr.n_src))
                t = time_ms({'plain': lambda: spmm_weighted_plain(csr, w, x),
                             'kernel': lambda: spmm_weighted_cuda(csr, w, x),
                             'library': lambda: torch.sparse.mm(lib, x)},
                            ['plain', 'kernel', 'library', 'library',
                             'kernel', 'plain'])
                b, b_by = bound_ms(csr, D)
                by.add(b_by)
                log(f'timing K2 {direction} W=1 (E={csr.n_edges}, '
                    f'{csr.n_dst}x{csr.n_src}, d={D}): kernel '
                    f'{t["kernel"]:.4f} ms, plain {t["plain"]:.4f} ms, '
                    f'torch.sparse.mm {t["library"]:.4f} ms, bound '
                    f'{b:.4f} ms ({b_by})')
                res['ms'] += t['kernel']
                res['plain_ms'] += t['plain']
                res['library_ms'] += t['library']
                res['bound_ms'] += b
                continue
            for r, sh in enumerate(shards):
                xr, w = x[r * per:(r + 1) * per], weights[r, 1.0]
                t = time_ms(
                    {'kernel': lambda: spmm_weighted_cuda(sh.csr, w, xr),
                     'plain': lambda: spmm_weighted_plain(sh.csr, w, xr)},
                    ['plain', 'kernel', 'kernel', 'plain'])
                b, _ = bound_ms(sh.csr, D)
                log(f'timing K2 {direction} W=4 shard {r} (E='
                    f'{sh.csr.n_edges}, {sh.csr.n_dst}x{sh.csr.n_src}): '
                    f'kernel {t["kernel"]:.4f} ms, plain {t["plain"]:.4f} ms, '
                    f'bound {b:.4f} ms')
                res['ms_w4_per_shard'] += t['kernel'] / n_ranks
                res['plain_ms_w4_per_shard'] += t['plain'] / n_ranks
                res['bound_ms_w4_per_shard'] += b / n_ranks
    log('clocks after timing (sm, max sm, power, temperature): '
        + nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu'))
    res['bound_by'] = 'bytes' if by == {'bytes'} else 'operations'
    return res


def lab_phase(dev) -> dict:
    """L1-L3 through the two lab entry points, counted from 0 (every L1
    mode at bf16 and f32 x, both gathers), then each kernel held against
    its plain version at the labs' full shapes and timed in turns with it
    and with a library yardstick.  Returns the rows' numbers."""
    from textgcn_tpu_torch.ops.spmm import build_csr, spmm_weighted_cuda
    from textgcn_tpu_torch.tools import gather_lab, kernel_lab, timing
    from textgcn_tpu_torch.tools.lab_layout import tile_layout
    l1, l2, l3 = (kernel_lab.spmm_lab_cuda, gather_lab.gather_rows_cuda,
                  gather_lab.gather_rows_bulk_cuda)
    dtypes = {'bf16': torch.bfloat16, 'f32': torch.float32}

    reset_counts()
    t = time.perf_counter()
    entry = {}
    old = os.environ.get(kernel_lab.XDTYPE_ENV)
    try:
        for xd in dtypes:
            os.environ[kernel_lab.XDTYPE_ENV] = xd
            entry[xd] = kernel_lab.main(list(kernel_lab.MODES))
    finally:
        if old is None:
            os.environ.pop(kernel_lab.XDTYPE_ENV, None)
        else:
            os.environ[kernel_lab.XDTYPE_ENV] = old
    entry['gather'] = gather_lab.main(list(gather_lab.MODES))
    launches = counts()
    per_mode = 2 * (timing.WARMUP + timing.TIMED_LAUNCHES)
    want = dict.fromkeys(launches, 0)
    want.update(spmm_lab=per_mode * len(kernel_lab.MODES) * len(dtypes),
                gather_rows=per_mode, gather_rows_bulk=per_mode)
    log(f'labs: the entry points took {time.perf_counter() - t:.3f} s; '
        f'launches {launches}')
    check(launches == want, f'labs: launches {launches}, expected {want}')

    # L1: every mode at both dtypes vs plain
    src, dst, w, rng = kernel_lab.lab_graph()
    layout = tile_layout(src, dst, w, kernel_lab.NI, kernel_lab.NU).to(dev)
    x32 = kernel_lab.lab_x(rng, layout.n_src_padded, torch.float32).to(dev)
    xs = {xd: x32.to(dt) for xd, dt in dtypes.items()}
    l1_err, full_out = 0.0, None
    for xd, x in xs.items():
        for mode in kernel_lab.MODES:
            want_out = kernel_lab.spmm_lab_plain(layout, x, mode)
            got = l1(layout, x, mode)
            torch.cuda.synchronize()
            err = float((got - want_out).abs().max())
            check(torch.allclose(got, want_out, atol=TOL, rtol=TOL),
                  f'L1 {mode} x={xd} disagrees with spmm_lab_plain (max abs '
                  f'err {err:.3e})')
            l1_err = max(l1_err, err)
            log(f'L1 {mode} x={xd}: max_abs_err {err:.3e}')
            if (xd, mode) == ('f32', 'full'):
                full_out = got

    # the same edges as a destination-sorted CSR: torch.sparse.mm with
    # duplicates summed (the yardstick), and K2, the port's own SpMM
    n_dst_p = layout.n_dst_blocks * layout.dst_block
    k2_csr = build_csr(dst, src, w, n_dst_p, layout.n_src_padded, True, dev)
    with warnings.catch_warnings():   # "sparse CSR is in beta"
        warnings.simplefilter('ignore', UserWarning)
        lib = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([dst, src]).astype(np.int64)),
            torch.from_numpy(w), (n_dst_p, layout.n_src_padded)) \
            .coalesce().to_sparse_csr().to(dev)
    k2_out = spmm_weighted_cuda(k2_csr, k2_csr.w, x32)
    lib_out = torch.sparse.mm(lib, x32)
    torch.cuda.synchronize()
    for name, other in (('K2', k2_out), ('torch.sparse.mm', lib_out)):
        err = float((other - full_out).abs().max())
        log(f'L1 full f32 vs {name} on the same edges: max_abs_err {err:.3e}')
        check(torch.allclose(other, full_out, atol=TOL, rtol=TOL),
              f'L1 full disagrees with {name} ({err:.3e})')

    t_full = time_ms({'plain': lambda: kernel_lab.spmm_lab_plain(
                          layout, x32, 'full'),
                      'kernel': lambda: l1(layout, x32, 'full'),
                      'library': lambda: torch.sparse.mm(lib, x32),
                      'k2': lambda: spmm_weighted_cuda(k2_csr, k2_csr.w,
                                                       x32)},
                     ['plain', 'kernel', 'library', 'k2', 'k2', 'library',
                      'kernel', 'plain'],
                     strict=('kernel', 'k2'))
    bound, by, nbytes = kernel_lab.spmm_lab_bound(layout, x32, 'full')
    # the same bound over the real edges alone: what the padding slots cost
    edge_bound, _ = timing.bound_ms(
        nbytes - 8 * (layout.n_slots - kernel_lab.E),
        2 * kernel_lab.E * kernel_lab.D)
    ms_by_mode = {xd: {m: r['ms'] for m, r in entry[xd].items()}
                  for xd in dtypes}
    bound_by_mode = {xd: {m: r['bound_ms'] for m, r in entry[xd].items()}
                     for xd in dtypes}
    log(f'timing L1 full x=f32 (845,824 slots, out ({n_dst_p}, '
        f'{kernel_lab.D})): kernel {t_full["kernel"]:.4f} ms, plain '
        f'{t_full["plain"]:.4f} ms, torch.sparse.mm {t_full["library"]:.4f}'
        f' ms, K2 on the CSR {t_full["k2"]:.4f} ms, bound {bound:.4f} ms '
        f'({by}, {nbytes / 1e6:.1f} MB; over the {kernel_lab.E} real edges '
        f'alone {edge_bound:.4f} ms); entry point ms by mode '
        f'{json.dumps(ms_by_mode)}')
    res = {'L1': {
        'launches': launches['spmm_lab'], 'max_abs_err': l1_err,
        'ms': t_full['kernel'], 'plain_ms': t_full['plain'],
        'bound_ms': bound, 'bound_by': by, 'library_ms': t_full['library'],
        'ms_by_mode': ms_by_mode, 'bound_ms_by_mode': bound_by_mode,
        'bound_ms_real_edges': edge_bound, 'k2_csr_ms': t_full['k2']}}

    # L2 and L3: bitwise against index_select, then timed in turns with it
    # and with the other gather kernel on the same ids and table
    ids_all, rng = gather_lab.lab_ids()
    for row, name, mode, kernel, other, width in (
            ('L2', 'gather_rows', 'onehot', l2, l3, gather_lab.D),
            ('L3', 'gather_rows_bulk', 'dma', l3, l2, gather_lab.DMA_D)):
        ids = torch.from_numpy(gather_lab.mode_ids(ids_all, mode)).to(dev)
        x = gather_lab.lab_x(rng, width).to(dev)
        got, got_other = kernel(x, ids), other(x, ids)
        want_out = gather_lab.gather_rows_plain(x, ids)
        torch.cuda.synchronize()
        err = float((got - want_out).abs().max())
        check(torch.equal(got, want_out) and torch.equal(got_other, want_out),
              f'{row} ({mode}) differs from index_select ({err:.3e})')
        tm = time_ms({'plain': lambda: gather_lab.gather_rows_plain(x, ids),
                      'kernel': lambda: kernel(x, ids),
                      'other': lambda: other(x, ids)},
                     ['plain', 'kernel', 'other', 'other', 'kernel',
                      'plain'], strict=('kernel', 'other'))
        bound, by, nbytes = gather_lab.gather_bound(x, ids)
        n = ids.numel()
        log(f'timing {row} ({mode}, {n} rows of {width}): kernel '
            f'{tm["kernel"]:.4f} ms ({n / tm["kernel"] / 1e3:.1f}k rows/ms),'
            f' the other gather kernel {tm["other"]:.4f} ms, index_select '
            f'{tm["plain"]:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f}'
            f' MB); entry point {entry["gather"][mode]["ms"]:.4f} ms')
        res[row] = {'launches': launches[name], 'max_abs_err': err,
                    'ms': tm['kernel'], 'plain_ms': tm['plain'],
                    'bound_ms': bound, 'bound_by': by,
                    'library_ms': tm['plain'], 'rows': n,
                    'ms_entry_point': entry['gather'][mode]['ms'],
                    'other_gather_kernel_ms': tm['other']}
    log('clocks after timing (sm, max sm, power, temperature): '
        + nvidia_smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu'))
    return res


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


def small_phase(root: str) -> dict[str, int]:
    """data/dummy served on the card and on the CPU, as ``lgcn`` and as
    ``graphsage --aggr max``: same metrics and predictions.  Returns the
    kernel launches of the graphsage runs, which must be none."""
    import shutil
    dummy = os.path.join(root, 'dummy')
    shutil.copytree(os.path.join(REPO, 'data', 'dummy'), dummy)
    from textgcn_tpu_torch.data.core import load_interactions
    data = load_interactions(dummy)
    common = ['--predict', '--emb_size', '16', '--batch_size', '16', '-k',
              '3', '5']
    for model, flags, conv_keys in (
            ('lgcn', ('--model', 'lgcn'), ()),
            ('graphsage-max', ('--model', 'graphsage', '--aggr', 'max',
                               '--n_layers', '2'),
             ('w_nbr', 'w_root', 'b'))):
        ck = os.path.join(root, f'dummy_{model}.pkl')
        write_jax_checkpoint(ck, data.n_users, data.n_items, 16, seed=3,
                             model=flags[1], conv_keys=conv_keys, layers=2)
        runs = {}
        reset_counts()
        for platform in ('cuda', 'cpu'):
            trainer, run_dir = serve(dummy, f'small-{model}-{platform}',
                                     ['--load', ck, *common], platform,
                                     model=flags)
            runs[platform] = (trainer.last_metrics, read_predictions(
                os.path.join(run_dir, 'predictions.tsv')))
        launches = counts()
        (m_gpu, p_gpu), (m_cpu, p_cpu) = runs['cuda'], runs['cpu']
        for name in m_cpu:
            check(np.allclose(m_gpu[name], m_cpu[name], atol=1e-6, rtol=0),
                  f'dummy {model} {name}: card {m_gpu[name]} vs CPU '
                  f'{m_cpu[name]}')
        check([r[0] for r in p_gpu] == [r[0] for r in p_cpu],
              f'dummy {model} users')
        check(same_up_to_ties([r[2] for r in p_gpu], [r[1] for r in p_gpu],
                              [r[2] for r in p_cpu], [r[1] for r in p_cpu],
                              2e-4),
              f'dummy {model} predictions differ beyond ties')
        log(f'small: dummy {model} metrics card == CPU: {m_gpu}; '
            f'launches {launches}')
    check(not any(launches.values()),
          f'graphsage --aggr max launched kernels: {launches}')
    return launches


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
    check(sum(counts().values()) == launches,
          f'serving lgcn launched attention kernels: {counts()}')
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


OUTPUTS = {'gat_fwd': ('num', 'den', 'm'), 'gat_bwd': ('dh', 'ds', 'dd'),
           'gatv2_fwd': ('num', 'den', 'm'),
           'gatv2_bwd': ('dhs', 'dhd', 'da')}
# per kernel: (floats read and written, operations per kept edge) of one
# launch over ``rows`` x ``cols`` (see attention_bound_ms)
ATTENTION_WORK = {
    'gat_fwd': lambda rows, cols, d: (cols * d + cols + rows * d + 3 * rows,
                                      2 * d),
    'gat_bwd': lambda rows, cols, d: (2 * rows * d + 2 * rows + cols * d
                                      + 4 * cols, 4 * d),
    'gatv2_fwd': lambda rows, cols, d: (cols * d + 2 * rows * d + d
                                        + 2 * rows, 6 * d),
    'gatv2_bwd': lambda rows, cols, d: (2 * rows * d + 3 * cols * d + 2 * d
                                        + 2 * cols, 13 * d),
}


def attention_bound_ms(name: str, csr, d: int, n_kept: int):
    """Least time for one launch of an attention kernel: every input read
    once, every output written once, against the published peaks.  Over
    the forward CSR (rows = destinations j, cols = sources i):

    * K3 ``gat_fwd`` reads h (cols, d), s, d and the CSR and writes num
      (rows, d), den and m: 2d operations per kept edge;
    * K5 ``gatv2_fwd`` reads hs (cols, d), hd (rows, d), a and the CSR and
      writes num (rows, d), den and m: 6d per kept edge (u, leaky, a . lk,
      num);

    over the transpose CSR (rows = forward sources i, cols = forward
    destinations j):

    * K4 ``gat_bwd`` reads h (rows, d), s, g_num (cols, d), d, m, g_den and
      the CSR and writes dh (rows, d), ds and dd: 4d per kept edge;
    * K6 ``gatv2_bwd`` reads hs (rows, d), hd and g_num (cols, d), a, m,
      g_den and the CSR and writes dhs (rows, d), dhd (cols, d) and da:
      13d per kept edge (u, leaky, z, the dot, dhs, dhd, da).

    Each adds ~8 operations per edge for the hash, the logit and the exp.
    """
    floats, per_kept = ATTENTION_WORK[name](csr.n_dst, csr.n_src, d)
    nbytes = 4 * (csr.rowptr.numel() + csr.col.numel() + floats)
    from textgcn_tpu_torch.tools import timing
    return timing.bound_ms(nbytes, per_kept * n_kept + 8 * csr.n_edges)


def agree(got, want, tol: float, whole: bool) -> bool:
    """Within ``tol`` entry by entry (atol = rtol), or, for a ``whole``
    sum such as GATv2's ``da``, within ``tol`` times its largest entry."""
    if whole:
        return float((got - want).abs().max()) <= tol * float(
            want.abs().max())
    return torch.allclose(got, want, atol=tol, rtol=tol)


def tol_share(pairs, tol: float, whole) -> float:
    """The largest ``|got - want| / (tol + tol |want|)`` over the entries
    of the entrywise ``(got, want)`` pairs (``whole`` marks the others):
    ``agree`` holds while it is at most 1."""
    return max(float(((x - y).abs() / (tol * (1 + y.abs()))).max())
               for (x, y), w in zip(pairs, whole) if not w)


def attention_kernel_phase(data, dev, conv: str) -> dict:
    """K3 and K4 (``conv='gat'``) or K5 and K6 (``'gatv2'``) against their
    plain versions on the S1 graph, both directions, keep 1.0 and 0.6; then
    their times at keep 0.6 (training) and 1.0 (eval), the plain versions'
    at 0.6, and the bounds.

    Forward outputs agree within atol = rtol = ``TOL``; backward ones
    within ``GAT_BWD_TOL``, each entry, except GATv2's ``da``: a sum over
    every kept edge of the direction, it is held to ``GAT_BWD_TOL`` times
    its largest entry."""
    from textgcn_tpu_torch.ops import gat
    from textgcn_tpu_torch.ops.spmm import GraphOp, edge_mask
    g = data.graph
    op = GraphOp(g.edge_user, g.edge_item, np.ones(g.n_edges, np.float32),
                 data.n_users, data.n_items, dev)
    gen = torch.Generator().manual_seed(2 if conv == 'gat' else 3)
    names = (f'{conv}_fwd', f'{conv}_bwd')
    kernels = (getattr(gat, f'{conv}_fwd_cuda'),
               getattr(gat, f'{conv}_bwd_cuda'))
    plains = (getattr(gat, f'{conv}_att_plain'),
              getattr(gat, f'{conv}_bwd_plain'))
    res = {name: {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                  'ms_keep_1': 0.0, 'max_abs_err': 0.0,
                  'max_abs_err_by_output': {}, 'by': set()}
           for name in names}

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    for direction, fwd, bwd in (('to_user', op.l_i2u, op.l_u2i),
                                ('to_item', op.l_u2i, op.l_i2u)):
        n_src, n_dst = fwd.n_src, fwd.n_dst
        if conv == 'gat':      # h, s, d
            ins = (rand(n_src, D), rand(n_src), rand(n_dst))
        else:                  # hs, hd, a
            ins = (rand(n_src, D), rand(n_dst, D), 0.5 * rand(D))
        g_num, g_den = rand(n_dst, D), rand(n_dst)
        for keep in (1.0, KEEP_DROPOUT):
            got = kernels[0](fwd, *ins, SALT, keep)
            want = plains[0](fwd, *ins, SALT, keep)
            m = want[2]
            got_b = kernels[1](bwd, *ins, m, g_num, g_den, SALT, keep)
            want_b = plains[1](bwd, *ins, m, g_num, g_den, SALT, keep)
            torch.cuda.synchronize()
            for name, a, b, tol in ((names[0], got, want, TOL),
                                    (names[1], got_b, want_b, GAT_BWD_TOL)):
                errs = [float((x - y).abs().max()) for x, y in zip(a, b)]
                err = max(errs)
                r = res[name]
                r['max_abs_err'] = max(r['max_abs_err'], err)
                r['max_abs_err_by_output'] = {
                    out: max(e, r['max_abs_err_by_output'].get(out, 0.0))
                    for out, e in zip(OUTPUTS[name], errs)}
                whole = (False, False, name == 'gatv2_bwd')
                log(f'{name} {direction} keep={keep:.7g}: '
                    f'max_abs_err={err:.3e} (by output '
                    + ', '.join(f'{out} {e:.3e} of {float(y.abs().max()):.3g}'
                                for out, e, y in zip(OUTPUTS[name], errs, b))
                    + f'; {tol_share(zip(a, b), tol, whole):.3f} of the '
                    'tolerance)')
                check(all(agree(x, y, tol, w)
                          for x, y, w in zip(a, b, whole)),
                      f'{name} {direction} keep={keep} disagrees with its '
                      f'plain version (max abs err {err:.3e})')
        n_kept = int(edge_mask(fwd, SALT, KEEP_DROPOUT)[2].sum())
        for name, csr, kernel, plain, extra in (
                (names[0], fwd, kernels[0], plains[0], ()),
                (names[1], bwd, kernels[1], plains[1], (m, g_num, g_den))):
            def kern(keep, csr=csr, kernel=kernel, extra=extra):
                return kernel(csr, *ins, *extra, SALT, keep)

            def plain_call(csr=csr, plain=plain, extra=extra):
                return plain(csr, *ins, *extra, SALT, KEEP_DROPOUT)

            t = time_ms({'kernel': lambda: kern(KEEP_DROPOUT),
                         'kernel_keep_1': lambda: kern(1.0)},
                        ['kernel', 'kernel_keep_1', 'kernel_keep_1',
                         'kernel'], strict=('kernel', 'kernel_keep_1'))
            # the plain version launches ~50 kernels a call: 5 a round
            # keep the launch queue from filling up behind the spin
            t.update(time_ms({'plain': plain_call}, ['plain', 'plain'],
                             strict=(), reps=5))
            b, by = attention_bound_ms(name, csr, D, n_kept)
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
    for name, errs in attention_widths(conv, op, dev, gen).items():
        res[name]['max_abs_err_by_width'] = errs
    return res


def attention_widths(conv: str, op, dev, gen) -> dict[str, dict]:
    """The templated attention kernels of ``conv`` (K4 for 'gat', K5 and
    K6 for 'gatv2') against their plain versions at ``ATT_WIDTHS``, to_user
    at keep 0.6, within phases 4 and 5's tolerances: ``{name: {d: max abs
    error by output}}``.  ``a`` and ``g_num`` are scaled by sqrt(D / d), so
    that the logits and ``g_num . h`` spread as at d = D: unscaled they
    grow with sqrt(d), and so do the sums' rounding errors."""
    from textgcn_tpu_torch.ops import gat
    fwd, bwd = op.l_i2u, op.l_u2i
    names = ('gat_bwd',) if conv == 'gat' else ('gatv2_fwd', 'gatv2_bwd')
    errs = {name: {} for name in names}

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    for d in ATT_WIDTHS:
        scale = (D / d) ** 0.5
        if conv == 'gat':      # h, s, d
            ins = (rand(fwd.n_src, d), rand(fwd.n_src), rand(fwd.n_dst))
        else:                  # hs, hd, a
            ins = (rand(fwd.n_src, d), rand(fwd.n_dst, d),
                   rand(d, scale=0.5 * scale))
        g_num, g_den = rand(fwd.n_dst, d, scale=scale), rand(fwd.n_dst)
        fwd_plain = getattr(gat, f'{conv}_att_plain')
        m = fwd_plain(fwd, *ins, SALT, KEEP_DROPOUT)[2]
        for name in names:
            if name.endswith('_fwd'):
                args, tol = (fwd, *ins, SALT, KEEP_DROPOUT), TOL
            else:
                args = (bwd, *ins, m, g_num, g_den, SALT, KEEP_DROPOUT)
                tol = GAT_BWD_TOL
            got = getattr(gat, f'{name}_cuda')(*args)
            want = (fwd_plain if name.endswith('_fwd') else
                    getattr(gat, f'{name}_plain'))(*args)
            torch.cuda.synchronize()
            e = errs[name][d] = [float((x - y).abs().max())
                                 for x, y in zip(got, want)]
            whole = (False, False, name == 'gatv2_bwd')
            log(f'{name} to_user d={d} keep={KEEP_DROPOUT:.7g}: max_abs_err '
                + ', '.join(f'{out} {v:.3e} of {float(y.abs().max()):.3g}'
                            for out, v, y in zip(OUTPUTS[name], e, want))
                + f'; {tol_share(zip(got, want), tol, whole):.3f} of the '
                'tolerance')
            check(all(agree(x, y, tol, w)
                      for x, y, w in zip(got, want, whole)),
                  f'{name} at d={d} disagrees with its plain version ({e})')
    return errs


def _wrappers():
    """``{kernel name: (module, wrapper attribute, plain attribute)}``."""
    from textgcn_tpu_torch.ops import gat, spmm
    from textgcn_tpu_torch.tools import gather_lab, kernel_lab
    return {'spmm_dropout': (spmm, 'spmm_dropout_cuda', 'spmm_plain'),
            'spmm_weighted': (spmm, 'spmm_weighted_cuda',
                              'spmm_weighted_plain'),
            'gat_fwd': (gat, 'gat_fwd_cuda', 'gat_att_plain'),
            'gat_bwd': (gat, 'gat_bwd_cuda', 'gat_bwd_plain'),
            'gatv2_fwd': (gat, 'gatv2_fwd_cuda', 'gatv2_att_plain'),
            'gatv2_bwd': (gat, 'gatv2_bwd_cuda', 'gatv2_bwd_plain'),
            'spmm_lab': (kernel_lab, 'spmm_lab_cuda', 'spmm_lab_plain'),
            'gather_rows': (gather_lab, 'gather_rows_cuda',
                            'gather_rows_plain'),
            'gather_rows_bulk': (gather_lab, 'gather_rows_bulk_cuda',
                                 'gather_rows_plain')}


def counts() -> dict[str, int]:
    return {name: getattr(mod, attr).launches
            for name, (mod, attr, _) in _wrappers().items()}


def reset_counts():
    for mod, attr, _ in _wrappers().values():
        getattr(mod, attr).launches = 0


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
    wrappers = _wrappers()
    saved = {name: getattr(mod, attr)
             for name, (mod, attr, _) in wrappers.items()}
    for mod, attr, plain in wrappers.values():
        setattr(mod, attr, getattr(mod, plain))

    def undo():
        for name, (mod, attr, _) in wrappers.items():
            setattr(mod, attr, saved[name])
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


# the training paths: CLI flags, and the kernels that run a layer's two
# directions forward (and backward, with ``_bwd`` kernels)
MODEL_FLAGS = {
    'lgcn': ('--model', 'lgcn'),
    'gcn': ('--model', 'gcn', '--aggr', 'mean'),
    'graphsage': ('--model', 'graphsage', '--aggr', 'mean'),
    'gat': ('--model', 'gat', '--aggr', 'mean'),
    'gatv2': ('--model', 'gatv2', '--aggr', 'mean'),
}


def expected_launches(model: str, steps: int, evals: int) -> dict[str, int]:
    """Each kernel's launches in ``steps`` training steps and ``evals``
    evaluations: a layer runs both directions once forward and, in a step,
    once backward.  K1 serves as its own backward; the attention kernels
    have a backward kernel each; on the mesh path (``lgcn_mesh``) K2 takes
    K1's place."""
    per_pass = 2 * LAYERS
    want = dict.fromkeys(_wrappers(), 0)
    if model in ('lgcn', 'gcn', 'graphsage'):
        want['spmm_dropout'] = steps * 2 * per_pass + evals * per_pass
    elif model == 'lgcn_mesh':
        want['spmm_weighted'] = steps * 2 * per_pass + evals * per_pass
    else:
        want[f'{model}_fwd'] = steps * per_pass + evals * per_pass
        want[f'{model}_bwd'] = steps * per_pass
    return want


def train_phase(data_dir: str, model: str) -> dict:
    """S1 trained through the CLI for ``TRAIN_EPOCHS`` epochs, eval every
    epoch; the kernel launches of that run, read just after it."""
    flags = MODEL_FLAGS[model]
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
    want = expected_launches(model, steps * TRAIN_EPOCHS, TRAIN_EPOCHS)
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


def mesh_phase(data_dir: str, single, card: str, trace_dir: str,
               dev) -> dict:
    """``lgcn --mesh 1x1`` trained through the CLI against the single-card
    ``lgcn`` run ``single`` (phase 8), its ``best.pkl`` re-served through
    the non-mesh CLI, then ``--mesh 1x1`` serving in a group started here,
    and the timing of that trainer."""
    import torch.distributed as dist

    from textgcn_tpu_torch.parallel import multihost
    flags = MODEL_FLAGS['lgcn']
    common = ['--emb_size', str(D), '--n_layers', str(LAYERS),
              '--batch_size', str(BATCH), '-k', *map(str, KS)]
    argv = [*flags, '--epochs', str(TRAIN_EPOCHS), '--evaluate_every', '1',
            '--dropout', '0.4', *common, '--uid', 'train-lgcn-mesh',
            '--quiet', '--mesh', '1x1']
    reset_counts()
    t0 = time.perf_counter()
    trainer, run_dir = cli_run(data_dir, argv, 'cuda')
    seconds = time.perf_counter() - t0
    launches = counts()
    check(not dist.is_initialized(),
          'the CLI left its process group behind')
    steps = trainer.model.num_batches(BATCH)
    want = expected_launches('lgcn_mesh', steps * TRAIN_EPOCHS, TRAIN_EPOCHS)
    log(f'mesh lgcn 1x1: cli.main took {seconds:.3f} s; launches {launches}')
    check(launches == want, f'mesh lgcn: launches {launches}, expected '
          f'{want}')
    got = [h['loss'] for h in trainer.loss_history]
    ref = [h['loss'] for h in single.loss_history]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    log(f'mesh lgcn: loss sums {got} vs single card {ref} (largest relative '
        f'difference {rel:.3e})')
    check(len(got) == len(ref) and rel <= TOL,
          f'mesh lgcn loss sums {got} vs single card {ref}')
    rows = trainer.metrics_logger
    for name, v in rows.items():
        check(np.allclose(v, single.metrics_logger[name], atol=1e-6, rtol=0),
              f'mesh lgcn {name} by eval {v.tolist()} vs single card '
              f'{single.metrics_logger[name].tolist()}')
    best = best_row(rows['recall'][:, 0])
    served, _ = serve(data_dir, 'best-lgcn-mesh',
                      ['--load', run_dir, *common], 'cuda', model=flags)
    for name, v in served.last_metrics.items():
        check(np.allclose(v, rows[name][best], atol=1e-6, rtol=0),
              f'mesh best.pkl serves {name} {v} through the non-mesh CLI, '
              f'its epoch {best + 1} measured {rows[name][best]}')
    log(f'mesh lgcn: metrics equal the single card run\'s at every eval; '
        f'best.pkl (epoch {best + 1}) serves them through the non-mesh CLI')

    created = multihost.maybe_initialize(multihost.local_device(dev.type))
    try:
        reset_counts()
        mesh_served, serve_dir = serve(
            data_dir, 'serve-lgcn-mesh',
            ['--load', run_dir, '--predict', *common, '--mesh', '1x1'],
            'cuda', model=flags)
        serve_launches = counts()
        want = expected_launches('lgcn_mesh', 0, 2)
        check(serve_launches == want, f'mesh serving launched '
              f'{serve_launches}, expected {want}')
        for name, v in mesh_served.last_metrics.items():
            check(np.allclose(v, rows[name][best], atol=1e-6, rtol=0),
                  f'mesh serving {name} {v} vs {rows[name][best]}')
        preds = read_predictions(os.path.join(serve_dir, 'predictions.tsv'))
        check(len(preds) == S1_USERS
              and all(len(p[1]) == max(KS) for p in preds),
              'mesh predictions.tsv: one row of top-40 per user')
        log(f'mesh serve 1x1: launches {serve_launches}, metrics as trained')
        timing = timing_phase(mesh_served, card, trace_dir)
    finally:
        if created:
            dist.destroy_process_group()
    return {'launches': launches, 'serve_launches': serve_launches,
            'seconds': seconds, 'timing': timing}


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
        k2 = k2_phase(data, dev)
        log(f'phase K2 kernel: {time.perf_counter() - t:.3f} s')

        att = {}
        for conv in ('gat', 'gatv2'):
            t = time.perf_counter()
            att.update(attention_kernel_phase(data, dev, conv))
            log(f'phase {conv} kernel: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        labs = lab_phase(dev)
        log(f'phase labs: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        small_phase(root)
        log(f'phase small: {time.perf_counter() - t:.3f} s')

        t = time.perf_counter()
        launches = serve_phase(data_dir, ck)
        log(f'phase serve: {time.perf_counter() - t:.3f} s')

        trained, timing = {}, {}
        for model in MODEL_FLAGS:
            t = time.perf_counter()
            trained[model] = train_phase(data_dir, model)
            log(f'phase train {model}: {time.perf_counter() - t:.3f} s')
        t = time.perf_counter()
        mesh = mesh_phase(data_dir, trained['lgcn']['trainer'], card, root,
                          dev)
        timing['lgcn_mesh'] = mesh['timing']
        log(f'phase mesh: {time.perf_counter() - t:.3f} s')
        for model in MODEL_FLAGS:
            t = time.perf_counter()
            timing[model] = timing_phase(trained[model].pop('trainer'), card,
                                         root)
            log(f'phase timing {model}: {time.perf_counter() - t:.3f} s')

    # each path's launches, counted from 0 just before its run
    by_path = {'serve_lgcn': {'spmm_dropout': launches}}
    by_path.update({f'train_{m}': {k: n for k, n in r['launches'].items()
                                   if n}
                    for m, r in trained.items()})
    by_path['train_lgcn_mesh'] = {'spmm_weighted':
                                  mesh['launches']['spmm_weighted']}
    by_path['serve_lgcn_mesh'] = {'spmm_weighted':
                                  mesh['serve_launches']['spmm_weighted']}

    def launch_fields(name, model):
        paths = {p: c[name] for p, c in by_path.items() if name in c}
        return {'launches': sum(paths.values()),
                'launches_by_path': paths,
                'launches_per_step': {
                    part: timing[model]['launches_per_step'][part][name]
                    for part in ('forward', 'backward')}}

    kernels = [{
        'name': 'spmm_dropout',
        'route': 'cuda',
        'source': 'textgcn_tpu_torch/csrc/spmm_dropout.cu',
        'replaces': 'textgcn_tpu/ops/pallas_spmm.py:103',
        # serve lgcn, train lgcn, gcn and graphsage (forward and backward)
        **launch_fields('spmm_dropout', 'lgcn'),
        'max_abs_err': k1['max_abs_err'],
        'max_abs_err_by_width': k1['max_abs_err_by_width'],
        # times and bound: one layer, i.e. the to_user + to_item launches
        # at keep = 1 on S1, d = 64 (ms_keep_0_6: the same at keep 0.6)
        'ms': k1['ms'],
        'ms_keep_0_6': k1['ms_keep_0_6'],
        'plain_ms': k1['plain_ms'],
        'bound_ms': k1['bound_ms'],
        'bound_by': k1['bound_by'],
        'library_ms': k1['library_ms'],
    }, {
        'name': 'spmm_weighted',
        'route': 'cuda',
        'source': 'textgcn_tpu_torch/csrc/spmm_weighted.cu',
        'replaces': 'textgcn_tpu/ops/pallas_spmm.py:61',
        # train and serve lgcn --mesh 1x1 (forward and backward)
        **launch_fields('spmm_weighted', 'lgcn_mesh'),
        'max_abs_err': k2['max_abs_err'],
        'max_abs_err_4_shards_vs_k1': k2['max_abs_err_vs_k1'],
        # times and bound: one layer (to_user + to_item) on S1, d = 64, at
        # W = 1; the *_w4_per_shard keys: one layer of one shard at W = 4
        # (mean over the four), which reads a quarter of the edges and
        # writes the whole padded destination range
        'ms': k2['ms'],
        'plain_ms': k2['plain_ms'],
        'bound_ms': k2['bound_ms'],
        'bound_by': k2['bound_by'],
        'library_ms': k2['library_ms'],
        'ms_w4_per_shard': k2['ms_w4_per_shard'],
        'plain_ms_w4_per_shard': k2['plain_ms_w4_per_shard'],
        'bound_ms_w4_per_shard': k2['bound_ms_w4_per_shard'],
    }]
    for name, line in (('gat_fwd', 201), ('gat_bwd', 293),
                       ('gatv2_fwd', 647), ('gatv2_bwd', 715)):
        r = att[name]
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': f'textgcn_tpu_torch/csrc/{name}.cu',
            'replaces': f'textgcn_tpu/ops/pallas_gat.py:{line}',
            **launch_fields(name, name.split('_')[0]),
            'max_abs_err': r['max_abs_err'],
            'max_abs_err_by_output': r['max_abs_err_by_output'],
            **({'max_abs_err_by_width': r['max_abs_err_by_width']}
               if 'max_abs_err_by_width' in r else {}),
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
    for row, name, source, replaces, path in (
            ('L1', 'spmm_lab', 'spmm_lab.cu', 'tools/kernel_lab.py:129',
             'lab_kernel_lab'),
            ('L2', 'gather_rows', 'gather_lab.cu', 'tools/gather_lab.py:85',
             'lab_gather_lab'),
            ('L3', 'gather_rows_bulk', 'gather_lab.cu',
             'tools/gather_lab.py:150', 'lab_gather_lab')):
        r = labs[row]
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': f'textgcn_tpu_torch/csrc/{source}',
            'replaces': replaces,
            # all five L1 modes at bf16 and f32 x, or both gathers, run
            # through the lab entry points (python -m
            # textgcn_tpu_torch.tools.kernel_lab / gather_lab)
            'launches': r['launches'],
            'launches_by_path': {path: r['launches']},
            'max_abs_err': r['max_abs_err'],
            # L1: mode full, f32 x (the function torch.sparse.mm computes),
            # at the lab's full shape; L2/L3: the lab's gathers, whose
            # plain version is the one-call yardstick index_select
            **{k: v for k, v in r.items()
               if k not in ('launches', 'max_abs_err')},
        })
    steps = {m: {'step_ms': timing[m]['step'],
                 'examples_per_s': timing[m]['examples_per_s'],
                 'host_enqueue_share': timing[m]['host_enqueue_share'],
                 'device_ms_per_step': timing[m]['device'],
                 'device_busy_share': timing[m]['device_busy_share'],
                 'step_vs_plain_max_abs_err': trained.get(m, {}).get(
                     'step_err')}
             for m in timing}
    log(json.dumps({'training_at_s1': steps, 'card': card}))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
