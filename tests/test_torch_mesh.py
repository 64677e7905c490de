"""The port's mesh path (``--mesh``, ``textgcn_tpu_torch/parallel/``)
against the JAX package's, on the CPU.

Ranks are gloo processes started with ``torch.multiprocessing`` over a
``file://`` store (no port to clash on), once at W = 2 and once at W = 4;
each runs ``tests/helpers/torch_mesh_worker.py`` and writes what it found.
The JAX side runs here, in the parent: ``MeshPallasGraphOp(...,
interpret=True, x_dtype=float32)`` on a CPU mesh of the same size, under
``jax.jit``, with conftest's float32 reduce-scatter payloads.  Both sides
take the same tables, batches and dropout salts, made here with numpy.

Tolerances: K2's plain version and the representation 1e-5 (f32 sums of a
few terms in another order), gradients and the step 1e-4 (three layers
forward and back), the top-k values 1e-6 (the same f32 dot products);
the CLI run's loss sums 1e-5 relative and its metrics 1e-6 against the
single-process port.
"""

import dataclasses
import os
import pickle
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from helpers.torch_native import ensure_jax_native
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu import native
from textgcn_tpu.config import Config as JaxConfig
from textgcn_tpu.data.core import load_interactions as jax_load
from textgcn_tpu.models.lightgcn import LightGCN as JaxLightGCN
from textgcn_tpu.ops.pallas_spmm import PallasDirection
from textgcn_tpu.ops.propagate import representation as jax_representation
from textgcn_tpu.parallel.mesh import _auto_shape, make_mesh as jax_mesh
from textgcn_tpu.parallel.pallas_sharded import MeshPallasGraphOp
from textgcn_tpu.parallel.sharded import sharded_topk as jax_sharded_topk
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.ops.spmm import (_edges, build_csr, spmm_weighted,
                                        spmm_weighted_cuda,
                                        spmm_weighted_plain)
from textgcn_tpu_torch.parallel import mesh as tmesh
from textgcn_tpu_torch.parallel import multihost

HELPERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'helpers')
SALT = 0x9E3779B9                      # high bit set
KEEP = float(np.float32(1.0 - 0.4))
PAIRS = ((SALT, KEEP), (SALT ^ 0x5A5A5A5A, KEEP))
PAD = 16          # dummy's 12 users and 10 items, padded for W = 2 and 4
D = 8
SPAWN_TIMEOUT = 240


# --- the ranks --------------------------------------------------------------

def _inputs(dummy_dir):
    rng = np.random.RandomState(11)

    def table(n_real, n, d):
        t = np.zeros((n, d), np.float32)
        t[:n_real] = rng.randn(n_real, d)
        return t

    data = load_interactions(dummy_dir)
    nu, ni = data.n_users, data.n_items
    b = 13
    users = rng.randint(0, nu, b)
    pos = np.array([data.pos_padded[u][rng.randint(data.pos_degree[u])]
                    for u in users])

    def topk_case(n_items, width):
        pos = np.full((16, width), n_items, np.int32)
        for r in range(16):
            k = rng.randint(0, width + 1)
            pos[r, :k] = np.sort(rng.choice(n_items, k, replace=False))
        return {'users': rng.randn(16, D).astype(np.float32),
                'items': table(n_items, 40, D), 'pos': pos, 'k': 9,
                'n_valid': n_items}

    return {
        'dummy': dummy_dir, 'pad': PAD, 'pairs': PAIRS,
        'tables': {'user_emb': table(nu, PAD, D),
                   'item_emb': table(ni, PAD, D)},
        'cot_u': rng.randn(PAD, D).astype(np.float32),
        'cot_i': rng.randn(PAD, D).astype(np.float32),
        # 37 real items: the last shard pads 2 of its 9 candidates; 22:
        # shards of 10, 10, 2 and 0 real items, and up to 16 of them masked
        'topk': [topk_case(37, 6), topk_case(22, 16)],
        'step': {'d': D, 'reg': 1e-3,
                 'params': {'user_emb': (0.1 * rng.randn(nu, D)).astype(
                     np.float32),
                     'item_emb': (0.1 * rng.randn(ni, D)).astype(
                         np.float32)},
                 'batch': (users, pos, rng.randint(0, ni, (b, 2)))},
        'cli_argv': ['--model', 'lgcn', '--data', dummy_dir, '--epochs', '4',
                     '--evaluate_every', '2', '--batch_size', '16',
                     '--emb_size', '16', '-k', '3', '5', '--quiet',
                     '--predict'],
    }


def _join(contexts, timeout):
    deadline = time.monotonic() + timeout
    try:
        for ctx in contexts:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f'mesh ranks still running after '
                                       f'{timeout} s')
    finally:
        for ctx in contexts:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, dummy_dir):
    """``{W: [rank 0's results, rank 1's, ...]}`` for W = 2 and 4, with the
    inputs under ``'inputs'`` and the W = 4 directory under ``'dir4'``."""
    sys.path.insert(0, HELPERS)
    import torch_mesh_worker
    ensure_jax_native(native)
    inp = _inputs(dummy_dir)
    dirs = {w: tmp_path_factory.mktemp(f'mesh{w}') for w in (2, 4)}
    for d in dirs.values():
        with open(d / 'inputs.pkl', 'wb') as f:
            pickle.dump(inp, f)
    contexts = [mp.start_processes(torch_mesh_worker.run,
                                   args=(w, str(d)), nprocs=w, join=False,
                                   start_method='spawn')
                for w, d in dirs.items()]
    _join(contexts, SPAWN_TIMEOUT)
    out = {'inputs': inp, 'dir4': dirs[4]}
    for w, d in dirs.items():
        out[w] = []
        for r in range(w):
            with open(d / f'rank{r}.pkl', 'rb') as f:
                out[w].append(pickle.load(f))
    return out


def _jax_pairs():
    return tuple((jnp.uint32(s), jnp.float32(k)) for s, k in PAIRS)


def _jax_mesh_op(graph, n_ranks, pad, d):
    # at W = 4 a source split has no edges, which only the native layout
    # builder lays out
    ensure_jax_native(native)
    op = MeshPallasGraphOp(graph.edge_user, graph.edge_item,
                           graph.edge_weight, pad, pad, d,
                           jax_mesh((1, n_ranks)), interpret=True,
                           x_dtype=jnp.float32)
    op.weights = lambda key, dropout: _jax_pairs()
    return op


# --- (a) K2's plain version against the TPU kernel --------------------------

@pytest.mark.parametrize('graph', ['dummy', 'random'])
def test_spmm_weighted_plain_matches_pallas_spmm(dummy_dir, graph):
    rng = np.random.RandomState(4)
    if graph == 'dummy':
        g = load_interactions(dummy_dir).graph
        src, dst, n_src, n_dst = g.edge_item, g.edge_user, g.n_items, \
            g.n_users
    else:
        n_src, n_dst = 700, 300
        pairs = np.unique(np.stack([rng.randint(0, n_src, 3000),
                                    rng.randint(0, n_dst, 3000)], 1), axis=0)
        src, dst = pairs[:, 0], pairs[:, 1]
    dense_w = rng.rand(n_src, n_dst).astype(np.float32) - 0.5
    x = rng.randn(n_src, D).astype(np.float32)
    direction = PallasDirection(src, dst, np.zeros(len(src), np.float32),
                                n_src, n_dst)
    ids_ok = direction.src_ids >= 0
    w_layout = np.where(ids_ok, dense_w[np.where(ids_ok, direction.src_ids, 0),
                                        np.where(ids_ok, direction.dst_ids,
                                                 0)], 0.0)
    x_pad = np.zeros((direction.n_src_padded, D), np.float32)
    x_pad[:n_src] = x
    want = direction(jnp.asarray(x_pad), w=jnp.asarray(w_layout,
                                                       jnp.float32),
                     interpret=True)
    csr = build_csr(dst, src, np.zeros(len(src)), n_dst, n_src, True, 'cpu')
    rows, col, _, _ = _edges(csr)
    w = torch.from_numpy(dense_w[col.numpy(), rows.numpy()])
    got = spmm_weighted_plain(csr, w, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(spmm_weighted(csr, w, torch.from_numpy(x)), got)
    assert spmm_weighted_cuda.launches == 0


def test_spmm_weighted_refuses_what_the_kernel_does_not_take(dummy_dir):
    g = load_interactions(dummy_dir).graph
    csr = build_csr(g.edge_user, g.edge_item, g.edge_weight, g.n_users,
                    g.n_items, True, 'cpu')
    x = torch.zeros(g.n_items, 4)
    with pytest.raises(ValueError, match='needs CUDA tensors'):
        spmm_weighted_cuda(csr, csr.w, x)
    with pytest.raises(ValueError, match='w must be float32'):
        spmm_weighted_plain(csr, csr.w[:-1], x)
    with pytest.raises(ValueError, match='no SpMM for device'):
        spmm_weighted(csr, csr.w, x.to('meta'))


# --- (b) the sharded propagation --------------------------------------------

@pytest.mark.parametrize('n_ranks', [2, 4])
def test_mesh_graph_op_matches_jax(ranks, dummy_dir, n_ranks):
    """3-layer representation at keep 0.6 (1e-5) and the gradients of a
    weighted sum of it (1e-4) against ``MeshPallasGraphOp`` on a JAX mesh
    of the same size."""
    inp = ranks['inputs']
    op = _jax_mesh_op(jax_load(dummy_dir).graph, n_ranks, PAD, D)
    cu, ci = jnp.asarray(inp['cot_u']), jnp.asarray(inp['cot_i'])

    def f(p):
        u, i = jax_representation(p, op, 3, single=False, dropout=0.4,
                                  dropout_key=jax.random.key(0))
        return (u * cu).sum() + (i * ci).sum(), (u, i)

    params = jax.tree.map(jnp.asarray, inp['tables'])
    (_, (u, i)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    for got in ranks[n_ranks]:
        got = got['graph_op']
        np.testing.assert_allclose(got['u'], np.asarray(u), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got['i'], np.asarray(i), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got['du'], np.asarray(grads['user_emb']),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got['di'], np.asarray(grads['item_emb']),
                                   atol=1e-4, rtol=1e-4)
        # TEXTGCN_TPU_RS_DTYPE=bf16 rounds each layer's partial sums to
        # bfloat16 (8 bits): within 2% of the largest entry, and not f32
        scale = np.abs(np.asarray(u)).max()
        np.testing.assert_allclose(got['u_bf16'], np.asarray(u),
                                   atol=0.02 * scale, rtol=0)
        assert not np.array_equal(got['u_bf16'], got['u'])


# --- (c) the catalogue-sharded top-k ------------------------------------------

@pytest.mark.parametrize('case', [0, 1], ids=['37_items', '22_items'])
def test_sharded_topk_matches_jax(ranks, case):
    """Values 1e-6, indices where the values are distinct and finite.  A
    shard with fewer real columns than k pads its candidates with -inf at
    an id past every real item; at equal values the merge prefers real
    (masked) items, so no padding id is ever returned."""
    t = ranks['inputs']['topk'][case]
    want_v, want_i = jax_sharded_topk(
        jax_mesh((1, 4)), jnp.asarray(t['users']), jnp.asarray(t['items']),
        jnp.asarray(t['pos']), t['k'], n_valid=t['n_valid'])
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    assert np.isinf(want_v).any() == (case == 1)
    for got in ranks[4]:
        got = got['topk'][case]
        np.testing.assert_allclose(got['vals'], want_v, atol=1e-6, rtol=0)
        distinct = np.array([[np.isfinite(v) and np.sum(row == v) == 1
                              for v in row] for row in want_v])
        assert (got['idx'][distinct] == want_i[distinct]).all()
        assert (got['idx'] < t['n_valid']).all()
        assert all(len(set(row)) == len(row) for row in got['idx'].tolist())


def test_sharded_topk_on_one_rank_is_score_and_topk():
    from textgcn_tpu_torch.ops.retrieval import score_and_topk
    from textgcn_tpu_torch.parallel.sharded import sharded_topk
    assert not dist.is_initialized()
    rng = np.random.RandomState(8)
    items = torch.from_numpy(rng.randn(30, D).astype(np.float32))
    users = torch.from_numpy(rng.randn(5, D).astype(np.float32))
    pos = torch.tensor([[0, 3, 29, 30], [30] * 4, [1, 2, 30, 30],
                        [4, 5, 6, 7], [10, 30, 30, 30]], dtype=torch.int32)
    mesh, created = tmesh.make_mesh((1, 1), 'cpu')
    try:
        vals, idx = sharded_topk(mesh, users, items, pos, 6, 30)
    finally:
        if created:
            dist.destroy_process_group()
    want_v, want_i = score_and_topk(users, items, pos, k=6, n_items=30)
    assert torch.equal(vals, want_v) and torch.equal(idx, want_i)


# --- (d) one lgcn step --------------------------------------------------------

def test_one_lgcn_step_on_a_mesh_matches_jax(ranks, dummy_dir):
    inp = ranks['inputs']
    s = inp['step']
    cfg = JaxConfig(model='lgcn', data=dummy_dir, emb_size=D,
                    reg_lambda=s['reg'], dropout=0.4, n_layers=3,
                    save_path='/nonexistent').finalize()
    jm = JaxLightGCN(cfg, jax_load(dummy_dir).padded_to(PAD))
    assert (jm.n_users_t, jm.n_items_t) == (PAD, PAD)
    jm.graph_op = _jax_mesh_op(jax_load(dummy_dir).graph, 4, PAD, D)
    params = {}
    for name, v in s['params'].items():
        t = np.zeros((PAD, D), np.float32)
        t[:len(v)] = v
        params[name] = jnp.asarray(t)
    users, pos, negs = (jnp.asarray(a, jnp.int32) for a in s['batch'])
    batch = (users, pos, negs, jnp.ones(users.shape[0], bool))
    (loss, aux), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch, jax.random.key(0))
    want = np.array([float(loss), float(aux['bpr']), float(aux['reg'])])
    for got in ranks[4]:
        got = got['step']
        np.testing.assert_allclose(got['loss'], want, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got['du'], np.asarray(grads['user_emb']),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got['di'], np.asarray(grads['item_emb']),
                                   atol=1e-4, rtol=1e-4)


# --- (e) the CLI on four ranks -----------------------------------------------

def test_mesh_cli_matches_the_single_process_run(ranks, tmp_path,
                                                 monkeypatch):
    """``--mesh 2x2`` in 4 gloo ranks against the port's single-process
    run with the same seed: loss sums 1e-5 relative, metrics 1e-6; rank 0
    alone wrote files, and its ``best.pkl`` serves through the non-mesh
    CLI with the metrics of its epoch."""
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    argv = ranks['inputs']['cli_argv']
    single = port_main(argv + ['--uid', 'single'])
    want_loss = [h['loss'] for h in single.loss_history]
    for got in ranks[4]:
        got = got['cli']
        np.testing.assert_allclose([h['loss'] for h in got['loss_history']],
                                   want_loss, rtol=1e-5, atol=0)
        for name, v in single.last_metrics.items():
            np.testing.assert_allclose(got['metrics'][name], v, atol=1e-6,
                                       rtol=0)
    run = ranks['dir4'] / 'cwd0' / 'runs' / 'dummy' / 'mesh'
    assert sorted(p.name for p in run.iterdir()) == sorted(
        p.name for p in (tmp_path / 'runs' / 'dummy' / 'single').iterdir())
    for r in (1, 2, 3):
        assert not (ranks['dir4'] / f'cwd{r}' / 'runs').exists()
    served = port_main(['--model', 'lgcn', '--data',
                        ranks['inputs']['dummy'], '--emb_size',
                        '16', '-k', '3', '5', '--quiet', '--no_train',
                        '--load', str(run), '--uid', 'served'])
    logger = ranks[4][0]['cli']['metrics_logger']
    best = max(i for i, v in enumerate(logger['recall'][:, 0])
               if v >= logger['recall'][:, 0].max())
    for name, v in served.last_metrics.items():
        np.testing.assert_allclose(v, logger[name][best], atol=1e-6, rtol=0)


def test_mesh_1x1_in_process_equals_the_single_card_run(tmp_path,
                                                        monkeypatch,
                                                        dummy_dir):
    """Without torchrun, ``--mesh 1x1`` and ``--mesh auto`` start a
    one-rank group in-process and destroy it on return; K2 over the whole
    graph then adds in K1's order, so the run repeats the single one."""
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    common = ['--model', 'lgcn', '--data', dummy_dir, '--epochs', '2',
              '--batch_size', '16', '--emb_size', '16', '-k', '3',
              '--quiet', '--evaluate_every', '1']
    single = port_main(common + ['--uid', 'single'])
    for shape in ('1x1', 'auto'):
        mesh = port_main(common + ['--uid', shape, '--mesh', shape])
        assert not dist.is_initialized()
        assert mesh.model.mesh.shape == (1, 1)
        np.testing.assert_allclose(
            [h['loss'] for h in mesh.loss_history],
            [h['loss'] for h in single.loss_history], rtol=1e-6)
        for name, v in single.last_metrics.items():
            np.testing.assert_allclose(mesh.last_metrics[name], v,
                                       atol=1e-6, rtol=0)


# --- (f) refusals -------------------------------------------------------------

def test_a_mesh_of_another_size_than_the_group_is_refused(ranks):
    for got in ranks[4]:
        assert 'WORLD_SIZE=4' in got['cli']['refusal']


@pytest.mark.parametrize('argv, err', [
    (['--model', 'marcus', '--mesh', 'autox'], ValueError),
    (['--model', 'lgcn', '--mesh', '2by2'], ValueError),
    (['--model', 'lgcn', '--mesh', '0x4'], ValueError),
    # a recall target outside [0, 1), with or without a mesh
    (['--model', 'gbdt', '--mesh', '2x2', '--approx_topk', '1.0'],
     ValueError),
    (['--model', 'lgcn', '--mesh', '2x2', '--approx_topk', '-0.5'],
     ValueError),
])
def test_mesh_flags_that_are_refused(argv, err):
    with pytest.raises(err):
        tconfig.parse_args(argv)


@pytest.mark.parametrize('argv', [
    ['--model', 'gbdt', '--mesh', '2x2', '--approx_topk', '0.9'],
    ['--model', 'lgcn', '--mesh', '2x2', '--approx_topk', '0.9'],
])
def test_mesh_takes_serving_mode(argv):
    """Refused until the port served in bfloat16; now as the JAX package
    parses it."""
    from textgcn_tpu.config import parse_args as jax_parse
    argv = argv + ['--uid', 'same']
    cfg = tconfig.parse_args(argv)
    assert cfg.approx_topk == 0.9 and cfg.mesh_shape == (2, 2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_parse(argv))


def test_a_mesh_is_refused_without_its_ranks(tmp_path, monkeypatch,
                                             dummy_dir):
    from textgcn_tpu_torch.cli import main as port_main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    argv = ['--model', 'lgcn', '--data', dummy_dir, '--quiet']
    with pytest.raises(RuntimeError, match='torchrun --nproc_per_node 4'):
        port_main(argv + ['--mesh', '2x2'])
    monkeypatch.setenv('RANK', '0')
    with pytest.raises(RuntimeError, match='incomplete torchrun'):
        port_main(argv + ['--mesh', '1x1'])
    assert not dist.is_initialized()


def test_mesh_on_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA device'):
        multihost.local_device('cuda')


# --- helpers of the mesh ------------------------------------------------------

@pytest.mark.parametrize('n', [1, 2, 4, 8, 9, 12, 16])
def test_auto_shape_matches_jax(n):
    assert tmesh.auto_shape(n) == _auto_shape(n)


def test_collective_dtype(monkeypatch):
    monkeypatch.delenv(tmesh.RS_DTYPE_ENV, raising=False)
    assert tmesh.collective_dtype() == torch.float32
    monkeypatch.setenv(tmesh.RS_DTYPE_ENV, 'bf16')
    assert tmesh.collective_dtype() == torch.bfloat16
    monkeypatch.setenv(tmesh.RS_DTYPE_ENV, 'fp8')
    with pytest.raises(ValueError):
        tmesh.collective_dtype()


@pytest.mark.parametrize('multiple', [1, 4, 8])
def test_padded_to_matches_jax(dummy_dir, multiple):
    a = jax_load(dummy_dir).padded_to(multiple)
    b = load_interactions(dummy_dir).padded_to(multiple)
    assert (a.n_users_padded, a.n_items_padded) == (b.n_users_padded,
                                                    b.n_items_padded)
    assert (b.n_users, b.n_items) == (a.n_users, a.n_items)


def test_mesh_rows_split_the_padded_table():
    meshes = [tmesh.Mesh((2, 2), r, torch.device('cpu')) for r in range(4)]
    assert [m.rows(16) for m in meshes] == [slice(0, 4), slice(4, 8),
                                            slice(8, 12), slice(12, 16)]
    with pytest.raises(ValueError):
        meshes[0].rows(10)
