"""``gat`` on the CPU against the benchmark's plain reference
(``portbench/reference/gat.py``) on a small skewed graph, the spans the
conv path opens and K3's and K4's long-row counters.

The program runs ``ConvModel`` through the plain twins of K3 and K4
(``gat_att_plain``, ``gat_bwd_plain``) in float32; the reference runs in
float64 from the same tables, conv weights (drawn as the benchmark draws
them), batch and dropout salts.
"""

import ast
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from portbench import graphgen
from portbench.reference import gat as ref
from portbench.traffic.train_conv import draw_convs, leaves
from textgcn_tpu_torch.config import parse_args
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.models.conv import ConvModel, conv_layer
from textgcn_tpu_torch.ops import gat
from textgcn_tpu_torch.ops import spmm as tspmm
from textgcn_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a Chung-Lu draw as skewed as the benchmark's, at a size the CPU runs in
# a second: rows of up to ~200 edges against a mean of ~13
DATASET = dict(n_users=160, n_items=260, n_interactions=4000,
               popularity_exponent=0.9, train_share=0.8, graph_seed=7)
D, BATCH, LR = 16, 48, 1e-3
KEEP = float(np.float32(0.6))
SALTS = ((0x9E3779B9, KEEP), (123457, KEEP))


@pytest.fixture(scope='module')
def graph(tmp_path_factory):
    folder, inter, _ = graphgen.materialise(
        DATASET, str(tmp_path_factory.mktemp('gat_book')))
    g = ref.RefGraph.build(inter.train_user, inter.train_item,
                           inter.n_users, inter.n_items, 'cpu')
    return folder, load_interactions(folder), g


def program(graph, seed: int):
    """The program's ``gat`` with N(0, 0.1) tables and the benchmark's
    conv weights from ``seed``, its trainer, and the float64 copies of
    every leaf."""
    folder, data, _ = graph
    cfg = parse_args(['--model', 'gat', '--aggr', 'mean', '--data', folder,
                      '--emb_size', str(D), '--dropout', '0.4', '--lr',
                      str(LR), '--batch_size', str(BATCH)])
    model = ConvModel(cfg, data, device='cpu')
    gen = torch.Generator().manual_seed(seed)
    tables = (0.1 * torch.randn(data.n_users, D, generator=gen),
              0.1 * torch.randn(data.n_items, D, generator=gen))
    convs = draw_convs(seed, cfg.n_layers, D, 'cpu')
    model.load_params({'user_emb': tables[0], 'item_emb': tables[1],
                       'convs': convs})
    tables64 = [t.double().requires_grad_() for t in tables]
    convs64 = [{k: v.double().requires_grad_() for k, v in lp.items()}
               for lp in convs]
    return model, Trainer(cfg, model, data), tables64, convs64


def ref_leaves(tables, convs):
    return list(tables) + [lp[k] for lp in convs for k in ref.LEAVES]


def test_the_graph_is_skewed(graph):
    _, data, _ = graph
    assert max(data.pos_degree) > 8 * np.mean(data.pos_degree)


@pytest.mark.parametrize('salts', [SALTS, None], ids=['keep-0.6', 'keep-1'])
def test_each_layer_matches_the_reference(graph, salts):
    """Layer by layer in both directions, each side fed its own previous
    layer: float32 softmax sums of up to ~120 kept terms against float64
    agree to ~1e-7 of the rows' ~1 magnitude; 1e-5 relative and 1e-6
    absolute leave ten times that over three layers."""
    _, _, g = graph
    model, _, (u64, i64), convs64 = program(graph, 3)
    pairs = salts or ((0, 1.0), (0, 1.0))
    kept_u = ref.hash_kept(g.edge_user, g.edge_item, *pairs[0])
    kept_i = ref.hash_kept(g.edge_user, g.edge_item, *pairs[1])
    if salts:
        assert 0.5 < float(kept_u.double().mean()) < 0.7
    u, i = model.user_emb, model.item_emb
    with torch.no_grad():
        for lp, lp64 in zip(model.convs, convs64):
            u, i = conv_layer(lp, 'gat', 'mean', model.graph_op, u, i, pairs)
            u64, i64 = ref.layer(g, lp64, u64, i64, kept_u, kept_i)
            torch.testing.assert_close(u.double(), u64, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(i.double(), i64, rtol=1e-5, atol=1e-6)


def test_loss_gradients_and_adam_step_match_the_reference(graph):
    """One training step of the program's trainer against the reference:
    the loss to 1e-5 relative (a float32 mean of ~100 BPR terms over
    float32 layers); every one of the 14 leaves' gradients to 1e-4 of its
    largest entry (float32 sums through three softmax layers and back,
    each a few ulps of ~1e-7); both tables after Adam's first step to
    1e-3 of ``lr`` (that step moves an entry by ``lr * g / (|g| + eps)``:
    where ``|g|`` is within a few ``eps``, a gradient's float32 error of
    ~1e-12 moves it by up to ~1e-4 of ``lr``)."""
    _, data, g = graph
    model, trainer, tables, convs = program(graph, 5)
    batch = model.sample_batches(trainer.generator, BATCH)[0]
    users, pos, negs = batch
    loss, _ = trainer.train_step(batch, SALTS)
    want = ref.loss(g, tables, convs, SALTS, users, pos, negs,
                    model.reg_lambda)
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-5)
    got = leaves(model)
    params = ref_leaves(tables, convs)
    assert len(got) == len(params) == 2 + 4 * 3
    grads = torch.autograd.grad(want, params)
    for p, g64 in zip(got, grads):
        assert p.grad is not None and p.grad.shape == g64.shape
        scale = float(g64.abs().max())
        assert scale > 0
        torch.testing.assert_close(p.grad.double(), g64, rtol=0,
                                   atol=1e-4 * scale)
    adam = ref.Adam(params, LR)
    adam.step(grads)
    for p, p64 in zip(got[:2], params[:2]):
        torch.testing.assert_close(p.detach().double(), p64.detach(),
                                   rtol=0, atol=1e-3 * LR)


def test_the_reference_imports_neither_jax_nor_the_program():
    """``reference/gat.py`` and the module it takes the graph, hash, loss
    and Adam from import no JAX and nothing of either package."""
    banned = {'jax', 'jaxlib', 'flax', 'textgcn_tpu', 'textgcn_tpu_torch'}
    for name in ('gat.py', 'lightgcn.py'):
        path = os.path.join(REPO, 'portbench', 'reference', name)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ''] if not node.level else []
            else:
                continue
            assert not {m.split('.')[0] for m in mods} & banned, (name, mods)


def recorded(fn):
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id(), list(e.concrete_inputs()))
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def inside(span, parents):
    return any(p[1] <= span[1] and span[2] <= p[2] and p[3] == span[3]
               for p in parents)


def test_a_gat_step_opens_the_conv_spans(graph):
    """``conv.layer`` a layer with its index, ``conv.attention`` a
    direction inside it, ``conv.attention.backward`` a direction inside
    ``train.backward``."""
    model, trainer, _, _ = program(graph, 7)
    batch = model.sample_batches(trainer.generator, BATCH)[0]
    spans = recorded(lambda: trainer.epoch_step(0, batch))
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    assert [s[4] for s in by['conv.layer']] == [[0], [1], [2]]
    assert all(inside(s, by['train.forward']) for s in by['conv.layer'])
    assert len(by['conv.attention']) == 6
    assert all(inside(s, by['conv.layer']) for s in by['conv.attention'])
    assert len(by['conv.attention.backward']) == 6
    assert all(inside(s, by['train.backward'])
               for s in by['conv.attention.backward'])


def test_long_row_launches_count_csrs_with_a_row_over_the_split_length(
        monkeypatch):
    """K3's and K4's wrappers count a launch over a CSR holding a row
    longer than ``SPLIT_LEN`` in ``.long_row_launches`` and every launch
    in ``.launches``; the launch itself is intercepted, so the wrappers
    run on CPU tensors up to it."""
    seen = []
    monkeypatch.setattr(gat, '_check_cuda', lambda *a: None)
    monkeypatch.setattr(gat, '_kernel_fn',
                        lambda *a, **k: lambda *args: seen.append(args) or 0)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    rng = np.random.RandomState(0)
    n_users, n_items = 20, 400
    heavy = tspmm.SPLIT_LEN + 1         # user 0's row, and no item's
    eu = np.concatenate([np.zeros(heavy, np.int64),
                         rng.randint(1, n_users, 300)])
    ei = np.concatenate([np.arange(heavy), rng.randint(0, n_items, 300)])
    pairs = np.unique(np.stack([eu, ei], 1), axis=0)
    op = tspmm.GraphOp(pairs[:, 0], pairs[:, 1], np.ones(len(pairs),
                                                        np.float32),
                       n_users, n_items, 'cpu')
    assert op.l_i2u.split_rows == 1 and op.l_u2i.split_rows == 0
    before = [(f.launches, f.long_row_launches)
              for f in (gat.gat_fwd_cuda, gat.gat_bwd_cuda)]
    try:
        for direction in ('to_user', 'to_item'):
            fwd, bwd = op.csr_pair(direction)
            h, s = torch.randn(fwd.n_src, D), torch.randn(fwd.n_src)
            d, m = torch.randn(fwd.n_dst), torch.randn(fwd.n_dst)
            gat.gat_fwd_cuda(fwd, h, s, d, 5, KEEP)
            gat.gat_bwd_cuda(bwd, h, s, d, m, torch.randn(fwd.n_dst, D),
                             torch.randn(fwd.n_dst), 5, KEEP)
        # to_user: K3 on the heavy CSR; to_item: K4 on its transpose
        assert len(seen) == 4
        for f, (n0, long0) in zip((gat.gat_fwd_cuda, gat.gat_bwd_cuda),
                                  before):
            assert (f.launches - n0, f.long_row_launches - long0) == (2, 1)
    finally:
        for f, (n0, long0) in zip((gat.gat_fwd_cuda, gat.gat_bwd_cuda),
                                  before):
            f.launches, f.long_row_launches = n0, long0
