"""The plain reference against the port's plain (CPU) path at a tiny
size, and the whole check of each cell on the CPU."""

import numpy as np
import pytest
import torch

from portbench import graphgen, harness
from portbench.reference import lightgcn as ref

DATASET = dict(n_users=120, n_items=200, n_interactions=2000,
               popularity_exponent=0.5, train_share=0.8, graph_seed=4)


def load(tmp_path):
    from textgcn_tpu_torch.data.core import load_interactions
    folder, inter, _ = graphgen.materialise(DATASET, str(tmp_path))
    return inter, load_interactions(folder)


def test_hash_matches_the_program():
    from textgcn_tpu_torch.ops.spmm import edge_dropout_scale
    gen = torch.Generator().manual_seed(0)
    u = torch.randint(0, 10**6, (5000,), generator=gen)
    i = torch.randint(0, 10**6, (5000,), generator=gen)
    for salt, keep in ((0, 1.0), (123456789, 0.6), (2**32 - 1, 0.3)):
        kept = ref.hash_kept(u, i, salt, keep)
        scale = edge_dropout_scale(u, i, salt, keep)
        assert torch.equal(kept, scale > 0)
        assert ref.inverse_keep(keep) == float(scale.max())


def test_numbering_and_graph_match_the_loader(tmp_path):
    inter, data = load(tmp_path)
    g = ref.RefGraph.build(inter.train_user, inter.train_item,
                           inter.n_users, inter.n_items, 'cpu')
    assert (g.n_users, g.n_items) == (data.n_users, data.n_items)
    users = [data.user_id_map[k] for k in range(data.n_users)]
    rows = g.user_of_generated[[int(u[1:]) for u in users]]
    np.testing.assert_array_equal(rows, np.arange(data.n_users))
    items = [data.item_id_map[k] for k in range(data.n_items)]
    rows = g.item_of_generated[[int(i[1:]) for i in items]]
    np.testing.assert_array_equal(rows, np.arange(data.n_items))
    deg = g.degree.numpy()
    np.testing.assert_array_equal(deg, data.pos_degree)
    for u in (0, 7, data.n_users - 1):
        np.testing.assert_array_equal(
            g.pos_items[g.pos_ptr[u]:g.pos_ptr[u + 1]].numpy(),
            data.pos_padded[u, :deg[u]])


@pytest.mark.parametrize('dropout', [0.0, 0.4])
def test_propagation_and_loss_match_the_program(tmp_path, dropout):
    from textgcn_tpu_torch.config import parse_args
    from textgcn_tpu_torch.models.lightgcn import LightGCN
    inter, data = load(tmp_path)
    cfg = parse_args(['--model', 'lgcn', '--dropout', str(dropout),
                      '--emb_size', '8'])
    model = LightGCN(cfg, data, device='cpu')
    g = ref.RefGraph.build(inter.train_user, inter.train_item,
                           inter.n_users, inter.n_items, 'cpu')
    salts = ((11, 0.6), (22, 0.6)) if dropout else None
    ur, ir = model.representation(training=bool(dropout), w_pairs=salts)
    tables = (model.user_emb.detach().double(),
              model.item_emb.detach().double())
    rr = ref.propagate(g, *tables, cfg.n_layers, salts)
    torch.testing.assert_close(ur.double(), rr[0], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(ir.double(), rr[1], rtol=1e-5, atol=1e-7)
    users = torch.tensor([0, 5, 9])
    pos = torch.from_numpy(data.pos_padded[[0, 5, 9], 0]).long()
    negs = torch.tensor([[3], [4], [6]])
    loss, _ = model.loss((users, pos, negs), w_pairs=salts or
                         ((0, 1.0), (0, 1.0)))
    want = ref.bpr_loss(rr, tables, users, pos, negs, cfg.reg_lambda)
    assert float(loss) == pytest.approx(float(want), rel=1e-5)


def test_adam_matches_torch():
    p = torch.randn(5, 3, dtype=torch.float64)
    q = p.clone().requires_grad_()
    opt = torch.optim.Adam([q], lr=1e-3)
    mine = ref.Adam([p], 1e-3)
    for k in range(3):
        g = torch.randn(5, 3, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(k))
        q.grad = g.clone()
        opt.step()
        mine.step([g])
    torch.testing.assert_close(p, q.detach(), rtol=1e-12, atol=1e-15)


def test_lower_precision_roundings():
    x = torch.tensor([1.0 + 2**-12, 3.0, -2.5 - 3 * 2**-11],
                     dtype=torch.float32)
    assert torch.equal(ref.tf32(x), torch.tensor([1.0, 3.0, -2.5 - 2**-9]))
    y = torch.tensor([[1.0, 0.5, -torch.inf, 0.013]])
    z = ref.fp8_rowwise(y)
    assert z[0, 0] == 1.0 and z[0, 2] == -torch.inf
    assert abs(float(z[0, 3]) - 0.013) / 0.013 < 0.07


@pytest.mark.parametrize('cell', ['lgcn-book.train', 'adv-book.train',
                                  'lgcn-book.serve',
                                  'lgcn-book.serve-approx'])
def test_cell_runs_and_is_correct_on_the_cpu(tmp_path, small, cell):
    r = harness.run(cell, 21, 0.3, False, device='cpu', overrides=small,
                    cache_dir=str(tmp_path))
    assert r['correct'], r['checks']
    assert r['attempted'] >= 1 and r['failed'] == 0
    assert list(r)[-1] == 'checks'
    assert 'setup_s' in r['metrics']


@pytest.mark.card
@pytest.mark.parametrize('cell', ['lgcn-book.train', 'adv-book.train',
                                  'lgcn-book.serve',
                                  'lgcn-book.serve-approx'])
def test_cell_is_correct_on_the_card(tmp_path, small, card, cell):
    """The same check with the program's CUDA kernels (K1) and a trace."""
    r = harness.run(cell, 22, 0.3, True, device=card, overrides=small,
                    cache_dir=str(tmp_path))
    assert r['correct'], r['checks']
    assert r['device']['busy_s'] > 0
