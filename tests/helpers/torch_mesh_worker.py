"""One rank of the port's mesh checks in ``tests/test_torch_mesh.py``.

Started by ``torch.multiprocessing`` (spawn) with ``run(rank, world,
work_dir)``: joins a gloo group over a ``file://`` store in ``work_dir``,
reads ``work_dir/inputs.pkl`` (made by the test with numpy), runs the
port's mesh path on the CPU and writes what it found to
``work_dir/rank<r>.pkl``.  Imports torch and the port only.
"""

import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _gather(t: torch.Tensor) -> np.ndarray:
    """Every rank's rows of ``t``, in rank order (no autograd)."""
    out = torch.empty((dist.get_world_size() * t.shape[0], *t.shape[1:]),
                      dtype=t.dtype)
    dist.all_gather_into_tensor(out, t.detach().contiguous())
    return out.numpy()


def graph_op_check(inp, mesh):
    """3-layer representation at keep 0.6 and the gradients of
    ``sum(u * cot_u) + sum(i * cot_i)``, gathered."""
    from textgcn_tpu_torch.data.core import load_interactions
    from textgcn_tpu_torch.ops.propagate import representation
    from textgcn_tpu_torch.parallel.sharded_spmm import MeshGraphOp
    g = load_interactions(inp['dummy']).graph
    pad = inp['pad']
    op = MeshGraphOp(g.edge_user, g.edge_item, g.edge_weight, pad, pad,
                     mesh)
    rows = mesh.rows(pad)
    u0 = torch.from_numpy(inp['tables']['user_emb'][rows]).requires_grad_()
    i0 = torch.from_numpy(inp['tables']['item_emb'][rows]).requires_grad_()
    u, i = representation(u0, i0, op, 3, single=False,
                          w_pairs=inp['pairs'])
    loss = ((u * torch.from_numpy(inp['cot_u'][rows])).sum()
            + (i * torch.from_numpy(inp['cot_i'][rows])).sum())
    loss.backward()
    out = {'u': _gather(u), 'i': _gather(i), 'du': _gather(u0.grad),
           'di': _gather(i0.grad)}
    # the bfloat16 reduce-scatter payloads of TEXTGCN_TPU_RS_DTYPE=bf16
    saved = os.environ.get('TEXTGCN_TPU_RS_DTYPE')
    os.environ['TEXTGCN_TPU_RS_DTYPE'] = 'bf16'
    try:
        op = MeshGraphOp(g.edge_user, g.edge_item, g.edge_weight, pad, pad,
                         mesh)
    finally:
        if saved is None:
            del os.environ['TEXTGCN_TPU_RS_DTYPE']
        else:
            os.environ['TEXTGCN_TPU_RS_DTYPE'] = saved
    with torch.no_grad():
        u, _ = representation(u0, i0, op, 3, single=False,
                              w_pairs=inp['pairs'])
    out['u_bf16'] = _gather(u)
    return out


def topk_check(inp, mesh):
    from textgcn_tpu_torch.parallel.sharded import sharded_topk
    out = []
    for t in inp['topk']:
        items = torch.from_numpy(t['items'])
        rows = mesh.rows(items.shape[0])
        vals, idx = sharded_topk(mesh, torch.from_numpy(t['users']),
                                 items[rows], torch.from_numpy(t['pos']),
                                 t['k'], t['n_valid'])
        out.append({'vals': vals.numpy(), 'idx': idx.numpy()})
    return out


def step_check(inp, mesh):
    """One ``lgcn`` loss and its gradients at the injected salts."""
    from textgcn_tpu_torch import config
    from textgcn_tpu_torch.data.core import load_interactions
    from textgcn_tpu_torch.models.lightgcn import LightGCN
    from textgcn_tpu_torch.parallel.mesh import shard_model
    s = inp['step']
    data = load_interactions(inp['dummy']).padded_to(inp['pad'])
    cfg = config.Config(model='lgcn', data=inp['dummy'], emb_size=s['d'],
                        reg_lambda=s['reg'], dropout=0.4, n_layers=3,
                        save=False, k=(3,),
                        save_path='/nonexistent').finalize()
    model = shard_model(mesh, LightGCN(cfg, data, device='cpu'), data)
    model.load_params({k: torch.from_numpy(v) for k, v in
                       s['params'].items()})
    batch = tuple(torch.from_numpy(a) for a in s['batch'])
    loss, aux = model.loss(batch, w_pairs=inp['pairs'])
    loss.backward()
    summed = torch.stack([loss, aux['bpr'], aux['reg']]).detach()
    dist.all_reduce(summed)
    return {'loss': summed.numpy(), 'du': _gather(model.user_emb.grad),
            'di': _gather(model.item_emb.grad)}


def cli_check(inp, mesh_shape, rank, work_dir):
    """``--mesh`` through the CLI from a directory of this rank's own."""
    from textgcn_tpu_torch import cli
    cwd = os.path.join(work_dir, f'cwd{rank}')
    os.makedirs(cwd)
    os.chdir(cwd)
    trainer = cli.main([*inp['cli_argv'], '--mesh', mesh_shape,
                        '--uid', 'mesh'])
    out = {'loss_history': trainer.loss_history,
           'metrics': trainer.last_metrics,
           'metrics_logger': trainer.metrics_logger}
    # a mesh of another size than the group's is refused on every rank
    try:
        cli.main([*inp['cli_argv'], '--mesh', '1x2', '--uid', 'refused'])
    except ValueError as e:
        out['refusal'] = str(e)
    return out


def run(rank: int, world: int, work_dir: str):
    os.environ['TEXTGCN_TPU_PLATFORM'] = 'cpu'
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{work_dir}/store',
                            rank=rank, world_size=world)
    try:
        from textgcn_tpu_torch.parallel.mesh import Mesh
        with open(os.path.join(work_dir, 'inputs.pkl'), 'rb') as f:
            inp = pickle.load(f)
        mesh = Mesh((1, world), rank, torch.device('cpu'))
        out = {'graph_op': graph_op_check(inp, mesh)}
        if world == 4:
            out['topk'] = topk_check(inp, mesh)
            out['step'] = step_check(inp, mesh)
            out['cli'] = cli_check(inp, '2x2', rank, work_dir)
        with open(os.path.join(work_dir, f'rank{rank}.pkl'), 'wb') as f:
            pickle.dump(out, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
