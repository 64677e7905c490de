"""One rank of the port's mesh checks of the conv family, the LTR heads,
``adv_sampling``, the text-loss, concat and probe models and the boosted
heads (``tests/test_torch_mesh_conv.py``, ``tests/test_torch_mesh_ltr.py``,
``tests/test_torch_mesh_adv.py``, ``tests/test_torch_mesh_text.py``,
``tests/test_torch_mesh_boosted.py``), and of serving mode on a mesh
(``tests/test_torch_approx.py``).

Started by ``torch.multiprocessing`` (spawn) with ``run(rank, world,
work_dir)``: joins a gloo group over a ``file://`` store in ``work_dir``,
reads ``work_dir/inputs.pkl`` (made by the test with numpy; ``kind`` is
``'conv'``, ``'ltr'``, ``'adv'``, ``'text'``, ``'boosted'`` or
``'approx'``), runs the
port's mesh path on the CPU, on one torch thread, and writes what it
found to ``work_dir/rank<r>.pkl``.  Imports torch and the port only.
"""

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _gather(t: torch.Tensor, n: int) -> np.ndarray:
    """The first ``n`` rows of every rank's rows of ``t`` (no autograd)."""
    t = t.detach().contiguous()
    out = torch.empty((dist.get_world_size() * t.shape[0], *t.shape[1:]),
                      dtype=t.dtype)
    dist.all_gather_into_tensor(out, t)
    return out[:n].numpy()


def _summed(x: torch.Tensor) -> float:
    x = x.detach().reshape(1).clone()
    dist.all_reduce(x)
    return float(x)


def _batch(inp):
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in inp['batch'])


def _phantom_check(model, batch, pairs):
    """The real rows of the representation, the loss and the top-5 with
    the phantom rows of both tables as they are and set to large random
    values: ``{name: (before, after)}``."""
    users = torch.arange(model.n_users)

    def probe():
        with torch.no_grad():
            u, i = model.representation(training=True, w_pairs=pairs)
            loss, _ = model.loss(batch, w_pairs=pairs)
            vals, idx = model.topk_for_users(model.scoring_reprs(), users, 5)
        return {'u': _gather(u, model.n_users), 'i': _gather(i, model.n_items),
                'loss': _summed(loss), 'vals': vals.numpy(),
                'idx': idx.numpy()}

    before = probe()
    saved = {}
    gen = torch.Generator().manual_seed(7 + dist.get_rank())
    with torch.no_grad():
        for name, n in (('user_emb', model.n_users),
                        ('item_emb', model.n_items)):
            t = getattr(model, name)
            saved[name] = t.detach().clone()
            rows = model.mesh.rows(t.shape[0] * model.mesh.size)
            phantom = torch.arange(rows.start, rows.stop) >= n
            t[phantom] = 100.0 * torch.randn(int(phantom.sum()), t.shape[1],
                                             generator=gen)
    after = probe()
    with torch.no_grad():
        for name, t in saved.items():
            getattr(model, name).copy_(t)
    return {k: (before[k], after[k]) for k in before}


def conv_checks(inp, mesh):
    """Per conv, at the injected salts and at dropout 0: the whole
    representation, the loss and the gradients of one ``train_step``; at
    the salts also the phantom-row probe; for ``gcn`` the whole kept
    degrees."""
    from textgcn_tpu_torch import config
    from textgcn_tpu_torch.data.core import load_interactions
    from textgcn_tpu_torch.models.conv import ConvModel
    from textgcn_tpu_torch.parallel.mesh import shard_model
    from textgcn_tpu_torch.train.trainer import Trainer
    from textgcn_tpu_torch.weights import params_from_jax
    data = load_interactions(inp['dummy']).padded_to(inp['pad'])
    batch = _batch(inp)
    out = {}
    for conv, aggr in inp['convs']:
        for dropout, pairs in ((0.4, inp['pairs']),
                               (0.0, ((0, 1.0), (0, 1.0)))):
            cfg = config.Config(model=conv, aggr=aggr, data=inp['dummy'],
                                emb_size=inp['d'], reg_lambda=inp['reg'],
                                lr=inp['lr'], dropout=dropout, n_layers=2,
                                save=False, k=(3,),
                                save_path='/nonexistent').finalize()
            model = shard_model(mesh, ConvModel(cfg, data, device='cpu'),
                                data)
            model.load_params(params_from_jax(inp['params'][conv],
                                              data.n_users, data.n_items))
            res = {}
            if dropout:
                res['phantom'] = _phantom_check(model, batch, pairs)
            with torch.no_grad():
                u, i = model.representation(training=True, w_pairs=pairs)
            res['u'] = _gather(u, data.n_users)
            res['i'] = _gather(i, data.n_items)
            trainer = Trainer(cfg, model, data)
            loss, _ = trainer.train_step(batch, pairs)
            res['loss'] = _summed(loss)
            res['grads'] = {
                'user_emb': _gather(model.user_emb.grad, data.n_users),
                'item_emb': _gather(model.item_emb.grad, data.n_items),
                'convs': [{k: p.grad.numpy().copy() for k, p in lp.items()}
                          for lp in model.convs]}
            out[conv, aggr, dropout] = res
            if conv == 'gcn' and dropout:
                out['degrees'] = [d[:, 0].numpy() for d in
                                  model.graph_op.kept_degrees(pairs)]
    return out


def ltr_checks(inp, mesh):
    """Per head: the fused catalogue-sharded top-k of every user with the
    head on (and the plain sharded one with it off); for ``ltr_pop
    --freeze`` one ``train_step``: the whole tower and tables after it."""
    from textgcn_tpu_torch import config
    from textgcn_tpu_torch.data.text import load_ltr_data
    from textgcn_tpu_torch.models.ltr import LTRLinear, LTRLinearWPop
    from textgcn_tpu_torch.parallel.mesh import shard_model
    from textgcn_tpu_torch.train.trainer import Trainer
    from textgcn_tpu_torch.weights import params_from_jax, params_to_jax
    out = {}
    for name, cls in (('ltr_linear', LTRLinear), ('ltr_pop', LTRLinearWPop)):
        cfg = config.Config(model=name, data=inp['dummy'],
                            emb_size=inp['d'], reg_lambda=inp['reg'],
                            lr=inp['lr'], dropout=0.4, n_layers=3,
                            ltr_layers=tuple(inp['ltr_layers']),
                            freeze=True, save=False, k=(3,),
                            save_path='/nonexistent').finalize()
        data = load_ltr_data(cfg).padded_to(inp['pad'])
        model = shard_model(mesh, cls(cfg, data, device='cpu'), data)
        model.load_params(params_from_jax(inp['params'][name], data.n_users,
                                          data.n_items))
        users = torch.arange(data.n_users)
        res = {}
        with torch.no_grad():
            reprs = model.scoring_reprs()
            res['head'] = [t.numpy() for t in
                           model.topk_for_users(reprs, users, 5)]
            model.score_with_head = False
            res['plain'] = [t.numpy() for t in
                            model.topk_for_users(reprs, users, 5)]
            model.score_with_head = True
        if name == 'ltr_pop':
            trainer = Trainer(cfg, model, data)
            trainer.train_step(_batch(inp), inp['pairs'])
            res['after_step'] = params_to_jax(model.param_tree())
        out[name] = res
    return out


def _step(model, n_users, n_items, loss, aux):
    """A step's loss and components summed over the ranks and the whole
    gradients of both tables, after ``loss.backward()``."""
    loss.backward()
    return {'loss': _summed(loss),
            'aux': {c: _summed(v) for c, v in aux.items()},
            'grads': {'user_emb': _gather(model.user_emb.grad, n_users),
                      'item_emb': _gather(model.item_emb.grad, n_items)}}


def adv_checks(inp, mesh):
    """``adv_sampling``: one ``loss_given`` with the draws and salts of
    ``inp`` (the step, and this rank's hard negatives), then one
    ``Trainer.train_step`` that draws from the model's own generator (its
    loss and the whole tables after Adam)."""
    from textgcn_tpu_torch import config
    from textgcn_tpu_torch.data.core import load_interactions
    from textgcn_tpu_torch.models.adv_sampling import AdvSamplModel
    from textgcn_tpu_torch.parallel.mesh import shard_model
    from textgcn_tpu_torch.train.trainer import Trainer
    from textgcn_tpu_torch.weights import params_from_jax, params_to_jax
    cfg = config.Config(model='adv_sampling', data=inp['dummy'],
                        emb_size=inp['d'], k=tuple(inp['k']),
                        reg_lambda=inp['reg'], lr=inp['lr'], dropout=0.4,
                        n_layers=3, save=False,
                        save_path='/nonexistent').finalize()
    data = load_interactions(inp['dummy']).padded_to(inp['pad'])
    model = shard_model(mesh, AdvSamplModel(cfg, data, device='cpu'), data)
    model.load_params(params_from_jax(inp['params'], data.n_users,
                                      data.n_items))
    mined = []
    mine = model.hard_negatives
    model.hard_negatives = lambda *a: mined.append(mine(*a)) or mined[-1]
    users, keep, ridx = (torch.from_numpy(a) for a in inp['draws'])
    out = _step(model, data.n_users, data.n_items,
                *model.loss_given(users, keep, ridx, *inp['w_pairs']))
    out['negs'], out['valid'] = (t.numpy() for t in mined[0])
    model.zero_grad(set_to_none=True)
    loss, _ = Trainer(cfg, model, data).train_step((users,), inp['w_pairs'])
    out['train_step'] = {'loss': _summed(loss),
                         'params': params_to_jax(model.param_tree())}
    return out


def text_checks(inp, mesh):
    """The text-loss models and the concat scorers: one ``loss`` with the
    batch and salts of ``inp`` (the step); for the concat scorers the
    fused catalogue-sharded top-5 of every user with the head on, and the
    plain sharded one with it off."""
    from textgcn_tpu_torch import config
    from textgcn_tpu_torch.data.text import load_ltr_data
    from textgcn_tpu_torch.parallel.mesh import shard_model
    from textgcn_tpu_torch.registry import get_class
    from textgcn_tpu_torch.weights import params_from_jax
    out = {}
    for name, (model_name, kw) in inp['text_models'].items():
        cfg = config.Config(model=model_name, data=inp['dummy'],
                            emb_size=inp['d'], reg_lambda=inp['reg'],
                            lr=inp['lr'], dropout=0.4, n_layers=3,
                            k=(3, 5), save=False, save_path='/nonexistent',
                            **inp['formulas'], **kw).finalize()
        data = load_ltr_data(cfg).padded_to(inp['pad'])
        model = shard_model(mesh, get_class(model_name)[1](
            cfg, data, device='cpu'), data)
        model.load_params(params_from_jax(inp['params'][name], data.n_users,
                                          data.n_items))
        res = _step(model, data.n_users, data.n_items,
                    *model.loss(_batch(inp), w_pairs=inp['pairs']))
        if hasattr(model, 'score_with_head'):
            users = torch.arange(data.n_users)
            with torch.no_grad():
                reprs = model.scoring_reprs()
                res['head'] = [t.numpy() for t in
                               model.topk_for_users(reprs, users, 5)]
                model.score_with_head = False
                res['plain'] = [t.numpy() for t in
                                model.topk_for_users(reprs, users, 5)]
        out[name] = res
    out['probe_rows'] = probe_rows(inp, mesh)
    return out


def probe_rows(inp, mesh):
    """``{combo: (user rows, item rows)}`` of the representation each of
    ``text_probe``'s evaluations scores on this rank."""
    from types import SimpleNamespace

    from textgcn_tpu_torch import config
    from textgcn_tpu_torch.data.text import load_ltr_data
    from textgcn_tpu_torch.models.lightgcn import LightGCN
    from textgcn_tpu_torch.models.text_loss import probe_text_representations
    from textgcn_tpu_torch.parallel.mesh import shard_model
    cfg = config.Config(model='text_probe', data=inp['dummy'],
                        emb_size=inp['d'], save=False,
                        save_path='/nonexistent').finalize()
    data = load_ltr_data(cfg).padded_to(inp['pad'])
    model = shard_model(mesh, LightGCN(cfg, data, device='cpu'), data)
    probe = SimpleNamespace(model=model, evaluate=lambda: tuple(
        t.shape[0] for t in model.representation()))
    return probe_text_representations(data, probe)


def cli_runs(inp, world, rank, work_dir):
    """``inp['cli_runs']``: ``(uid, argv, {W: mesh shape})`` run through the
    CLI with ``--mesh`` at the shape of this W, from a directory of this
    rank's own: each run's loss sums, metrics and the state of the model's
    own generator (where it has one)."""
    from textgcn_tpu_torch import cli
    cwd = os.path.join(work_dir, f'cwd{rank}')
    os.makedirs(cwd)
    os.chdir(cwd)
    out = {}
    for uid, argv, shapes in inp['cli_runs']:
        if world not in shapes:
            continue
        trainer = cli.main([*argv, '--mesh', shapes[world], '--uid', uid])
        gen = trainer.model.generator
        out[uid] = {'loss_history': trainer.loss_history,
                    'metrics_logger': trainer.metrics_logger,
                    'generator': None if gen is None
                    else gen.get_state().numpy()}
        dist.barrier()      # rank 0's files are written
    return out


def cli_check(inp, rank, work_dir):
    """``inp['cli_argv']`` with ``--mesh 2x2`` through the CLI from a
    directory of this rank's own."""
    from textgcn_tpu_torch import cli
    cwd = os.path.join(work_dir, f'cwd{rank}')
    os.makedirs(cwd)
    os.chdir(cwd)
    trainer = cli.main([*inp['cli_argv'], '--mesh', '2x2', '--uid', 'mesh'])
    return {'loss_history': trainer.loss_history,
            'metrics': trainer.last_metrics,
            'metrics_logger': trainer.metrics_logger}


def resume_check(inp, world, work_dir):
    """``inp['resume_argv']`` with ``--mesh inp['resume_mesh']`` (default
    ``1xW``) through the CLI, from ``work_dir`` (rank 0 writes there), for
    ``inp['epochs']`` epochs, for half as many, and the half run resumed
    to the end; each run's loss sums, metrics history and whole params."""
    from textgcn_tpu_torch import cli
    from textgcn_tpu_torch.weights import params_to_jax
    os.chdir(work_dir)
    shape = inp.get('resume_mesh', '1x{w}').format(w=world)
    argv = [*inp['resume_argv'], '--mesh', shape]
    epochs = inp['epochs']
    out = {}
    for uid, extra in (
            ('full', ['--epochs', str(epochs)]),
            ('half', ['--epochs', str(epochs // 2)]),
            ('resumed', ['--epochs', str(epochs), '--resume',
                         os.path.join('runs', 'dummy', 'half')])):
        trainer = cli.main([*argv, *extra, '--uid', uid])
        out[uid] = {'loss_history': trainer.loss_history,
                    'metrics_logger': trainer.metrics_logger,
                    'params': params_to_jax(trainer.model.param_tree())}
        dist.barrier()      # rank 0's files are written
    return out


def _wait_for(path: str, timeout: float):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f'{path} was not written in {timeout} s')
        time.sleep(0.2)


def _topk_high_index_first(x, k, dim=-1, largest=True, sorted=True):
    """A ``torch.topk`` that keeps its contract (no order among equal
    values is promised) and breaks ties to the higher index, as a CUDA
    ``torch.topk`` may: the sharded merge must not lean on the CPU's
    order."""
    assert largest and dim in (-1, x.dim() - 1)
    n = x.shape[-1]
    order = torch.sort(x.flip(-1), dim=-1, descending=True,
                       stable=True).indices[..., :k]
    idx = n - 1 - order
    return torch.return_types.topk((x.gather(-1, idx), idx))


def boosted_checks(inp, world, work_dir):
    """The boosted heads (``inp['heads']``) through the CLI with
    ``inp['argv'] --load_base --predict --mesh 1xW`` from ``work_dir``
    (rank 0 writes there): each forest, every user's served top-k and the
    metrics; the run re-served with ``--load RUN --no_train``.  Then, with
    the last head's model, the top ``inp['tie_k']`` of every user under
    each forest of
    ``inp['tie_forests']`` (scores with ties across the shards), also with
    ``torch.topk`` breaking ties to the higher index, and
    ``check_ranks_agree`` with a forest that differs on every rank.  Then,
    once the parent has written ``jax.pkl`` (the forests of the JAX
    package's mesh runs), each served from ``--load_base --no_train
    --mesh 1xW`` (``predictions.tsv`` under ``carried-<model>``)."""
    from textgcn_tpu_torch import cli
    from textgcn_tpu_torch.ops.trees import GBRTState
    from textgcn_tpu_torch.parallel.sharded import ranks_agree
    os.chdir(work_dir)
    mesh = ['--mesh', f'1x{world}']
    users = np.arange(inp['n_users'])
    out = {}
    for model in inp['heads']:
        trainer = cli.main(['--model', model, *inp['argv'], '--load_base',
                            inp['base'], '--predict', *mesh, '--uid',
                            f'mesh-{model}'])
        idx, vals = trainer._predict_users(users)
        dist.barrier()      # rank 0's files are written
        served = cli.main(['--model', model, *inp['argv'], '--load',
                           os.path.join('runs', 'dummy', f'mesh-{model}'),
                           '--no_train', *mesh, '--uid',
                           f'mesh-{model}-serve'])
        out[model] = {'forest': trainer.model.forest_state,
                      'metrics': trainer.last_metrics,
                      'served_metrics': served.last_metrics,
                      'topk': (vals, idx)}
    model = trainer.model
    plain_topk = torch.topk
    for name, topk in (('ties', plain_topk),
                       ('ties_high_first', _topk_high_index_first)):
        out[name] = []
        torch.topk = topk
        try:
            for state in inp['tie_forests']:
                model.forest_state = state
                with torch.no_grad():
                    vals, idx = model.topk_for_users(
                        model.scoring_reprs(), torch.from_numpy(users),
                        inp['tie_k'])
                out[name].append((vals.numpy(), idx.numpy()))
        finally:
            torch.topk = plain_topk
    state = inp['tie_forests'][0]
    model.forest_state = GBRTState(state.trees, state.init + dist.get_rank(),
                                   state.learning_rate, state.n_features)
    try:
        model.check_ranks_agree()
        out['diverged'] = None
    except RuntimeError as e:
        out['diverged'] = str(e)
    out['agree'] = (ranks_agree(1.0, 'cpu'),
                    ranks_agree(float(dist.get_rank()), 'cpu'))
    _wait_for(os.path.join(work_dir, 'jax.pkl'), inp['jax_timeout'])
    with open(os.path.join(work_dir, 'jax.pkl'), 'rb') as f:
        carried = pickle.load(f)
    out['carried'] = {}
    for model, state in carried.items():
        trainer = cli.main(['--model', model, *inp['argv'], '--load_base',
                            inp['base'], '--no_train', *mesh, '--uid',
                            f'carried-{model}'])
        trainer.model.forest_state = state
        out['carried'][model] = trainer.evaluate(1)
        trainer.predict(users, with_scores=True, save=True)
        dist.barrier()
    return out


def approx_checks(inp, mesh):
    """``sharded_topk`` in serving mode (``approx=0.95``) over this rank's
    rows of ``inp['tables']``'s padded item table: ``{k: (values,
    indices)}``."""
    from textgcn_tpu_torch.parallel.sharded import sharded_topk
    t = inp['tables']
    items = torch.from_numpy(t['items'])
    rows = items.shape[0] // mesh.size
    shard = items[mesh.rank * rows:(mesh.rank + 1) * rows]
    out = {}
    for k in inp['ks']:
        v, i = sharded_topk(mesh, torch.from_numpy(t['users']), shard,
                            torch.from_numpy(t['pos']), k, t['n_valid'],
                            approx=0.95)
        out[k] = (v.numpy(), i.numpy())
    return out


def run(rank: int, world: int, work_dir: str):
    os.environ['TEXTGCN_TPU_PLATFORM'] = 'cpu'
    os.environ['TEXTGCN_TPU_TEXT_ENCODER'] = 'stub'
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{work_dir}/store',
                            rank=rank, world_size=world)
    try:
        from textgcn_tpu_torch.parallel.mesh import Mesh
        with open(os.path.join(work_dir, 'inputs.pkl'), 'rb') as f:
            inp = pickle.load(f)
        mesh = Mesh((1, world), rank, torch.device('cpu'))
        if inp['kind'] == 'conv':
            out = {'conv': conv_checks(inp, mesh)}
            if world == 4:
                out['cli'] = cli_check(inp, rank, work_dir)
            else:
                out['resume'] = resume_check(inp, world, work_dir)
        elif inp['kind'] == 'boosted':
            out = {'boosted': boosted_checks(inp, world, work_dir)}
        elif inp['kind'] == 'approx':
            out = {'approx': approx_checks(inp, mesh),
                   'cli': cli_runs(inp, world, rank, work_dir)}
        elif inp['kind'] == 'ltr':
            out = {'ltr': ltr_checks(inp, mesh)}
            if world == 4:
                out['cli'] = cli_check(inp, rank, work_dir)
        else:
            checks = adv_checks if inp['kind'] == 'adv' else text_checks
            out = {inp['kind']: checks(inp, mesh),
                   'cli': cli_runs(inp, world, rank, work_dir)}
            if world in inp.get('resume_worlds', ()):
                shared = os.path.join(work_dir, 'resume')
                os.makedirs(shared, exist_ok=True)
                out['resume'] = resume_check(inp, world, shared)
        with open(os.path.join(work_dir, f'rank{rank}.pkl'), 'wb') as f:
            pickle.dump(out, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
