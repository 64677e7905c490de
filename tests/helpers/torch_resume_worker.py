"""One rank of the port's mesh resume checks in ``tests/test_torch_resume.py``
and ``tests/test_torch_dcp.py``.

Started by ``torch.multiprocessing`` (spawn) with ``run(rank, world,
work_dir)``: joins a gloo group over a ``file://`` store in ``work_dir``,
then, from ``work_dir`` (rank 0 writes the runs there), trains ``lgcn
--mesh 1xW`` through the CLI for ``inputs['epochs']`` epochs, for half as
many, and resumes the half run to the end, once for each checkpoint
backend of ``inputs['backends']`` (default: pickle alone, runs ``full``,
``half``, ``resumed``; else ``full-<backend>`` and so on, and rank 0
marks each backend done with a file ``done-<backend>``).  With
``inputs['wait_for']`` it instead waits for that file, then resumes
``inputs['resume_from']`` to the end (``resumed``) and serves
``inputs['load_from']`` (``loaded``) with ``--ckpt_backend orbax``.
Writes each run's loss sums, metrics history and whole tables to
``work_dir/rank<r>.pkl``.  Imports torch and the port only.
"""

import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist


def _result(trainer):
    from textgcn_tpu_torch.weights import params_to_jax
    return {'loss_history': trainer.loss_history,
            'metrics_logger': trainer.metrics_logger,
            'last_metrics': trainer.last_metrics,
            'params': params_to_jax(trainer.model.param_tree())}


def _train_and_resume(cli, argv, epochs, backends):
    out = {}
    for backend in backends:
        name = '{}' if backends == ('pickle',) else f'{{}}-{backend}'
        for uid, extra in (
                ('full', ['--epochs', str(epochs)]),
                ('half', ['--epochs', str(epochs // 2)]),
                ('resumed', ['--epochs', str(epochs), '--resume',
                             os.path.join('runs', 'dummy',
                                          name.format('half'))])):
            trainer = cli.main([*argv, *extra, '--ckpt_backend', backend,
                                '--uid', name.format(uid)])
            out[name.format(uid)] = _result(trainer)
            dist.barrier()      # rank 0's files are written
        if dist.get_rank() == 0 and backends != ('pickle',):
            open(f'done-{backend}', 'w').close()
    return out


def _resume_elsewhere(cli, argv, inp):
    deadline = time.monotonic() + inp['timeout']
    while not os.path.exists(inp['wait_for']):
        if time.monotonic() > deadline:
            raise TimeoutError(f'{inp["wait_for"]} was not written')
        time.sleep(0.2)
    argv = [*argv, '--ckpt_backend', 'orbax']
    resumed = cli.main([*argv, '--epochs', str(inp['epochs']), '--resume',
                        inp['resume_from'], '--uid', 'resumed'])
    out = {'resumed': _result(resumed)}
    dist.barrier()
    loaded = cli.main([*argv, '--load', inp['load_from'], '--no_train',
                       '--uid', 'loaded'])
    out['loaded'] = _result(loaded)
    return out


def run(rank: int, world: int, work_dir: str):
    os.environ['TEXTGCN_TPU_PLATFORM'] = 'cpu'
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{work_dir}/store',
                            rank=rank, world_size=world)
    try:
        from textgcn_tpu_torch import cli
        with open(os.path.join(work_dir, 'inputs.pkl'), 'rb') as f:
            inp = pickle.load(f)
        os.chdir(work_dir)
        argv = [*inp['argv'], '--mesh', f'1x{world}']
        if 'wait_for' in inp:
            out = _resume_elsewhere(cli, argv, inp)
        else:
            out = _train_and_resume(cli, argv, inp['epochs'],
                                    tuple(inp.get('backends', ('pickle',))))
        with open(os.path.join(work_dir, f'rank{rank}.pkl'), 'wb') as f:
            pickle.dump(out, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
