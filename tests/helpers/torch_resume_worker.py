"""One rank of the port's mesh resume check in ``tests/test_torch_resume.py``.

Started by ``torch.multiprocessing`` (spawn) with ``run(rank, world,
work_dir)``: joins a gloo group over a ``file://`` store in ``work_dir``,
then, from ``work_dir`` (rank 0 writes the runs there), trains ``lgcn
--mesh 1xW`` through the CLI for ``inputs['epochs']`` epochs, for half as
many, and resumes the half run to the end; writes each run's loss sums,
metrics history and whole tables to ``work_dir/rank<r>.pkl``.  Imports
torch and the port only.
"""

import os
import pickle
import traceback

import torch
import torch.distributed as dist


def run(rank: int, world: int, work_dir: str):
    os.environ['TEXTGCN_TPU_PLATFORM'] = 'cpu'
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{work_dir}/store',
                            rank=rank, world_size=world)
    try:
        from textgcn_tpu_torch import cli
        from textgcn_tpu_torch.weights import params_to_jax
        with open(os.path.join(work_dir, 'inputs.pkl'), 'rb') as f:
            inp = pickle.load(f)
        os.chdir(work_dir)
        argv = [*inp['argv'], '--mesh', f'1x{world}']
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
                        'params': params_to_jax(
                            trainer.model.param_tree())}
            dist.barrier()      # rank 0's files are written
        with open(os.path.join(work_dir, f'rank{rank}.pkl'), 'wb') as f:
            pickle.dump(out, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
