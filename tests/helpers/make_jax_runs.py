"""Writes ``tests/fixtures/jax_runs/``: run directories that the JAX
package saves, in the formats it writes on a TPU or a mesh of processes,
for the port's readers to serve (``tests/test_torch_orbax.py``,
``tests/test_torch_tree_pkl.py``, ``chip_smoke.py``'s ``jax runs`` phase).

    python tests/helpers/make_jax_runs.py [OUT]

OUT defaults to ``tests/fixtures/jax_runs``.  Everything runs on the CPU
from a copy of ``data/dummy`` (named ``dummy``, so the runs sit in
``runs/dummy/``), with the stub text encoder and fixed seeds, so a rerun
writes the same arrays (Orbax's uuids and commit times differ):

* ``lgcn/``: ``lgcn`` at d = 64, 3 layers, trained 4 epochs with
  ``--mesh 2x2 --ckpt_backend orbax`` by 2 processes of 2 CPU devices each
  (``jax.distributed`` on a localhost coordinator), so ``best.orbax`` is a
  cooperative save of 4 row shards by 2 processes; ``best.pkl`` holds the
  same params, epoch and model as the pickle backend writes them;
* ``gat/``: ``gat --aggr mean`` at d = 64 with ``--ckpt_backend orbax``
  in one process: ``best.orbax`` with the ``convs`` list;
* ``gbdt/``: ``gbdt --load_base lgcn/best.pkl`` (scikit-learn fits the
  trees): the pickled estimator ``tree.pkl`` and ``best.pkl``.

Only those files are kept (no logs, latest or resume checkpoints).
"""

import os
import shutil
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
D = 64
COMMON = ['--data', 'dummy', '--emb_size', str(D), '--batch_size', '16',
          '-k', '3', '5', '--seed', '0', '--quiet']
RUN = ('import jax; jax.config.update("jax_platforms", "cpu"); import sys; '
       f'sys.path.insert(0, {REPO!r}); from textgcn_tpu.cli import main; '
       'main(sys.argv[1:])')


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ('XLA_FLAGS', 'JAX_PLATFORMS')}
    env.update(TEXTGCN_TPU_PLATFORM='cpu', TEXTGCN_TPU_TEXT_ENCODER='stub',
               **extra)
    return env


def _jax_cli(work, args, procs=1, local_devices=1):
    """The JAX CLI in ``procs`` processes of ``local_devices`` CPU devices
    (one ``jax.distributed`` job when more than one)."""
    port = _free_port()
    runs = []
    for pid in range(procs):
        extra = {'XLA_FLAGS': '--xla_force_host_platform_device_count='
                              f'{local_devices}'}
        if procs > 1:
            extra.update(JAX_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                         JAX_NUM_PROCESSES=str(procs),
                         JAX_PROCESS_ID=str(pid))
        runs.append(subprocess.Popen([sys.executable, '-c', RUN, *args],
                                     cwd=work, env=_env(**extra),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
    for p in runs:
        out, _ = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f'JAX CLI {args} failed:\n{out[-4000:]}')


def _orbax_as_pickle(orbax_dir, pkl_path):
    """``best.pkl`` of the params, epoch and model that ``orbax_dir``
    holds (restored as numpy: a save by 2 processes restores in one only
    with restore arguments)."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import numpy as np
    import orbax.checkpoint as ocp
    ck = ocp.PyTreeCheckpointer()
    meta = ck.metadata(orbax_dir)
    tree = getattr(meta, 'item_metadata', meta)
    tree = getattr(tree, 'tree', tree)
    args = jax.tree.map(
        lambda m: ocp.RestoreArgs(restore_type=np.ndarray)
        if getattr(m, 'shape', None) is not None else ocp.RestoreArgs(),
        tree)
    restored = ck.restore(orbax_dir, restore_args=args)
    meta = {k: v.item() if isinstance(v, np.ndarray) else v
            for k, v in restored['meta'].items()}
    import pickle
    with open(pkl_path, 'wb') as f:
        pickle.dump({'params': restored['params'], **meta}, f)


def main(out):
    work = tempfile.mkdtemp(prefix='jax_runs_')
    try:
        shutil.copytree(os.path.join(REPO, 'data', 'dummy'),
                        os.path.join(work, 'dummy'))
        runs = os.path.join(work, 'runs', 'dummy')
        _jax_cli(work, ['--model', 'lgcn', *COMMON, '--epochs', '4',
                        '--evaluate_every', '2', '--mesh', '2x2',
                        '--ckpt_backend', 'orbax', '--uid', 'lgcn'],
                 procs=2, local_devices=2)
        _orbax_as_pickle(os.path.join(runs, 'lgcn', 'best.orbax'),
                         os.path.join(runs, 'lgcn', 'best.pkl'))
        _jax_cli(work, ['--model', 'gat', '--aggr', 'mean', *COMMON,
                        '--epochs', '4', '--evaluate_every', '2',
                        '--ckpt_backend', 'orbax', '--uid', 'gat'])
        _jax_cli(work, ['--model', 'gbdt', *COMMON, '--load_base',
                        os.path.join(runs, 'lgcn', 'best.pkl'), '--uid',
                        'gbdt'])
        keep = {'lgcn': ('best.orbax', 'best.pkl'), 'gat': ('best.orbax',),
                'gbdt': ('tree.pkl', 'best.pkl')}
        if os.path.exists(out):
            shutil.rmtree(out)
        for run, names in keep.items():
            os.makedirs(os.path.join(out, run))
            for name in names:
                src = os.path.join(runs, run, name)
                dst = os.path.join(out, run, name)
                if os.path.isdir(src):
                    shutil.copytree(src, dst)
                else:
                    shutil.copyfile(src, dst)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == '__main__':
    main(os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, 'tests', 'fixtures', 'jax_runs')))
