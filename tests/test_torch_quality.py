"""Pinned quality floors for the port's conv family, after the JAX
package's ``tests/test_conv_quality_pin.py``.

A numeric drift that degrades learning without breaking it would pass
every parity test.  This pins the other end: ``gcn``, ``graphsage``,
``gat`` and ``gatv2`` must learn the sharp instrument (own-cluster
holdout, Zipf popularity), written by the port's own generator
(``textgcn_tpu_torch/tools/make_synthetic.py --sharp``, 600 x 240, seed
0), through the port's ``Trainer`` on the CPU at the JAX pin's settings
(12 epochs, batch 256, d = 16, 2 layers, dropout 0.2, lr 5e-3) to the
JAX pin's recall@20 floors.  The card's run at 50k x 20k is
``chip_smoke.py``'s quality phase and
``textgcn_tpu_torch/tools/conv_quality_sweep.py``.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from textgcn_tpu_torch.config import Config
from textgcn_tpu_torch.data.core import load_interactions
from textgcn_tpu_torch.models.conv import ConvModel
from textgcn_tpu_torch.tools.make_synthetic import generate
from textgcn_tpu_torch.train.trainer import Trainer

# the JAX pin's floors (tests/test_conv_quality_pin.py)
FLOORS = {'gcn': 0.66, 'graphsage': 0.62, 'gat': 0.68, 'gatv2': 0.70}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: these tensors are tiny, so one thread is faster,
    and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def sharp(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('sharp') / 'data')
    with contextlib.redirect_stdout(io.StringIO()):
        generate(out, 600, 240, seed=0, sharp=True)
    return out, load_interactions(out)


def test_the_floors_are_the_jax_pins():
    from test_conv_quality_pin import FLOORS as JAX_FLOORS
    assert FLOORS == JAX_FLOORS


@pytest.mark.parametrize('name', ['gcn', 'graphsage', 'gat', 'gatv2'])
def test_conv_learns_sharp_instrument(sharp, tmp_path, name):
    data_dir, data = sharp
    cfg = Config(model=name, data=data_dir, aggr='mean', epochs=12,
                 evaluate_every=4, batch_size=256, emb_size=16,
                 n_layers=2, dropout=0.2, lr=5e-3, k=(20,), seed=0,
                 save=False, save_path=str(tmp_path / name)).finalize()
    model = ConvModel(cfg, data, device='cpu')
    tr = Trainer(cfg, model, data)
    tr.fit()
    best = float(np.max(tr.metrics_logger['recall'][:, 0]))
    assert best >= FLOORS[name], \
        f'{name} recall@20 {best:.4f} under the pinned floor ' \
        f'{FLOORS[name]}: a numeric drift is degrading learning'


def test_sweep_runs_and_reads_what_the_jax_sweep_reads(tmp_path,
                                                       monkeypatch):
    """The port's sweep on the CPU at a small size: it writes the sharp
    set, runs each ``model:seed`` through the CLI and reports the best
    metrics that the JAX sweep's ``best_metrics`` reads from the same
    run."""
    import importlib.util
    import os

    from textgcn_tpu_torch.tools import conv_quality_sweep as sweep
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        'jax_sweep', os.path.join(repo, 'tools', 'conv_quality_sweep.py'))
    jax_sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_sweep)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    data = str(tmp_path / 'sharp')
    with contextlib.redirect_stdout(io.StringIO()):
        rows = sweep.main(['--data', data, '--users', '300', '--items',
                           '120', '--models', 'lgcn:0,gcn:1', '--epochs',
                           '2', '--evaluate_every', '1'])
    assert [(r['model'], r['seed']) for r in rows] == [('lgcn', 0),
                                                      ('gcn', 1)]
    for r in rows:
        assert 'error' not in r, r.get('error')
        run = os.path.join('runs', 'sharp', f'qsweep-{r["model"]}-s'
                           f'{r["seed"]}')
        want = jax_sweep.best_metrics(run)
        assert {k: r[k] for k in want} == want
        assert r['n_evals'] == 2 and r['epochs_run'] == 2
        assert 0 < r['recall@20'] <= 1
    assert sweep.run_argv('gat', '2', 'd', 60, 5, 0.005)[-2:] == [
        '--aggr', 'mean']
