"""The port's ``cold_report`` (``textgcn_tpu_torch/tools/cold_report.py``)
against the JAX package's ``tools/cold_report.py``, on the CPU.

A tiny ``make_synthetic --sharp --cold 0.2`` set written by the port's
generator, one ``lgcn`` checkpoint trained by the port's CLI (the JAX
package's pickle format) and loaded by both tools: the ``all``, ``warm``
and ``cold`` metrics agree within 1e-6, and the split keeps its contract
(warm recall well above cold).
"""

import importlib.util
import logging
import os
import sys

import numpy as np
import pytest

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu_torch import config as tconfig
from textgcn_tpu_torch.tools import cold_report
from textgcn_tpu_torch.tools.make_synthetic import generate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ['--model', 'lgcn', '--batch_size', '64', '--emb_size', '16',
        '--n_layers', '2', '-k', '3', '5', '--quiet']


def _jax_cold_report():
    """The JAX package's ``tools/cold_report.py``, loaded from its file
    with ``sys.path`` restored after (the tool prepends the repo root), so
    no later test resolves a bare ``import`` to a JAX tool."""
    path = os.path.join(REPO, 'tools', 'cold_report.py')
    spec = importlib.util.spec_from_file_location('jax_cold_report', path)
    module = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, 'path', list(sys.path))
        spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _close_port_logger():
    yield
    logger = logging.getLogger(tconfig.LOGGER_NAME)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()


@pytest.fixture(scope='module')
def reports(tmp_path_factory):
    root = tmp_path_factory.mktemp('cold')
    data = str(root / 'data')
    generate(data, n_users=300, n_items=200, seed=0, sharp=True, cold=0.2)
    old_cwd, old_env = os.getcwd(), os.environ.get('TEXTGCN_TPU_PLATFORM')
    os.chdir(root)
    os.environ['TEXTGCN_TPU_PLATFORM'] = 'cpu'
    try:
        from textgcn_tpu_torch.cli import main as port_main
        port_main(ARGS + ['--data', data, '--epochs', '4',
                          '--evaluate_every', '2', '--uid', 'base'])
        run = os.path.join('runs', 'data', 'base')
        argv = ARGS + ['--data', data, '--load', run]
        got = cold_report.main(argv + ['--uid', 'port'])
        want = _jax_cold_report().main(argv + ['--uid', 'jax'])
    finally:
        os.chdir(old_cwd)
        if old_env is None:
            os.environ.pop('TEXTGCN_TPU_PLATFORM', None)
        else:
            os.environ['TEXTGCN_TPU_PLATFORM'] = old_env
    return data, got, want


def test_the_splits_match_jax(reports):
    _, got, want = reports
    assert list(got) == list(want) == ['all', 'warm', 'cold']
    for split, metrics in want.items():
        assert set(got[split]) == set(metrics)
        for name, v in metrics.items():
            np.testing.assert_allclose(got[split][name], v, atol=1e-6,
                                       rtol=0, err_msg=f'{split} {name}')


def test_the_split_contract(reports):
    """Cold items are near-invisible to a graph model: warm recall far
    above cold, the combined number below warm."""
    _, got, _ = reports
    for res in got.values():
        for metric in ('recall', 'ndcg', 'precision', 'hit', 'f1'):
            vals = np.asarray(res[metric], float)
            assert vals.shape == (2,)
            assert np.all((0 <= vals) & (vals <= 1))
    for ki in range(2):
        r = {s: got[s]['recall'][ki] for s in got}
        assert r['warm'] > 2.0 * r['cold'], r
        assert r['all'] < r['warm']


def test_cold_items_are_read_by_external_id(reports, tmp_path):
    """``cold_items.txt`` holds the generator's external ids; every one
    that the dataset holds maps to its internal id."""
    data, _, _ = reports
    from textgcn_tpu_torch.data.core import load_interactions
    d = load_interactions(data)

    class Stub:
        cfg = tconfig.Config(data=data).finalize()

    Stub.data = d
    with open(os.path.join(data, 'cold_items.txt')) as f:
        ext = f.read().split()
    ids = cold_report.cold_item_ids(Stub)
    assert ids and len(ids) <= len(ext)
    assert {d.item_id_map[i] for i in ids} <= set(ext)
