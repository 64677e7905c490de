"""The port's last three tools (``textgcn_tpu_torch/tools/``) against the
JAX package's (``tools/``), on the CPU.

* ``sem_cold_sweep``: with ``cli.main`` and ``cold_report.main`` replaced
  by recorders in both packages, the grid, run names, argv and printed
  table are the same; then one ``--quick`` row (the ``lgcn`` base and the
  grid's first ``kg`` row) runs for real on the port.
* ``conv_quality_report``: the same stdout and stderr as the JAX tool's
  on one JSONL with several seeds, one seed and an error row.
* ``make_dummy``: the bytes of the JAX tool run with its ``OUT`` set to a
  scratch directory, and of the checked-in ``data/dummy``.
"""

import importlib.util
import io
import json
import os
import sys
import types

import pytest

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu_torch.tools import conv_quality_report as port_report
from textgcn_tpu_torch.tools import make_dummy as port_dummy
from textgcn_tpu_torch.tools import sem_cold_sweep as port_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY = os.path.join(REPO, 'data', 'dummy')
DUMMY_FILES = ('train.tsv', 'test.tsv', 'meta_synced.tsv',
               'reviews_text.tsv')


def _jax_tool(name: str):
    """``tools/<name>.py`` as a fresh module; ``sys.path`` as it was."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f'jax_tool_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


# --- sem_cold_sweep --------------------------------------------------------------

FAKE = {'all': {'recall': [0.5, 0.6], 'ndcg': [0.3, 0.4]},
        'warm': {'recall': [0.25, 0.5], 'ndcg': [0.1, 0.2]},
        'cold': {'recall': [0.125, 0.0625], 'ndcg': [0.05, 0.03125]}}


def _recorders(calls):
    def cli(argv):
        calls.append(('cli', list(argv)))

    def report(argv):
        calls.append(('report', list(argv)))
        # a different cold recall a run, so the ranking has work to do
        out = json.loads(json.dumps(FAKE))
        out['cold']['recall'][1] = 0.01 * (len(calls) % 7)
        return out

    return cli, report


@pytest.mark.parametrize('argv', [[], ['--quick', '--model', 'reviews']])
def test_sem_cold_sweep_runs_the_jax_grid(tmp_path, monkeypatch, capsys,
                                          argv):
    data = tmp_path / 'cold'
    data.mkdir()
    (data / 'train.tsv').write_text('user_id\tasin\n')
    argv = ['--data', str(data), '--runs', str(tmp_path / 'runs'), *argv]
    assert port_sweep.GRID == _jax_tool('sem_cold_sweep').GRID

    jax_calls, port_calls = [], []
    cli, report = _recorders(jax_calls)
    import textgcn_tpu.cli
    monkeypatch.setattr(textgcn_tpu.cli, 'main', cli)
    monkeypatch.setitem(sys.modules, 'cold_report',
                        types.SimpleNamespace(main=report))
    monkeypatch.chdir(tmp_path)
    jax_rows = _jax_tool('sem_cold_sweep').main(argv)
    jax_out = capsys.readouterr().out

    cli, report = _recorders(port_calls)
    import textgcn_tpu_torch.cli
    from textgcn_tpu_torch.tools import cold_report
    monkeypatch.setattr(textgcn_tpu_torch.cli, 'main', cli)
    monkeypatch.setattr(cold_report, 'main', report)
    monkeypatch.chdir(tmp_path)
    port_rows = port_sweep.main(argv)
    assert capsys.readouterr().out == jax_out
    assert port_calls == jax_calls and port_rows == jax_rows
    assert len(port_calls) == 2 * (1 + len(port_sweep.GRID))
    assert os.getcwd() == str(tmp_path)


def test_sem_cold_sweep_quick_row_on_the_port(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setenv('TEXTGCN_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('TEXTGCN_TPU_TEXT_ENCODER', 'stub')
    monkeypatch.chdir(tmp_path)
    rows = port_sweep.main(['--quick', '--rows', '1',
                            '--data', str(tmp_path / 'coldq'),
                            '--runs', str(tmp_path / 'runs')])
    names = [r['name'] for r in rows]
    assert sorted(names) == ['base_lgcn', 'kg_w1_dAbmgA_feuclid']
    for r in rows:
        assert all(0 <= r[k] <= 1 for k in ('warm_r20', 'warm_r40',
                                            'cold_r40', 'cold_ndcg40'))
        assert os.path.exists(tmp_path / 'runs' / 'runs' / 'coldq'
                              / r['name'] / 'best.pkl')
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {'rows': rows}


# --- conv_quality_report ----------------------------------------------------------

ROWS = [
    {'model': 'lgcn', 'seed': 0, 'recall@20': 0.8002, 'recall@40': 0.9,
     'ndcg@20': 0.61},
    {'model': 'lgcn', 'seed': 1, 'recall@20': 0.7996, 'recall@40': 0.899,
     'ndcg@20': 0.6093},
    {'model': 'gcn', 'seed': 0, 'recall@20': 0.7001, 'recall@40': 0.81,
     'ndcg@20': 0.52},
    {'model': 'gat', 'seed': 0, 'error': 'RuntimeError: ' + 'x' * 300},
    {'model': 'gat', 'seed': 1, 'recall@20': 0.8101, 'recall@40': 0.91,
     'ndcg@20': 0.63},
]


def test_conv_quality_report_prints_the_jax_table(tmp_path, monkeypatch,
                                                  capsys):
    path = tmp_path / 'sweep.jsonl'
    path.write_text('not json\n' + ''.join(json.dumps(r) + '\n'
                                           for r in ROWS) + '\n')
    monkeypatch.setattr(sys, 'argv', ['conv_quality_report', '--in',
                                      str(path)])
    _jax_tool('conv_quality_report').main()
    want = capsys.readouterr()
    port_report.main(['--in', str(path)])
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    assert '| `gcn` | 1 |' in got.out and 'gat:0 FAILED' in got.err
    # from stdin as well
    monkeypatch.setattr(sys, 'stdin', io.StringIO(path.read_text()))
    port_report.main([])
    assert capsys.readouterr().out == want.out


# --- make_dummy ---------------------------------------------------------------------

def test_make_dummy_writes_the_jax_bytes(tmp_path, monkeypatch, capsys):
    jax_tool = _jax_tool('make_dummy')
    monkeypatch.setattr(jax_tool, 'OUT', str(tmp_path / 'jax'))
    jax_tool.main()
    want = capsys.readouterr().out
    port_dummy.main([str(tmp_path / 'port')])
    assert capsys.readouterr().out == want
    for name in DUMMY_FILES:
        got = (tmp_path / 'port' / name).read_bytes()
        assert got == (tmp_path / 'jax' / name).read_bytes(), name
        with open(os.path.join(DUMMY, name), 'rb') as f:
            assert got == f.read(), name
    assert port_dummy.OUT == DUMMY
