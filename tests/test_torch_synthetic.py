"""The port's generator (``textgcn_tpu_torch/tools/make_synthetic.py``)
against the JAX package's ``tools/make_synthetic.py``.

Same arguments, same seed: every file each writes (``train.tsv``,
``test.tsv``, ``meta_synced.tsv``, ``reviews_text.tsv``,
``cold_items.txt``) and the summary line must be byte-equal, in all four
modes: the legacy per-user loop (300 x 120, and a catalogue of 5 items,
where the draws are clamped), ``--sharp`` (600 x 240), ``--sharp --cold``
and the vectorised path above 100,000 users.
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest

from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from textgcn_tpu_torch.tools import make_synthetic as port_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_make_synthetic', os.path.join(REPO, 'tools', 'make_synthetic.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _jax_tool()

CASES = {
    'legacy': ['300', '120', '0'],
    'legacy-seed3': ['200', '60', '3'],
    'legacy-tiny-catalogue': ['40', '5', '1'],
    'sharp': ['600', '240', '0', '--sharp'],
    'sharp-seed7': ['500', '300', '7', '--sharp'],
    'sharp-cold': ['600', '240', '0', '--sharp', '--cold', '0.3'],
    'sharp-cold-eq': ['500', '300', '7', '--sharp', '--cold=0.5'],
}


def _run_both(tmp_path, args):
    """Both generators on ``args``: {side: (out_dir, stdout)}."""
    out = {}
    kw = port_tool.parse_argv(['out', *args])
    for side, gen in (('jax', JAX_TOOL.generate), ('port',
                                                   port_tool.generate)):
        d = str(tmp_path / side)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gen(**dict(kw, out_dir=d))
        out[side] = (d, buf.getvalue().replace(d, '<out>'))
    return out


def _assert_same_files(out):
    (a, say_a), (b, say_b) = out['jax'], out['port']
    names = sorted(os.listdir(a))
    assert sorted(os.listdir(b)) == names
    for name in names:
        with open(os.path.join(a, name), 'rb') as x, \
                open(os.path.join(b, name), 'rb') as y:
            assert y.read() == x.read(), name
    assert say_b == say_a
    return names


@pytest.mark.parametrize('case', list(CASES))
def test_every_mode_is_byte_equal(tmp_path, case):
    names = _assert_same_files(_run_both(tmp_path, CASES[case]))
    assert ('cold_items.txt' in names) == ('cold' in case)
    assert {'train.tsv', 'test.tsv', 'meta_synced.tsv',
            'reviews_text.tsv'} <= set(names)


def test_vectorised_path_above_100k_users(tmp_path):
    out = _run_both(tmp_path, ['100001', '300', '0'])
    _assert_same_files(out)
    with open(os.path.join(out['port'][0], 'train.tsv')) as f:
        users = {line.split('\t')[0] for line in f.readlines()[1:]}
    assert len(users) > port_tool.LOOP_USERS


def test_cli_parsing_matches_the_jax_tool():
    assert port_tool.parse_argv(['d', '10', '20', '3', '--cold=0.25',
                                 '--sharp']) == {
        'out_dir': 'd', 'n_users': 10, 'n_items': 20, 'seed': 3,
        'sharp': True, 'cold': 0.25}
    assert port_tool.parse_argv(['--cold', '0.5', 'x'])['cold'] == 0.5
    assert port_tool.parse_argv([])['out_dir'] == 'data/synthetic'


def test_module_entry_point(tmp_path):
    """``python -m textgcn_tpu_torch.tools.make_synthetic`` writes what the
    JAX script writes."""
    args = ['120', '80', '2', '--sharp', '--cold', '0.2']
    for side, cmd in (('jax', [os.path.join(REPO, 'tools',
                                            'make_synthetic.py')]),
                      ('port', ['-m',
                                'textgcn_tpu_torch.tools.make_synthetic'])):
        subprocess.run([sys.executable, *cmd, str(tmp_path / side), *args],
                       cwd=REPO, check=True, capture_output=True)
    for name in os.listdir(tmp_path / 'jax'):
        assert (tmp_path / 'port' / name).read_bytes() == \
            (tmp_path / 'jax' / name).read_bytes(), name
