"""The port's examples run on the CPU, and its public API names resolve to
the port's classes (the JAX package's ``__all__``, mapped by name).

``examples/torch_api_quickstart.py`` and
``examples/torch_serve_from_export.py`` run in fresh interpreters with
``TEXTGCN_TPU_PLATFORM=cpu``, as a user without a card runs them.
"""

import os
import subprocess
import sys

import pytest

import textgcn_tpu
import textgcn_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, cwd):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, 'examples', script), *args],
        capture_output=True, text=True, timeout=600, cwd=cwd,
        env={**os.environ, 'TEXTGCN_TPU_PLATFORM': 'cpu',
             'TEXTGCN_TPU_TEXT_ENCODER': 'stub', 'OMP_NUM_THREADS': '1'})


def test_api_quickstart_runs(tmp_path):
    out = _run('torch_api_quickstart.py',
               os.path.join(REPO, 'data', 'dummy'), cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert 'on cpu' in out.stdout
    assert 'propagated tables: (12, 32) (10, 32)' in out.stdout
    assert out.stdout.count('top items') == 3


def test_serve_from_export_runs(tmp_path):
    work = tmp_path / 'work'
    out = _run('torch_serve_from_export.py', str(work), cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "matches the port's predict() for 5 users @ k=10" in out.stdout
    run = work / 'runs' / 'serve_data' / 'serve_demo'
    for name in ('users_repr.npy', 'items_repr.npy', 'best.pkl'):
        assert (run / name).exists(), name
    assert not (tmp_path / 'runs').exists()


def test_the_api_has_the_jax_package_names():
    assert textgcn_tpu_torch.__all__ == textgcn_tpu.__all__
    assert textgcn_tpu_torch.__version__ == '0.5.0'


@pytest.mark.parametrize('name', textgcn_tpu.__all__)
def test_each_api_name_resolves_to_the_port(name):
    got = getattr(textgcn_tpu_torch, name)
    want = getattr(textgcn_tpu, name)
    assert got.__name__ == want.__name__
    assert got.__module__.startswith('textgcn_tpu_torch.')
    assert got.__module__.split('.', 1)[1] == want.__module__.split('.', 1)[1]


def test_an_unknown_name_raises():
    with pytest.raises(AttributeError):
        textgcn_tpu_torch.NoSuchThing
