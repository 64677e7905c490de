"""Nothing the benchmark runs imports JAX or the JAX package."""

import os
import subprocess
import sys

import pytest

from portbench import harness, isolation

SMALL = dict(n_users=100, n_items=200, n_interactions=1500, batch_size=32,
             warmup_steps=1, trace_steps=2)


def test_sources_import_no_jax_nor_the_jax_package():
    assert isolation.scan(harness.ROOT) == []


def test_scan_compares_whole_top_level_names(tmp_path):
    (tmp_path / 'a.py').write_text(
        'import textgcn_tpu_torch.ops\nimport textgcn_tpu.ops\n'
        'from jax import numpy\nimport jaxtyping\nfrom tools import x\n')
    found = isolation.scan(str(tmp_path))
    assert [f.split(': ')[1] for f in found] == ['textgcn_tpu.ops', 'jax',
                                                 'tools']


def test_a_run_loads_no_jax(tmp_path):
    code = (
        'import sys, json\n'
        f'sys.path.insert(0, {os.path.dirname(harness.ROOT)!r})\n'
        'from portbench import harness, isolation\n'
        f'small = {SMALL!r}\n'
        "harness.run('lgcn-book.train', 1, 0.1, False, device='cpu', "
        f"overrides=small, cache_dir={str(tmp_path)!r})\n"
        'print(json.dumps(isolation.loaded()))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, env={
                             k: v for k, v in os.environ.items()
                             if k != 'PYTHONPATH'})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_require_clean_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, 'jax.numpy', object())
    with pytest.raises(SystemExit, match='jax.numpy'):
        isolation.require_clean('now')


def test_without_a_card_the_command_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    run = os.path.join(harness.ROOT, 'run.py')
    out = subprocess.run([sys.executable, run, '--workload',
                          'lgcn-book.train', '--seed', '1', '--seconds', '1',
                          '--trace', '0'], capture_output=True, text=True,
                         timeout=300, cwd=os.path.dirname(harness.ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ''
