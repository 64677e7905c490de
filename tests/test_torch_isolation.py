"""The port stands alone: no JAX, no JAX-package module, no host library
that the GPU machine lacks (pandas, scikit-learn, tqdm, optax, flax,
orbax, the Hugging Face packages ``transformers``,
``sentence_transformers``, ``safetensors`` and ``tokenizers``, and
``regex``: the text encoder and its tokenizers are the port's own).

Checked twice: statically (an AST scan of every import in
``textgcn_tpu_torch/**/*.py``, ``chip_smoke.py`` and the port's examples
``examples/torch_*.py``) and at run time (a fresh interpreter in which
those modules cannot be imported imports every module of the port).
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'textgcn_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'textgcn_tpu', 'pandas', 'sklearn', 'tqdm',
             'optax', 'flax', 'orbax', 'transformers',
             'sentence_transformers', 'safetensors', 'tokenizers', 'regex',
             'tensorstore', 'zstandard', 'msgpack', 'xgboost')
EXAMPLES = os.path.join(REPO, 'examples')


def _package_files():
    out = []
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith('.py')]
    return sorted(out)


def _port_files():
    examples = sorted(os.path.join(EXAMPLES, f) for f in os.listdir(EXAMPLES)
                      if f.startswith('torch_') and f.endswith('.py'))
    return [os.path.join(REPO, 'chip_smoke.py'), *examples,
            *_package_files()]


def _port_modules():
    mods = []
    for path in _package_files():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, '.')
        mods.append(rel[:-len('.__init__')] if rel.endswith('__init__')
                    else rel)
    return [m for m in mods if not m.endswith('__main__')]


def forbidden(name: str) -> bool:
    """True for ``jax``, ``textgcn_tpu`` and their submodules (and the
    other forbidden roots) — not for ``textgcn_tpu_torch``."""
    return name.split('.')[0] in FORBIDDEN


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ''


def test_forbidden_matches_roots_not_the_port():
    assert forbidden('jax') and forbidden('jax.numpy')
    assert forbidden('textgcn_tpu') and forbidden('textgcn_tpu.ops.metrics')
    assert not forbidden('textgcn_tpu_torch')
    assert not forbidden('textgcn_tpu_torch.ops.spmm')
    assert not forbidden('torch') and not forbidden('jaxtyping_like')
    assert forbidden('transformers.models.bert') and forbidden('safetensors')
    assert not forbidden('tokenizers_like')


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import(path):
    bad = [(line, name) for line, name in _imports(path) if forbidden(name)]
    assert not bad, f'{os.path.relpath(path, REPO)} imports {bad}'


def test_every_module_imports_without_jax_or_pandas():
    block = '; '.join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    imports = '; '.join(f'importlib.import_module({m!r})'
                        for m in _port_modules())
    code = (f'import importlib, sys; {block}; sys.path.insert(0, {REPO!r}); '
            f'{imports}; import chip_smoke; print("ok")')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_the_mesh_path_imports_without_jax():
    """``textgcn_tpu_torch.parallel`` (the mesh path) and the modules it
    reaches, in an interpreter where the JAX package cannot be imported."""
    block = '; '.join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    code = (f'import sys; {block}; sys.path.insert(0, {REPO!r}); '
            'import textgcn_tpu_torch.parallel as p; '
            'from textgcn_tpu_torch.parallel import multihost, sharded, '
            'sharded_spmm; print(sorted(p.__all__))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['Mesh', 'make_mesh', 'shard_model']"


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """No card: a non-zero exit and no result line, from the checkout and
    from a directory holding chip_smoke.py alone."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('this host has a GPU: chip_smoke.py would run in full')
    alone = tmp_path / 'chip_smoke.py'
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), alone)
    for script in (os.path.join(REPO, 'chip_smoke.py'), str(alone)):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120, cwd=tmp_path)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
