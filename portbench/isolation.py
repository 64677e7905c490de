"""The benchmark runs the port alone: no JAX, no JAX package.

``loaded()`` lists the modules in ``sys.modules`` whose top-level name,
the part before the first dot, is one of ``FORBIDDEN`` (compared whole:
``textgcn_tpu_torch`` is not ``textgcn_tpu``).  ``scan(folder)`` lists the
imports in the benchmark's sources of those names and of the repo's own
tools (``tools``, ``bench``, ``chip_smoke``).
"""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'textgcn_tpu')
FORBIDDEN_SOURCES = FORBIDDEN + ('tools', 'bench', 'chip_smoke')


def loaded() -> list[str]:
    return sorted(name for name in list(sys.modules)
                  if name.split('.')[0] in FORBIDDEN)


def require_clean(when: str):
    found = loaded()
    if found:
        raise SystemExit(f'portbench: {when}, sys.modules holds '
                         f'{", ".join(found)}')


def scan(folder: str) -> list[str]:
    """``path:line: module`` of every forbidden import under ``folder``."""
    out = []
    for dirpath, _, files in os.walk(folder):
        for fname in sorted(files):
            if not fname.endswith('.py'):
                continue
            path = os.path.join(dirpath, fname)
            with open(path, encoding='utf-8') as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    names = [node.module or '']
                else:
                    continue
                for name in names:
                    if name.split('.')[0] in FORBIDDEN_SOURCES:
                        out.append(f'{path}:{node.lineno}: {name}')
    return out
