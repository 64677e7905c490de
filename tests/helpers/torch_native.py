"""Make the JAX package's native graph builder load before a port test
builds a JAX tile layout.

``textgcn_tpu.native.ensure_built`` runs ``make -C native`` in place the
first time it is called in a process.  Under ``pytest -n 6`` every worker
does that at once on a fresh tree; a worker whose build or ``CDLL`` loses
the race marks itself as tried and stays on the numpy layout, which
cannot lay out a source split without edges
(``textgcn_tpu/ops/pallas_spmm.py:371``).  A port test would then fail in
the JAX oracle, which looks like a fault of the port.

``ensure_jax_native(native)`` takes the ``textgcn_tpu.native`` module (the
caller imports it: this helper imports torch-side code only) and:

1. when the library is not loaded, clears the module's ``_TRIED`` and
   calls ``ensure_built`` again;
2. when it still is not, builds it once under an ``fcntl.flock`` on
   ``build/native.lock``: ``make`` in a temporary copy of ``native/``
   inside ``build/``, the library moved into place with ``os.replace``
   (whole, never half-written), then step 1 again;
3. fails, naming the build, when it still cannot load.  It never skips
   and never falls back to the numpy layout.

The library is an untracked build product (``.gitignore`` lists
``native/*.so``); no tracked file changes.
"""

import fcntl
import os
import shutil
import subprocess
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(REPO, 'native')
LIBRARY = 'libgraphbuild.so'
BUILD_DIR = os.path.join(REPO, 'build')
ATTEMPTS = 3


def _retry(native) -> bool:
    if native.available():
        return True
    native._TRIED = False
    native.ensure_built()
    return native.available()


def _build_into_place():
    """``make`` in a private copy of ``native/``; the library replaces
    ``native/libgraphbuild.so`` in one rename.  Returns make's output."""
    work = tempfile.mkdtemp(prefix='native-', dir=BUILD_DIR)
    try:
        src = os.path.join(work, 'native')
        shutil.copytree(NATIVE_DIR, src,
                        ignore=shutil.ignore_patterns('*.so'))
        out = subprocess.run(['make', '-C', src], capture_output=True,
                             text=True, timeout=300)
        if out.returncode:
            return out.stdout + out.stderr
        os.replace(os.path.join(src, LIBRARY),
                   os.path.join(NATIVE_DIR, LIBRARY))
        return out.stdout
    finally:
        shutil.rmtree(work, ignore_errors=True)


def ensure_jax_native(native):
    """Load ``native``'s library (see the module docstring) or fail."""
    if _retry(native):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    log = ''
    with open(os.path.join(BUILD_DIR, 'native.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for _ in range(ATTEMPTS):
                if _retry(native):
                    return
                log = _build_into_place()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if _retry(native):
        return
    pytest.fail(f'the JAX package\'s native graph builder '
                f'({os.path.join(NATIVE_DIR, LIBRARY)}) does not load after '
                f'`make -C native` in a copy of native/ ({ATTEMPTS} tries; '
                f'TEXTGCN_TPU_NATIVE={os.environ.get("TEXTGCN_TPU_NATIVE")!r}'
                f'). The port tests need it: without it the JAX oracle '
                f'takes its numpy layout, which cannot lay out a split '
                f'without edges. make said:\n{log}', pytrace=False)
