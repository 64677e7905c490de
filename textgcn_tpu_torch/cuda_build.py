"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc at first use.

Each source becomes a shared library with a plain C interface, loaded
with ``ctypes``; no PyTorch header is compiled, so a build takes seconds.
The libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a digest of the source and the flags: an edited
source is rebuilt, an unchanged one is reused.

Only the kernel wrappers import this module, when they first launch on a
CUDA tensor; the CPU path never needs nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build', 'kernels')
# sm_90a: Hopper with its architecture-specific instructions; no
# --use_fast_math, so float division and comparisons stay IEEE
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output per source of the last build (ptxas: registers, spills)
build_logs: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cu'))


def nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if os.access(path, os.X_OK):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                           '/usr/local/cuda/bin and PATH): the CUDA kernels '
                           'cannot be built')
    return found


def library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f'{stem}-{digest.hexdigest()[:16]}.so')


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile the given sources (default: all of ``csrc/*.cu``) that are
    not built yet: one nvcc process per source, all started together.

    Returns ``{source: seconds from the common start}`` for those built;
    raises with nvcc's output if any build fails.
    """
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    try:
        for name in names:
            target = library_path(name)
            if os.path.exists(target):
                continue
            tmp = f'{target}.{os.getpid()}.tmp'
            cmd = [nvcc(), *NVCC_FLAGS, '-o', tmp,
                   os.path.join(CSRC_DIR, name)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, target)
        seconds, failed = {}, []
        for name, (proc, tmp, target) in jobs.items():
            build_logs[name] = proc.communicate()[0]
            seconds[name] = time.perf_counter() - t0
            if proc.returncode:
                failed.append(name)
            else:
                os.replace(tmp, target)
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError('nvcc failed for ' + ', '.join(failed) + ':\n'
                           + '\n'.join(build_logs[n] for n in failed))
    return seconds


def load(source: str) -> ctypes.CDLL:
    """The shared library of ``source``, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = library_path(source)
            if not os.path.exists(path):
                build([source])
            lib = ctypes.CDLL(path)
            _libs[source] = lib
        return lib
