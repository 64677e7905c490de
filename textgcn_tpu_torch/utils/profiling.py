"""Tracing and profiling: counterpart of ``textgcn_tpu/utils/profiling.py``.

* ``trace``: a ``torch.profiler`` trace of the block into ``logdir``
  (``--trace DIR`` wraps ``Trainer.fit``), CPU activity with the
  operators' input shapes and the spans' inputs and, on the card, CUDA
  activity, written as ``trace_rank<r>.pt.trace.json``: Chrome
  trace JSON that TensorBoard's PyTorch profiler plugin also reads.  On
  the card there is no fallback: a profiler that cannot record CUDA
  activity raises rather than write a trace of the host alone;
* ``StepTimer``: rolling wall-clock stats, one tick per epoch (the
  trainer's examples/s);
* ``profile``: the reference's cProfile decorator;
* ``span``: a named range of the program's own (``train.step``,
  ``train.forward``, ``mining.topk``, ``serve.request``, ...; the list is
  ``docs/TORCH.md``'s "Tracing").  While a ``torch.profiler`` records, a
  span is a ``record_function`` range in the profiler's event stream: on
  the clock of the kernels it launches, nested by time on its thread, in
  ``trace``'s Chrome trace.  Otherwise it costs one check and does nothing.
"""

from __future__ import annotations

import cProfile
import contextlib
import json
import logging
import os
import pstats
import time

import torch

log = logging.getLogger('textgcn_tpu_torch')

# the Chrome trace categories of work that ran on the card
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')

# whether a torch profiler is recording, read once a span
_recording = torch._C._autograd._profiler_enabled


class _Range:
    """A ``record_function`` range entered with integer inputs: the
    profiler keeps them as the range's ``Concrete Inputs`` when it records
    shapes (``record_function``'s string ``args`` it keeps as empty)."""

    __slots__ = ('name', 'args', 'handle')

    def __init__(self, name: str, args: tuple[int, ...]):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(
            self.name, *self.args)
        return self

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str, args: tuple[int, ...] | None = None):
    """The context of the program's span ``name``: a ``record_function``
    range while a torch profiler records, with ``args`` (integers: a
    step's index; a request's sequence number and cohort size) as its
    inputs; else one shared no-op context."""
    if not _recording():
        return _NO_SPAN
    return _Range(name, args or ())


def trace_path(logdir: str, rank: int = 0) -> str:
    """Where ``trace`` writes rank ``rank``'s trace."""
    return os.path.join(logdir, f'trace_rank{rank}.pt.trace.json')


def device_events(path: str) -> list[dict]:
    """The events of a written trace that ran on the card."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return [e for e in events if e.get('cat') in DEVICE_CATEGORIES]


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


@contextlib.contextmanager
def trace(logdir: str, device: torch.device | str = 'cpu'):
    """Profile the block into ``trace_path(logdir, rank)``; on a CUDA
    ``device`` with CUDA activity, which must be recorded.  Yields the
    path."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    on_card = torch.device(device).type == 'cuda'
    activities = [ProfilerActivity.CPU]
    if on_card:
        if ProfilerActivity.CUDA not in \
                torch.profiler.supported_activities():
            raise RuntimeError(
                '--trace: this torch profiler cannot record CUDA activity '
                '(no CUPTI); refusing to write a trace of the host alone')
        activities.append(ProfilerActivity.CUDA)
    path = trace_path(logdir, _rank())
    os.makedirs(logdir, exist_ok=True)
    with torch_profile(activities=activities, record_shapes=True) as prof:
        yield path
        if on_card:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    if on_card and not device_events(path):
        raise RuntimeError(f'--trace: the profiler recorded no CUDA activity '
                           f'in {path}')
    log.info('profiler trace written to %s', path)


class StepTimer:
    """Rolling step timing: call ``tick()`` per step, read ``summary()``.
    ``start()`` (re)sets the reference point, so time spent between steps
    that should not count (an evaluation) is left out."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: list[float] = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_s(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def summary(self) -> str:
        if not self._times:
            return 'no steps timed'
        ts = sorted(self._times)
        p50 = ts[len(ts) // 2]
        p95 = ts[int(len(ts) * 0.95)]
        return (f'steps={len(ts)} mean={self.mean_s * 1e3:.1f}ms '
                f'p50={p50 * 1e3:.1f}ms p95={p95 * 1e3:.1f}ms')


def profile(func):
    """cProfile decorator: the 30 costliest calls by cumulative time."""

    def wrapper(*args, **kwargs):
        profiler = cProfile.Profile()
        profiler.enable()
        result = func(*args, **kwargs)
        profiler.disable()
        pstats.Stats(profiler).sort_stats('cumtime').print_stats(30)
        return result

    return wrapper
