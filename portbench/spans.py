"""What the readers of the program's spans share.

The program (``textgcn_tpu_torch``) opens its own ``record_function``
ranges while a profiler records (``utils/profiling.span``:
``train.step``, ``train.forward``, ``mining.topk``, ``serve.request``,
...), so they are ranges of the traced sub-window's ``Trace`` as the
benchmark's own are.  A program without them, or a trace with no device
time (the CPU), gives no reading: each function returns None there.
"""

from __future__ import annotations

import numpy as np

from .tracing import Trace


def ms_per(r, kind: str, span: str) -> float | None:
    """Device milliseconds of the operations launched inside the spans
    ``span`` per traced step or request of a cell of ``kind``."""
    if r.kind != kind or r.trace is None or r.traced_count <= 0 \
            or span not in r.trace.ranges:
        return None
    t = r.trace.device_s(span)
    return 1e3 * t / r.traced_count if t > 0 else None


def launches_in(trace: Trace, span: str) -> int:
    """Device operations (kernels, copies, fills) whose launch lies inside
    a span ``span``."""
    spans = sorted(trace.ranges.get(span, []))
    if not spans:
        return 0
    starts = np.array([s for s, _ in spans])
    ends = np.array([e for _, e in spans])
    at = np.array([op[3] for op in trace.ops], dtype=np.int64)
    j = np.searchsorted(starts, at, side='right') - 1
    inside = (j >= 0) & (at <= ends[np.maximum(j, 0)])
    return int(inside.sum())


def idle_inside_s(trace: Trace, span: str) -> float:
    """Seconds of the window in which the card ran nothing while the host
    was inside a span ``span``: the window's idle intervals (the
    complement of its busy ones) met with the union of those spans."""
    lo, hi = trace.window
    busy = trace._busy_intervals()
    bs = np.array([s for s, _ in busy], dtype=np.int64)
    be = np.array([e for _, e in busy], dtype=np.int64)
    total = 0
    at = lo
    for s, e in sorted(trace.ranges.get(span, [])):
        s, e = max(s, at), min(e, hi)
        if e <= s:
            continue
        at = e                  # a span nested in the last one counts once
        covered = np.clip(np.minimum(be, e) - np.maximum(bs, s), 0, None)
        total += (e - s) - int(covered.sum())
    return total * 1e-9
