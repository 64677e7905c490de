"""The traced sub-window: ``torch.profiler`` over a fixed number of steps
or requests, read in memory.

``Trace.collect`` takes the profiler's own events: the operations that ran
on the card (kernels, copies, fills), each with the host time of the
runtime call that launched it (linked by CUPTI's correlation id); the
benchmark's ``record_function`` ranges; and the host's operators, which
name what the host was doing while the card sat idle.  The window is the
benchmark's ``window`` range.

Events are told apart without the profiler's activity types, which not
every PyTorch version exposes: an operation on the card is an event of
the CUDA device that is no annotation; a launch is a host event named by
the CUDA runtime API (``cuda*``, ``cu*``), and a host event too;
the ranges are the host's annotations; the rest of the host's events are
operators.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

WINDOW = 'window'
K1_KERNEL = 'spmm_dropout_kernel'


@dataclass
class Trace:
    window: tuple[int, int]                    # ns, profiler clock
    ops: list[tuple[str, int, int, int]]       # name, start, end, launch
    ranges: dict[str, list[tuple[int, int]]]
    host_ops: list[tuple[str, int, int]] = field(default_factory=list)

    @classmethod
    def collect(cls, prof) -> 'Trace':
        from torch.autograd import DeviceType
        events = prof.profiler.kineto_results.events()
        launch, frontend, ranges = {}, {}, defaultdict(list)
        device, host = [], []
        main = None
        for e in events:
            end = e.start_ns() + e.duration_ns()
            on_card = e.device_type() == DeviceType.CUDA
            if on_card and not e.is_user_annotation():
                device.append(e)
            elif on_card:
                continue
            elif e.is_user_annotation():
                ranges[e.name()].append((e.start_ns(), end))
                if e.name() == WINDOW:
                    main = e.start_thread_id()
                frontend[e.correlation_id()] = e.start_ns()
            elif e.name().startswith('cu'):
                launch[e.correlation_id()] = e.start_ns()
                host.append((e, end))
            else:
                host.append((e, end))
                frontend[e.correlation_id()] = e.start_ns()
        if WINDOW not in ranges:
            raise RuntimeError('the trace has no window range')
        ops = []
        for e in device:
            at = launch.get(e.correlation_id())
            if at is None:
                at = frontend.get(e.linked_correlation_id(), -1)
            ops.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns(), at))
        host_ops = [(e.name(), e.start_ns(), end) for e, end in host
                    if e.start_thread_id() == main]
        return cls(ranges[WINDOW][0], ops, dict(ranges), host_ops)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def _busy_intervals(self) -> list[tuple[int, int]]:
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in self.ops
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy_intervals()) * 1e-9

    def device_s(self, name: str | None = None,
                 kernel: str | None = None) -> float:
        """Seconds of device operations launched inside the ranges
        ``name`` (all ranges when None) whose name holds ``kernel`` (any
        when None)."""
        spans = None if name is None else sorted(self.ranges.get(name, []))
        starts = None if spans is None else np.array([s for s, _ in spans])
        total = 0
        for op, s, e, at in self.ops:
            if kernel is not None and kernel not in op:
                continue
            if spans is not None:
                j = int(np.searchsorted(starts, at, side='right')) - 1
                if j < 0 or at > spans[j][1]:
                    continue
            total += e - s
        return total * 1e-9

    def count(self, kernel: str) -> int:
        return sum(1 for op, *_ in self.ops if kernel in op)

    def top_ops(self, n: int = 10) -> list[list]:
        by = defaultdict(int)
        for op, s, e, _ in self.ops:
            by[op] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The idle time of the window by what the host was doing when
        each gap began: the innermost host operator then running, else
        ``python`` (the host between operators); the ``n`` largest."""
        lo, hi = self.window
        busy = self._busy_intervals()
        gaps, at = [], lo
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        host = sorted(self.host_ops, key=lambda h: h[1])
        starts = np.array([h[1] for h in host], dtype=np.int64)
        by = defaultdict(int)
        for s, e in gaps:
            j = int(np.searchsorted(starts, s, side='right')) - 1
            label = 'python'
            for k in range(j, max(j - 64, -1), -1):
                if host[k][2] >= s:
                    label = host[k][0]
                    break
            by[label] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def breakdown(self) -> dict:
        return {'device_ops': self.top_ops(), 'idle_gaps': self.idle_gaps()}
