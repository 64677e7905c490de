"""Device timing for the labs and ``chip_smoke.py``: single launches
bracketed by CUDA events behind a spin kernel, and the card's name and
power limit from ``nvidia-smi``.

The JAX labs time chains of calls and take differences
(``tools/kernel_lab.py``'s ``chain_time``), because their only clock was
the host's across a relay; on the card CUDA events time the device
directly, so that timer has no counterpart here.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

TIMED_LAUNCHES = 20
WARMUP = 25
SPIN_CYCLES = 200_000_000    # ~0.1 s at the H100's 1.98 GHz SM clock
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ['nvidia-smi', f'--query-gpu={fields}', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time of a launch that moves ``nbytes`` and does ``ops``
    f32 operations, against the published peaks, and which bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def time_ms(fns: dict, order: list[str], strict=('kernel',),
            reps: int = TIMED_LAUNCHES,
            warmup: int = WARMUP) -> dict[str, float]:
    """Median device ms of single launches, timed with CUDA events, the
    variants run in turns (``order``, e.g. plain, kernel, kernel, plain).

    Each round starts with ``warmup`` untimed launches (clocks up, the
    round's working set back in L2).  Then a spin kernel holds the stream
    while the host enqueues the whole round, so every event pair brackets
    the launch's device time and not the host's launch overhead; the
    round of ``strict`` variants fails if the host took longer than the
    spin; for the others (a library call may synchronise) it is logged.
    """
    samples = {name: [] for name in fns}
    for name in order:
        fn = fns[name]
        for _ in range(warmup):
            fn()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps + 1)]
        torch.cuda.synchronize()
        spin_start, spin_end = events.pop()
        spin_start.record()
        torch.cuda._sleep(SPIN_CYCLES)
        spin_end.record()
        t0 = time.perf_counter()
        for start, end in events:
            start.record()
            fn()
            end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spin_start.elapsed_time(spin_end)
        log(f'timing {name}: host enqueue {host_ms / reps * 1e3:.1f} us per '
            f'launch')
        if host_ms >= spin_ms:
            msg = (f'timing {name}: enqueueing {reps} launches took '
                   f'{host_ms:.1f} ms, longer than the {spin_ms:.1f} ms spin')
            if name in strict:
                raise RuntimeError(msg)
            log(msg + ': its time includes host overhead')
        samples[name] += [s.elapsed_time(e) for s, e in events]
    return {name: float(np.median(v)) for name, v in samples.items()}
