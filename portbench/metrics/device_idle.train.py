"""The share of the measured window of a train cell in which the card
had no work, in percent: one less the device's busy time a step, from
the traced sub-window (kernels, copies and fills of its steps), over the
window's wall time a step, from the host's clock.

The traced sub-window's own idle share is no reading of the window's:
the profiler slows the host, which paces an ``lgcn`` step, so on the
same steps it read 6.0–26.3% with the busy time the same to 0.2%."""

UNIT = '%'


def read(r):
    if (r.kind != 'train' or r.trace is None or r.traced_count <= 0
            or r.count <= 0 or r.window_s <= 0 or r.trace.busy_s <= 0):
        return None
    busy_per_step = r.trace.busy_s / r.traced_count
    return 100.0 * (1.0 - busy_per_step / (r.window_s / r.count))
