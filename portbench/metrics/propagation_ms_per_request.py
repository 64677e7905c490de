"""Device milliseconds a request under the ``scoring_reprs`` range (the
propagation, ``LightGCN.scoring_reprs``) in the traced sub-window."""

UNIT = 'ms'


def read(r):
    if r.kind != 'serve' or r.trace is None or r.traced_count == 0 \
            or 'scoring_reprs' not in r.trace.ranges:
        return None
    t = r.trace.device_s('scoring_reprs')
    return 1e3 * t / r.traced_count if t > 0 else None
