"""Device milliseconds a step under the ``hard_negatives`` range
(``AdvSamplModel.hard_negatives``: the catalogue product, the masks,
``mining_top_k``) in the traced sub-window."""

UNIT = 'ms'


def read(r):
    if r.kind != 'train' or r.trace is None or r.traced_count == 0 \
            or 'hard_negatives' not in r.trace.ranges:
        return None
    t = r.trace.device_s('hard_negatives')
    return 1e3 * t / r.traced_count if t > 0 else None
