"""Device milliseconds a request under the ``topk_for_users`` ranges (the
catalogue product, the train-item mask and the top-k of each batch,
``LightGCN.topk_for_users``) in the traced sub-window."""

UNIT = 'ms'


def read(r):
    if r.kind != 'serve' or r.trace is None or r.traced_count == 0 \
            or 'topk_for_users' not in r.trace.ranges:
        return None
    t = r.trace.device_s('topk_for_users')
    return 1e3 * t / r.traced_count if t > 0 else None
