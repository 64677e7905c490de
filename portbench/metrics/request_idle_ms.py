"""Milliseconds a request in which the card ran nothing while the host
was inside the program's ``serve.request`` span
(``Trainer._predict_users``): the traced sub-window's idle intervals met
with the union of those spans, over the traced requests."""

from portbench.spans import idle_inside_s

UNIT = 'ms'


def read(r):
    if r.kind != 'serve' or r.trace is None or r.traced_count <= 0 \
            or 'serve.request' not in r.trace.ranges \
            or r.trace.busy_s <= 0:
        return None
    return 1e3 * idle_inside_s(r.trace, 'serve.request') / r.traced_count
