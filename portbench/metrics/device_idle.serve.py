"""The share of the traced sub-window of a serve cell in which no kernel,
copy or fill ran on the card, in percent."""

UNIT = '%'


def read(r):
    if r.kind != 'serve' or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
