"""Seconds of ``load_interactions`` (the native reader and the graph
build on the host) in set-up."""

UNIT = 's'


def read(r):
    return r.load_s if r.load_s > 0 else None
