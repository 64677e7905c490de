"""Device milliseconds a step of the operations launched inside the
program's ``conv.attention`` spans (``ops/gat.gat_direction``: K3 and the
self-loop fold) and ``conv.attention.backward`` spans (K4, launched from
autograd's thread) in the traced sub-window."""

from portbench.spans import ms_per

UNIT = 'ms'


def read(r):
    fwd = ms_per(r, 'train', 'conv.attention')
    bwd = ms_per(r, 'train', 'conv.attention.backward')
    if fwd is None or bwd is None:
        return None
    return fwd + bwd
