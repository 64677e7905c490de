"""Device milliseconds a step of the operations launched inside the
program's ``train.backward`` spans (``loss.backward()``: autograd, whose
launches come from its own thread while the span is open) in the traced
sub-window."""

from portbench.spans import ms_per

UNIT = 'ms'


def read(r):
    return ms_per(r, 'train', 'train.backward')
