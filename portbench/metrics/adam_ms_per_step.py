"""Device milliseconds a step of the operations launched inside the
program's ``train.adam`` spans (``optimizer.step()``) in the traced
sub-window."""

from portbench.spans import ms_per

UNIT = 'ms'


def read(r):
    return ms_per(r, 'train', 'train.adam')
