"""Device milliseconds a step of the operations launched inside the
program's ``mining.topk`` spans (``AdvSamplModel.hard_negatives``'s
``mining_top_k``: the keyed selection) in the traced sub-window."""

from portbench.spans import ms_per

UNIT = 'ms'


def read(r):
    return ms_per(r, 'train', 'mining.topk')
