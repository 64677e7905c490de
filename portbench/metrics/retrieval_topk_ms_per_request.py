"""Device milliseconds a request of the operations launched inside the
program's ``retrieve.topk`` spans (``score_and_topk``'s selection:
``torch.topk``, or ``top_k_lower_index`` in serving mode) in the traced
sub-window."""

from portbench.spans import ms_per

UNIT = 'ms'


def read(r):
    return ms_per(r, 'serve', 'retrieve.topk')
