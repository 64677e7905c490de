"""Host milliseconds for ``Trainer.epoch_step`` to return, averaged over
the window's steps (layer: trainer).  Only the host paces it: the step
is enqueued, not waited for."""

UNIT = 'ms'


def read(r):
    if r.kind != 'train' or not r.host_s:
        return None
    return 1e3 * sum(r.host_s) / len(r.host_s)
