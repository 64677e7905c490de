"""Device operations (kernels, copies, fills) a step whose launch lies
inside the program's ``train.step`` spans (``Trainer.epoch_step``) in the
traced sub-window: the work count of the launch path."""

from portbench.spans import launches_in

UNIT = 'launches'


def read(r):
    if r.kind != 'train' or r.trace is None or r.traced_count <= 0:
        return None
    n = launches_in(r.trace, 'train.step')
    return n / r.traced_count if n > 0 else None
