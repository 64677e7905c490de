"""Device milliseconds a step of the operations launched inside the
program's ``train.forward`` spans (``Trainer.train_step``'s
``model.loss``: the propagation, the loss and, for ``adv_sampling``, the
rank pass and the mining) in the traced sub-window."""

from portbench.spans import ms_per

UNIT = 'ms'


def read(r):
    return ms_per(r, 'train', 'train.forward')
