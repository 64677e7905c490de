"""The whole training step's share of the chip's peak: the least time of
the counted work of the window's steps (``work.lgcn_step`` or
``work.adv_step``) over the window's seconds, in percent."""

UNIT = '%'


def read(r):
    if r.kind != 'train' or r.window_s <= 0:
        return None
    return 100.0 * r.work_s / r.window_s
