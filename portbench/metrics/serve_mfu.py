"""The whole request's share of the chip's peak: the least time of the
counted work of the window's requests (``work.serve_request``) over the
window's seconds, in percent."""

UNIT = '%'


def read(r):
    if r.kind != 'serve' or r.window_s <= 0:
        return None
    return 100.0 * r.work_s / r.window_s
