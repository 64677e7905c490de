"""K4's share of its roofline in the traced sub-window of a train cell:
``work_gat.k4_bound_ms`` (the least time of one launch, averaged over the
two directions) summed over K4's launches, over K4's device time from the
same trace, in percent."""

from portbench import work_gat

UNIT = '%'


def read(r):
    if r.kind != 'train' or r.trace is None:
        return None
    k = work_gat.K4_KERNEL
    n, t = r.trace.count(k), r.trace.device_s(kernel=k)
    if n == 0 or t <= 0:
        return None
    return 100.0 * n * work_gat.k4_bound_ms(r.shape, r.traced_keep) * 1e-3 / t
