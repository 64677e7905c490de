"""K1's share of its roofline in the traced sub-window of a train cell:
the frozen ``bound_ms`` (``work.k1_mean_bound_ms``) summed over K1's
launches, over K1's device time from the same trace, in percent."""

from portbench import work
from portbench.tracing import K1_KERNEL

UNIT = '%'


def read(r):
    if r.kind != 'train' or r.trace is None:
        return None
    n, t = r.trace.count(K1_KERNEL), r.trace.device_s(kernel=K1_KERNEL)
    if n == 0 or t <= 0:
        return None
    bound_s = n * work.k1_mean_bound_ms(r.shape, r.traced_keep) * 1e-3
    return 100.0 * bound_s / t
