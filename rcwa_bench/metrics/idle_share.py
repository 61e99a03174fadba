"""idle_share: the share of the traced window in which no operation ran on
the device, 1 - (union of the device operations' intervals) / window,
from the profiler's trace.  Overlapping operations count once."""


def read(ctx, name):
    tr = ctx.trace
    if tr is None or tr.window is None or not tr.device_ops:
        return None
    return 1. - tr.busy_ns() / tr.window_ns()
