"""roofline_schur: the Schur stage's share of its roofline, in %.

For each span of the Schur stage in the profiled phase (``schur_ms`` on
the large route, ``SMALL_SCHUR`` on the small one; the span's meta holds n
and the batch),
the least time its nominal work needs on the card (``peaks.
schur_least_seconds``) over the device time of the operations that ran
inside the span's interval (their union), summed over the window's spans.
"""

from rcwa_bench.peaks import schur_least_seconds


def read(ctx, name):
    tr = ctx.trace
    metas = [meta for _, meta in ctx.trace_spans.get('schur', [])]
    intervals = tr.spans('schur') if tr is not None else []
    if not metas or len(intervals) != len(metas):
        return None
    least = sum(schur_least_seconds(m['n'], m['batch']) for m in metas)
    busy = sum(tr.busy_ns(a, b) for a, b in intervals) / 1e9
    if busy <= 0:
        return None
    return 100. * least / busy
