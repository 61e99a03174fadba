"""hess_idle_share: the share of the profiled window in which no operation
ran on the device while the innermost span open on the host was the
port's ``eig.hess`` or one of its children (``eig.hess.columns``,
``eig.hess.update``): the part of ``idle_share`` that the large route's
Hessenberg reduction leaves.  Read from the profiler's trace, where the
port's spans are host intervals if its tracer was on; None where the
trace holds no ``eig.hess`` span."""

from rcwa_bench.trace import SPAN, idle_gaps

HESS = 'eig.hess'


def innermost(intervals):
    """Pieces (start, end, name) of the time that nested ``intervals``
    ((start, end, name)) cover, each named by the innermost one open over
    it, in time order; of two that open at once the longer is the outer."""
    out, stack, t = [], [], None

    def close(until):
        nonlocal t
        while stack and stack[-1][1] <= until:
            _, b, n = stack.pop()
            if b > t:
                out.append((t, b, n))
                t = b

    for a, b, n in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        close(a)
        if stack and a > t:
            out.append((t, a, stack[-1][2]))
        t = a if t is None else max(t, a)
        stack.append((a, b, n))
    close(float('inf'))
    return out


def overlap(xs, ys):
    """Total length of the intersection of two lists of disjoint
    intervals, each in time order."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx, name):
    tr = ctx.trace
    if tr is None or tr.window is None or not tr.spans(HESS):
        return None
    lo, hi = tr.window
    pieces = [(a, b) for a, b, n in innermost(
        [(a, b, n[len(SPAN):]) for a, b, n in tr.host
         if n.startswith(SPAN)])
        if n == HESS or n.startswith(HESS + '.')]
    idle = overlap(idle_gaps(tr.device_ops, lo, hi), pieces)
    return idle / (hi - lo)
