"""hess_large_ms: the large route's Hessenberg reduction
(``hessenberg_blocked``), ms per matrix: the mean of its spans."""


def read(ctx, name):
    ms = ctx.spans.ms('hess_large')
    return sum(ms) / len(ms) if ms else None
