"""eig_small_ms: the small route's whole eig (``eig_qr.eig_small``: the
three batched kernels and the refinement), ms per batch: the mean of its
spans."""


def read(ctx, name):
    ms = ctx.spans.ms('eig_small')
    return sum(ms) / len(ms) if ms else None
