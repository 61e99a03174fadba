"""schur_sweeps: QR sweeps a matrix of the eig's Schur stage: the
``sweeps`` counters of the port's ``eig.schur`` spans in the spans phase
over their ``matrices`` (the large route's ``schur_ms`` counts its own
sweep loop, the small route's ``schur_qr`` sums its kernel's per-lane
count).  Fewer sweeps is less work; the roofline share says how fast
each one runs."""

from rcwa_bench.program import spans


def read(ctx, name):
    schur = spans(ctx, 'window', 'eig.schur')
    matrices = sum(s.counters.get('matrices', 0) for s in schur)
    if not matrices:
        return None
    return sum(s.counters.get('sweeps', 0) for s in schur) / matrices
