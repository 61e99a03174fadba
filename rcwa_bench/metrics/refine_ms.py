"""refine_ms: the eig's refinement (the complex128-residual steps of
``ops/eig_qr._finish``), device ms per eig call: the CUDA-event times of
the port's ``eig.refine`` spans in the spans phase over the number of its
``eig`` spans (a batch's one eig on the small route, a step's or a
batch's one on the large)."""

from rcwa_bench.program import spans


def read(ctx, name):
    eig = spans(ctx, 'window', 'eig')
    ms = [s.device_ms for s in spans(ctx, 'window', 'eig.refine')]
    if not eig or not ms or None in ms:
        return None
    return sum(ms) / len(eig)
