"""setup_eig_s: the cold first eig, seconds: set-up's first ``eig`` span
of the port, host time from its open to its close.  It holds what only a
first call pays: the kernel library's load (its ``kernels.load`` span, and
the build where the checkout has none), lazy module loads and the
cuBLAS / cuSOLVER handles."""

from rcwa_bench.program import spans


def read(ctx, name):
    eig = spans(ctx, 'setup', 'eig')
    return eig[0].host_ms / 1e3 if eig else None
