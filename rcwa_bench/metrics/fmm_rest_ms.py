"""fmm_rest_ms: the forward solve without its eig (raster, material,
convolution, P Q, the layer tail, the Redheffer fold, the S-parameters),
ms per forward solve: the drivers' 'solve' spans less the eig spans inside
them, over the number of solves."""


def read(ctx, name):
    solve = ctx.spans.ms('solve')
    if not solve:
        return None
    return (sum(solve) - sum(ctx.spans.ms('eig'))) / len(solve)
