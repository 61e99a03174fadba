"""Complex square root with the JAX package's branch rule and derivative.

Counterpart of ``csqrt`` in ``torcwa_tpu/ops/cplx.py``.  The rest of that
module (split-real pair algebra, augmented real LU) exists only because the
TPU runtime cannot hold complex arrays; the port uses native complex
tensors and ``torch.linalg`` instead.
"""

import torch

__all__ = ['csqrt']


def _csqrt_fwd(z):
    a, b = z.real, z.imag
    r = torch.sqrt(a * a + b * b)
    re = torch.sqrt(torch.clamp((r + a) / 2, min=0.))
    im = torch.sqrt(torch.clamp((r - a) / 2, min=0.))
    # the sign follows ``b < 0``, not the sign bit: torch.sqrt on complex
    # honours signed zeros and returns -i|.| for an imaginary part of -0.0
    im = torch.where(b < 0, -im, im)
    return torch.complex(re, im)


class _CSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        w = _csqrt_fwd(z)
        ctx.save_for_backward(w)
        return w

    @staticmethod
    def backward(ctx, g):
        # dw = dz / (2 w), so the adjoint is g / conj(2 w).  The derivative
        # is supplied analytically: the half-angle formula hits sqrt'(0) =
        # inf whenever z is exactly real.  At w = 0 (not differentiable)
        # the result is 0, not NaN.
        (w,) = ctx.saved_tensors
        d = 2 * w.conj()
        ok = d != 0
        return torch.where(ok, g / torch.where(ok, d, torch.ones_like(d)),
                           torch.zeros_like(g))


def csqrt(z):
    """Principal complex square root of a complex tensor."""
    return _CSqrt.apply(z)
