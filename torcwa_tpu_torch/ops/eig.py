"""Differentiable general complex eigendecomposition with a broadened VJP.

Counterpart of ``torcwa_tpu/ops/eig.py`` (and of the upstream torcwa's
``torch_eig.Eig``).  The backward is the Lorentzian-broadened formula

    F_ij = conj(s_ij) / (|s_ij|^2 + eps),   s_ij = lambda_j - lambda_i,
    F_ii = 0,
    dA   = X^-H (diag(dlambda) + conj(F) o (X^H dX)) X^H,

with ``eps`` the broadening (``None``: the dtype's smallest subnormal;
``'auto'``: 1e-6 at float32, 1e-10 at float64).  A tensor's gradient in
torch is dL/d(re) + i dL/d(im), which is the JAX package's split-real
cotangent read as one complex number, so the formula applies verbatim.
torch's own eig backward (no broadening) is never used.

Forward backends: ``'kernels'`` (default, the production path through the
hand-written kernels, ``eig_qr.py``) and ``'torch'`` (``torch.linalg.eig``,
a test oracle only).
"""

import torch

from .._constants import pin_f32_precision
from .eig_qr import eig_qr

__all__ = ['eig', 'eig_backward', 'Eig']

_TINY = {torch.float32: 1.4e-45, torch.float64: 4.9e-324}
_AUTO_BROADENING = {torch.float32: 1e-6, torch.float64: 1e-10}


def _forward(A, backend):
    if backend == 'kernels':
        return eig_qr(A)
    if backend == 'torch':
        return torch.linalg.eig(A)
    raise ValueError(f'Unknown eig backend: {backend!r}')


def _broadening_value(broadening, rdtype):
    if broadening is None:
        return _TINY[rdtype]
    if broadening == 'auto':
        return _AUTO_BROADENING[rdtype]
    return float(broadening)


def eig_backward(w, V, gw, gV, broadening='auto'):
    """Broadened eig VJP: cotangents (gw, gV) of (w, V) -> gradient of A."""
    eps = _broadening_value(broadening, w.real.dtype)
    n = w.shape[-1]
    if gw is None:
        gw = torch.zeros_like(w)
    if gV is None:
        gV = torch.zeros_like(V)
    diag = torch.eye(n, dtype=torch.bool, device=w.device)
    s = w[..., None, :] - w[..., :, None]                # s_ij = w_j - w_i
    s_safe = torch.where(diag, torch.ones_like(s), s)
    d = s_safe.real ** 2 + s_safe.imag ** 2 + eps
    cF = torch.where(diag, torch.zeros_like(s), s_safe / d)   # conj(F)
    XH = V.conj().transpose(-1, -2)
    inner = cF * (XH @ gV) + torch.diag_embed(gw)
    return torch.linalg.solve(XH, inner @ XH)


class _EigFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, broadening, backend):
        w, V = _forward(A, backend)
        ctx.save_for_backward(w, V)
        ctx.broadening = broadening
        return w, V

    @staticmethod
    def backward(ctx, gw, gV):
        w, V = ctx.saved_tensors
        return eig_backward(w, V, gw, gV, ctx.broadening), None, None


def eig(A, broadening='auto', backend='kernels'):
    """Eigendecomposition (w, V) of a general complex (..., n, n) tensor
    with the broadened VJP."""
    pin_f32_precision()
    if not A.is_complex():
        A = A.to(torch.complex64 if A.dtype == torch.float32
                 else torch.complex128)
    return _EigFunction.apply(A, broadening, backend)


class Eig:
    """The upstream torcwa's ``Eig`` class interface: ``apply`` reads the
    class attribute ``broadening_parameter`` at call time."""

    broadening_parameter = 1e-10
    backend = 'kernels'

    @staticmethod
    def apply(x):
        return eig(x, Eig.broadening_parameter, Eig.backend)
