"""Main-path RCWA algebra on native complex tensors.

Counterpart of the block-2x2-diagonal helpers, ``vmat``,
``kz_conj_branch`` and ``interface_smatrix_in/out`` of
``torcwa_tpu/core.py``.

A "bdp" is a complex tensor of shape (..., 2, 2, N) standing for the
2N x 2N matrix [[diag(a00), diag(a01)], [diag(a10), diag(a11)]].  The
V matrices of homogeneous media have that form, so their products, sums
and inverses are O(N) elementwise 2x2 algebra instead of dense O(N^3).
Leading dimensions (e.g. wavelengths) broadcast.
"""

import torch

from .ops.cplx import csqrt

__all__ = ['bdp_mul', 'bdp_inv', 'bdp_apply', 'bdp_dense', 'vmat',
           'kz_conj_branch', 'interface_smatrix_in', 'interface_smatrix_out']


def bdp_mul(a, b):
    return torch.einsum('...abn,...bcn->...acn', a, b)


def bdp_inv(a):
    """Inverse by the analytic 2x2 formula.  Division is unguarded so a
    singular block (Wood anomaly) surfaces as inf/NaN, as a dense LAPACK
    inverse would."""
    a00, a01 = a[..., 0, 0, :], a[..., 0, 1, :]
    a10, a11 = a[..., 1, 0, :], a[..., 1, 1, :]
    det = a00 * a11 - a01 * a10
    out = torch.stack([torch.stack([a11, -a01], -2),
                       torch.stack([-a10, a00], -2)], -3)
    return out / det[..., None, None, :]


def bdp_apply(a, x):
    """bdp (..., 2, 2, N) applied to a dense (..., 2N, M) matrix."""
    n = a.shape[-1]
    xt, xb = x[..., :n, :], x[..., n:, :]
    col = lambda i, j: a[..., i, j, :, None]
    top = col(0, 0) * xt + col(0, 1) * xb
    bot = col(1, 0) * xt + col(1, 1) * xb
    return torch.cat([top, bot], dim=-2)


def bdp_dense(a):
    """Materialize a bdp as a dense (..., 2N, 2N) matrix."""
    rows = [torch.cat([torch.diag_embed(a[..., i, 0, :]),
                       torch.diag_embed(a[..., i, 1, :])], dim=-1)
            for i in (0, 1)]
    return torch.cat(rows, dim=-2)


def kz_conj_branch(eps_mu, kx, ky):
    """kz = sqrt(eps*mu - kx^2 - ky^2) with Im(kz) >= 0, the branch fixed
    by conjugation (conj-if-negative is abs on the imaginary part)."""
    kz = csqrt(eps_mu - kx * kx - ky * ky)
    return torch.complex(kz.real, kz.imag.abs())


def vmat(kx, ky, kz):
    """E->H map of a homogeneous medium as a bdp:
        V = [[-Ky Kx / Kz,     -Kz - Ky^2 / Kz],
             [ Kz + Kx^2 / Kz,  Kx Ky / Kz    ]]
    Division is unguarded: kz == 0 (Wood anomaly) surfaces as inf/NaN."""
    v00 = -ky * kx / kz
    v01 = -kz - ky * ky / kz
    v10 = kz + kx * kx / kz
    v11 = kx * ky / kz
    return torch.stack([torch.stack([v00, v01], -2),
                        torch.stack([v10, v11], -2)], -3)


def interface_smatrix_in(Vf, Vi):
    """Input-cladding interface S-matrix [S11, S21, S12, S22] as bdps."""
    t1 = bdp_inv(Vf + Vi)
    s12 = bdp_mul(t1, Vf - Vi)
    return [2 * bdp_mul(t1, Vi), -s12, s12, 2 * bdp_mul(t1, Vf)]


def interface_smatrix_out(Vf, Vo):
    """Output-cladding interface S-matrix [S11, S21, S12, S22] as bdps."""
    t1 = bdp_inv(Vf + Vo)
    s12 = bdp_mul(t1, Vf - Vo)
    return [2 * bdp_mul(t1, Vf), s12, -s12, 2 * bdp_mul(t1, Vo)]
