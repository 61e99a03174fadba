"""RCWA algebra on native complex tensors.

Counterpart of ``torcwa_tpu/core.py``: the block-2x2-diagonal helpers,
``vmat``, ``kz_conj_branch``, the cladding S-matrices (the functional main
path), and the layer eigenmodes, layer S-matrices with their mode-coupling
blocks, the Redheffer star product with mode propagation and the order
bookkeeping that the class API (``solver.py``) runs on.

A "bdp" is a complex tensor of shape (..., 2, 2, N) standing for the
2N x 2N matrix [[diag(a00), diag(a01)], [diag(a10), diag(a11)]].  The
V matrices of homogeneous media have that form, so their products, sums
and inverses are O(N) elementwise 2x2 algebra instead of dense O(N^3).
Leading dimensions (e.g. wavelengths) broadcast.
"""

from typing import NamedTuple

import numpy as np
import torch

from .ops.cplx import csqrt
from .ops.eig import eig

__all__ = ['bdp_mul', 'bdp_inv', 'bdp_apply', 'bdp_apply_right',
           'bdp_scale_cols', 'bdp_dense', 'bdp_eye', 'vmat', 'kz_conj_branch',
           'interface_smatrix_in', 'interface_smatrix_out', 'pq_matrices',
           'pq_homogeneous_bdp', 'homogeneous_kz', 'eigen_decomposition',
           'LayerSolution', 'layer_H', 'layer_smatrix',
           'layer_smatrix_homogeneous', 'redheffer_product', 'redheffer_update_modes', 'matching_indices',
           'diffraction_angles', 'conv_to_grid']


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


def bdp_apply_right(x, a):
    """Dense (..., M, 2N) matrix times a bdp (..., 2, 2, N)."""
    n = a.shape[-1]
    xl, xr = x[..., :n], x[..., n:]
    row = lambda i, j: a[..., i, j, None, :]
    left = xl * row(0, 0) + xr * row(1, 0)
    right = xl * row(0, 1) + xr * row(1, 1)
    return torch.cat([left, right], dim=-1)


def bdp_scale_cols(a, s):
    """bdp times diag(s) for a vector s of length 2N."""
    n = a.shape[-1]
    by_col = torch.stack([s[..., :n], s[..., n:]], dim=-2)     # (..., 2, N)
    return a * by_col[..., None, :, :]


def bdp_eye(n, dtype, device):
    """The 2N x 2N identity as a bdp."""
    one = torch.ones(n, dtype=dtype, device=device)
    zero = torch.zeros_like(one)
    return torch.stack([torch.stack([one, zero]), torch.stack([zero, one])])


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


# ---------------------------------------------------------------------------
# Layer eigenmodes
# ---------------------------------------------------------------------------

def pq_matrices(eps_conv, mu_conv, kx, ky):
    """Wave matrices P (H -> E) and Q (E -> H) of a patterned layer.

    eps_conv, mu_conv (..., N, N) complex; kx, ky (..., N), real or
    complex; leading dimensions broadcast.  The diagonal K matrices of the
    reference scale rows and columns of the inverses."""
    einv = torch.linalg.inv(eps_conv)
    minv = torch.linalg.inv(mu_conv)
    kxc, kxr = kx[..., :, None], kx[..., None, :]
    kyc, kyr = ky[..., :, None], ky[..., None, :]
    P = torch.cat([
        torch.cat([kxc * einv * kyr, mu_conv - kxc * einv * kxr], -1),
        torch.cat([-mu_conv + kyc * einv * kyr, -(kyc * einv * kxr)], -1)],
        -2)
    Q = torch.cat([
        torch.cat([-(kxc * minv * kyr), -eps_conv + kxc * minv * kxr], -1),
        torch.cat([eps_conv - kyc * minv * kyr, kyc * minv * kxr], -1)], -2)
    return P, Q


def _pack(b00, b01, b10, b11):
    return torch.stack([torch.stack([b00, b01], -2),
                        torch.stack([b10, b11], -2)], -3)


def pq_homogeneous_bdp(eps, mu, kx, ky):
    """P and Q of a homogeneous layer (scalar eps, mu) as bdps: every block
    of eps I and mu I sandwiched by diagonal K matrices is diagonal."""
    mu_v = mu.expand(kx.shape)
    eps_v = eps.expand(kx.shape)
    P = _pack(kx * ky / eps, mu_v - kx * kx / eps,
              -mu_v + ky * ky / eps, -(kx * ky / eps))
    Q = _pack(-(kx * ky / mu), -eps_v + kx * kx / mu,
              eps_v - ky * ky / mu, kx * ky / mu)
    return P, Q


def homogeneous_kz(eps, mu, kx, ky):
    """kz of a homogeneous layer over both polarization blocks, (2N,)."""
    kz = kz_conj_branch(eps * mu, kx, ky)
    return torch.cat([kz, kz], dim=-1)


def eigen_decomposition(P, Q, broadening, backend, stable_grad=True):
    """Eigenmodes of a patterned layer: eig(P Q), kz = sqrt(lambda) with
    the Im(kz) >= 0 branch chosen by a sign flip (not the conjugation of
    the homogeneous media).  Without ``stable_grad`` the eig backward runs
    unbroadened."""
    w, E = eig(P @ Q, broadening if stable_grad else 0.0, backend)
    kz = csqrt(w)
    return torch.where(kz.imag < 0, -kz, kz), E


# ---------------------------------------------------------------------------
# Single-layer S-matrix
# ---------------------------------------------------------------------------

class LayerSolution(NamedTuple):
    """What the solve and the field reconstruction need of one layer.

    S11, S21 are the layer's S-matrix blocks (S22 == S11, S12 == S21: the
    layer is referenced to free space on both sides).  G, D are its
    mode-coupling blocks, Cf = [G; D] and Cb = [D; G].  For a homogeneous
    layer every matrix is a bdp."""
    S11: torch.Tensor
    S21: torch.Tensor
    G: torch.Tensor
    D: torch.Tensor
    kz: torch.Tensor          # (2N,)
    E_eigvec: torch.Tensor    # (2N, 2N), or the bdp identity
    H_eigvec: torch.Tensor


def _phase_of(kz, omega, thickness):
    """exp(1j omega kz thickness); omega * thickness (a tensor) broadcasts
    against kz's leading dimensions."""
    return torch.exp(1j * (omega * thickness)[..., None] * kz)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def layer_H(P, E, kz, Q=None, max_pinv_instability=0.005):
    """H-field eigenvectors H = P^-1 E Kz (reference rcwa.py:1249-1262).

    Given Q, the reference's fallback is armed: P is inverted explicitly,
    and where P^-1 deviates from an inverse by ``max_pinv_instability`` or
    more (max|P P^-1 - I| or max|P^-1 P - I|, a near-singular P at a Wood
    anomaly) H = Q E Kz^-1 instead.  Returns (H, instability), instability
    the detached (Pinv metric, Qinv metric) per matrix with Q, else None.
    Leading dimensions broadcast."""
    Ekz = E * kz[..., None, :]
    if Q is None:
        return torch.linalg.solve(P, Ekz), None
    eye = _eye(E.shape[-1], E)
    Pinv = torch.linalg.inv(P)
    dev = lambda M: (M - eye).abs().amax((-2, -1))
    p_ins = torch.maximum(dev(P @ Pinv), dev(Pinv @ P))
    q_ins = dev(Q @ torch.linalg.inv(Q))
    H = torch.where((p_ins < max_pinv_instability)[..., None, None],
                    Pinv @ Ekz, Q @ (E * (1 / kz)[..., None, :]))
    return H, (p_ins.detach(), q_ins.detach())


def layer_smatrix(E, kz, P, Q, Vf_inv, omega, thickness,
                  avoid_pinv_instability=False, max_pinv_instability=0.005):
    """Layer S-matrix referenced to free space (reference rcwa.py:1244-1281).

    With M+- = (A +- B phi)^-1 the boundary matrix inverts into G = M+ + M-
    and D = M+ - M-.  Returns (LayerSolution, instability): the fallback
    and its metrics as :func:`layer_H` gives them with
    ``avoid_pinv_instability``, else None.  Leading dimensions (layers,
    wavelengths) broadcast; omega * thickness has them."""
    n2 = E.shape[-1]
    eye = _eye(n2, E)
    phase = _phase_of(kz, omega, thickness)[..., None, :]
    H, instability = layer_H(P, E, kz, Q if avoid_pinv_instability else None,
                             max_pinv_instability)
    W = bdp_apply(Vf_inv, H)
    A, B = E + W, E - W
    Bphi = B * phase
    Mp = torch.linalg.inv(A + Bphi)
    Mm = torch.linalg.inv(A - Bphi)
    G, D = Mp + Mm, Mp - Mm
    Ephi = E * phase
    S11 = Ephi @ G + E @ D
    S21 = E @ G + Ephi @ D - eye
    return LayerSolution(S11=S11, S21=S21, G=G, D=D, kz=kz, E_eigvec=E,
                         H_eigvec=H), instability


def layer_smatrix_homogeneous(eps, mu, kx, ky, Vf, omega, thickness):
    """Homogeneous-layer S-matrix in bdp algebra, O(N): the algebra of
    :func:`layer_smatrix` with E = I and P a bdp."""
    n = kx.shape[-1]
    P, _ = pq_homogeneous_bdp(eps, mu, kx, ky)
    kz = homogeneous_kz(eps, mu, kx, ky)
    phase = _phase_of(kz, omega, thickness)
    E = bdp_eye(n, kx.dtype, kx.device)
    H = bdp_scale_cols(bdp_inv(P), kz)
    W = bdp_mul(bdp_inv(Vf), H)
    A, B = E + W, E - W
    Bphi = bdp_scale_cols(B, phase)
    Mp = bdp_inv(A + Bphi)
    Mm = bdp_inv(A - Bphi)
    G, D = Mp + Mm, Mp - Mm
    Ephi = bdp_scale_cols(E, phase)
    S11 = bdp_mul(Ephi, G) + bdp_mul(E, D)
    S21 = bdp_mul(E, G) + bdp_mul(Ephi, D) - E
    return LayerSolution(S11=S11, S21=S21, G=G, D=D, kz=kz, E_eigvec=E,
                         H_eigvec=H)


# ---------------------------------------------------------------------------
# Redheffer star product
# ---------------------------------------------------------------------------

def redheffer_product(Sm, Sn):
    """Star product of dense S-matrices [S11, S21, S12, S22]; also returns
    the resolvents t1 = (I - S12m S21n)^-1 and t2 = (I - S21n S12m)^-1 that
    the mode-coupling update needs."""
    S11m, S21m, S12m, S22m = Sm
    S11n, S21n, S12n, S22n = Sn
    eye = _eye(S11m.shape[-1], S11m)
    t1 = torch.linalg.inv(eye - S12m @ S21n)
    t2 = torch.linalg.inv(eye - S21n @ S12m)
    S11 = S11n @ (t1 @ S11m)
    S21 = S21m + S22m @ (t2 @ (S21n @ S11m))
    S12 = S12n + S11n @ (t1 @ (S12m @ S22n))
    S22 = S22m @ (t2 @ S22n)
    return [S11, S21, S12, S22], t1, t2


def redheffer_update_modes(Cm_list, Cn_list, Sm, Sn, t1, t2):
    """Carry each layer's (Cf, Cb), dense (4N, 2N), through a star product
    (reference rcwa.py:1296-1304)."""
    S11m, _, S12m, _ = Sm
    _, S21n, _, S22n = Sn
    zm = t2 @ (S21n @ S11m)
    zt = t2 @ S22n
    out = [(cf + cb @ zm, cb @ zt) for cf, cb in Cm_list]
    z1 = t1 @ S11m
    z2 = t1 @ (S12m @ S22n)
    out += [(cf @ z1, cb + cf @ z2) for cf, cb in Cn_list]
    return out


# ---------------------------------------------------------------------------
# Order bookkeeping
# ---------------------------------------------------------------------------

def matching_indices(orders, order):
    """Clamp (m, n) orders into range and flatten them to indices, ox
    slowest (the reference clamps its argument in place; this does not)."""
    orders = np.asarray(orders, dtype=np.int64).reshape(-1, 2)
    m = np.clip(orders[:, 0], -order[0], order[0])
    n = np.clip(orders[:, 1], -order[1], order[1])
    return (2 * order[1] + 1) * (m + order[0]) + (n + order[1])


def diffraction_angles(kx, ky, eps, mu, orders, order, unit='radian'):
    """Propagation angles (inclination, azimuth) of the given orders in a
    homogeneous cladding (reference rcwa.py:214-262).  kx, ky (..., N),
    real or complex; eps, mu scalars."""
    idx = torch.as_tensor(matching_indices(orders, order), device=kx.device)
    cdt = kx.dtype if kx.is_complex() else (
        torch.complex64 if kx.dtype == torch.float32 else torch.complex128)
    kxi, kyi = kx[..., idx].to(cdt), ky[..., idx].to(cdt)
    k2 = kxi * kxi + kyi * kyi
    kt = csqrt(k2)
    kz = csqrt(torch.as_tensor(eps, dtype=cdt, device=kx.device)
               * torch.as_tensor(mu, dtype=cdt, device=kx.device) - k2)
    inc = torch.atan2(kt.real, kz.real)
    azi = torch.atan2(kyi.real, kxi.real)
    if unit in ('d', 'deg', 'degree'):
        rad2deg = 180. / np.pi
        inc, azi = rad2deg * inc, rad2deg * azi
    return inc, azi


def conv_to_grid(conv, order, nx=100, ny=100):
    """A layer's raster recovered from its truncated convolution matrix
    (reference rcwa.py:264-298): the coefficients scattered into an
    (nx, ny) spectrum, then an unnormalised inverse DFT."""
    ox, oy = order
    noy = 2 * oy + 1
    ii, jj, src_r, src_c = [], [], [], []
    for i in range(-2 * ox, 2 * ox + 1):
        for j in range(-2 * oy, 2 * oy + 1):
            ii.append(i % nx)
            jj.append(j % ny)
            if i >= 0 and j >= 0:
                src_r.append(i * noy + j); src_c.append(0)
            elif i >= 0:
                src_r.append(i * noy); src_c.append(-j)
            elif j >= 0:
                src_r.append(j); src_c.append(-i * noy)
            else:
                src_r.append(0); src_c.append(-i * noy - j)
    t = lambda v: torch.as_tensor(np.array(v), device=conv.device)
    F = conv.new_zeros(nx, ny).index_put(
        (t(ii), t(jj)), conv[t(src_r), t(src_c)])
    return torch.fft.ifft2(F) * (nx * ny)
