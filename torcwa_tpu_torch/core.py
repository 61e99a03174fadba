"""RCWA algebra on native complex tensors.

Counterpart of ``torcwa_tpu/core.py``: the block-2x2-diagonal helpers,
``vmat``, ``kz_conj_branch``, the layer eigenmodes, layer S-matrices with
their mode-coupling blocks, the Redheffer star product with mode
propagation and the order bookkeeping.

This module also owns every stage after the layers, in one implementation
that both front ends run: free space and the claddings (``claddings``),
the Redheffer fold (``fold``), the xy and ps S-parameters (``sparams``)
and the Fourier source (``incident_amplitudes``).  The class API
(``solver.rcwa``) and the functional solve (``fmm``) only turn their
arguments into these functions' inputs.

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
from .utils import timing

__all__ = ['bdp_mul', 'bdp_inv', 'bdp_apply', 'bdp_apply_right',
           'bdp_scale_cols', 'bdp_dense', 'bdp_eye', 'vmat', 'kz_conj_branch',
           'interface_smatrix_in', 'interface_smatrix_out', 'pq_matrices',
           'pq_homogeneous_bdp', 'homogeneous_kz', 'eigen_decomposition',
           'LayerSolution', 'layer_H', 'layer_smatrix',
           'layer_smatrix_homogeneous', 'redheffer_product',
           'redheffer_update_modes', 'matching_indices', 'diffraction_angles',
           'conv_to_grid', 'claddings', 'fold', 'sparams',
           'incident_amplitudes']


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


# ---------------------------------------------------------------------------
# After the layers: the stages both front ends run
# ---------------------------------------------------------------------------

def claddings(kx, ky, clad_in, clad_out):
    """Free space and the claddings on a k-grid (reference
    rcwa.py:1124-1181): a dict of free space's ``kz_f``, ``Vf`` and
    ``Vf_inv`` and, for each cladding given as (eps, mu), its V (``Vi``,
    ``Vo``) and its interface S-matrix [S11, S21, S12, S22] as bdps
    (``Sin``, ``Sout``).  kx, ky (..., N), real or complex."""
    one = torch.ones((), dtype=torch.promote_types(kx.dtype, torch.complex64),
                     device=kx.device)
    kz_f = kz_conj_branch(one, kx, ky)
    Vf = vmat(kx, ky, kz_f)
    out = dict(kz_f=kz_f, Vf=Vf, Vf_inv=bdp_inv(Vf))
    for V, Sk, clad, smat in (('Vi', 'Sin', clad_in, interface_smatrix_in),
                              ('Vo', 'Sout', clad_out,
                               interface_smatrix_out)):
        if clad is not None:
            out[V] = vmat(kx, ky, kz_conj_branch(clad[0] * clad[1], kx, ky))
            out[Sk] = smat(Vf, out[V])
    return out


@timing.spanned('fmm.fold')
def fold(Ss, Cs, Sin, Sout):
    """Global S-matrix of the layers' [S11, S21, S12, S22] (stack order)
    and the claddings' by Redheffer star products (reference
    rcwa.py:173-211, 1283-1306), carrying each layer's (Cf, Cb) where Cs
    lists them.  This loop is the port's counterpart of both of the JAX
    package's folds (unrolled and lax.scan): each folds the same products
    in the same order."""
    S = Ss[0]
    C = None if Cs is None else list(Cs[:1])
    for i in range(1, len(Ss)):
        S_new, t1, t2 = redheffer_product(S, Ss[i])
        if C is not None:
            C = redheffer_update_modes(C, [Cs[i]], S, Ss[i], t1, t2)
        S = S_new
    for Sc, outer in ((Sin, True), (Sout, False)):
        if Sc is None:
            continue
        Sm, Sn = (Sc, S) if outer else (S, Sc)
        S, t1, t2 = redheffer_product(Sm, Sn)
        if C is not None:
            C = redheffer_update_modes(*(([], C) if outer else (C, [])),
                                       Sm, Sn, t1, t2)
    return S, C


# (direction, port) -> (the S block, the output order's cladding, the
# reference order's cladding, their propagation signs in the ps basis).
# The output order's kz is the power normalisation's numerator, the
# reference order's its denominator (reference rcwa.py:377-388, 430-437).
_PORTS = {('forward', 'transmission'): (0, 'out', 'in', 1., 1.),
          ('forward', 'reflection'): (1, 'in', 'in', -1., 1.),
          ('backward', 'reflection'): (2, 'out', 'out', 1., -1.),
          ('backward', 'transmission'): (3, 'in', 'out', -1., -1.)}


def _eps_mu(clad, like):
    """A cladding's (eps, mu) as eps * mu, a tensor of ``like``'s dtype and
    device; eps alone where mu is None."""
    eps, mu = (torch.as_tensor(v, dtype=like.dtype, device=like.device)
               if v is not None else None for v in clad)
    return eps if mu is None else eps * mu


def _kz_cladding(k2, kx, ky):
    """kz = sqrt(k2 - kx^2 - ky^2) of real kx, ky in a cladding of
    eps * mu = k2, csqrt's branch."""
    return csqrt(k2 - (kx ** 2).to(k2.dtype) - (ky ** 2).to(k2.dtype))


def _evanescent(kz, evanescent):
    return torch.abs(kz.real / kz.imag) < evanescent


def _ps_angles(kx, ky, k2, sign):
    """Inclination and azimuth of orders kx, ky (real) in a cladding of
    eps * mu = k2, on the side that ``sign`` gives (+1 forward-going), and
    their complex kz (reference rcwa.py:438-461, 580-588)."""
    kz = _kz_cladding(k2, kx, ky)
    inc = torch.atan2(torch.sqrt(kx ** 2 + ky ** 2), sign * torch.abs(kz.real))
    return inc, torch.atan2(ky, kx), kz


def sparams(S, kx, ky, clad_in, clad_out, oi, ri, polarization, direction,
            port, power_norm, evanescent):
    """S-parameters at the flat order indices oi against the reference
    order ri (reference rcwa.py:300-524).

    S is [S11, S21, S12, S22], each (..., 2N, 2N); kx, ky (..., N) real;
    clad_in / clad_out (eps, mu), mu None for eps alone.  xy
    polarizations ('xx', 'yx', 'xy', 'yy') read one entry of a block; ps
    ones ('pp', 'sp', 'ps', 'ss') recombine the four with each order's
    inclination and azimuth, zeroed where the output order is evanescent
    (|Re kz / Im kz| < evanescent) and all zero where the reference order
    is.  ``power_norm`` scales by the orders' kz ratio, in xy also by their
    in-plane k; an evanescent order's kz reads 0 there, except that the
    ps basis keeps |Re kz| for the output cladding, as the reference does
    (rcwa.py:490 against 495).  Non-finite values read as 0.  Returns
    complex (..., n_orders)."""
    N = kx.shape[-1]
    blk, o_side, r_side, o_sign, r_sign = _PORTS[(direction, port)]
    k2 = {'in': _eps_mu(clad_in, S[0]), 'out': _eps_mu(clad_out, S[0])}
    ps = polarization not in ('xx', 'yx', 'xy', 'yy')

    def kz_real(side):
        """Re kz of a cladding over its N orders; evanescent ones read 0,
        or |Re kz| in the ps basis's output cladding."""
        kz = _kz_cladding(k2[side], kx, ky)
        fill = (torch.abs(kz.real) if ps and side == 'out'
                else torch.zeros_like(kz.real))
        return torch.where(_evanescent(kz, evanescent), fill, kz.real)

    oi = torch.as_tensor(oi, device=kx.device)
    ri = torch.as_tensor(ri, device=kx.device)
    if power_norm:
        kz = {side: kz_real(side) for side in {o_side, r_side}}
        no, nr = kz[o_side][..., oi], kz[r_side][..., ri]
    if not ps:
        k = {'x': kx, 'y': ky}
        s = S[blk][..., oi + (N if polarization[0] == 'y' else 0),
                   ri + (N if polarization[1] == 'y' else 0)]
        if power_norm:
            norm = torch.sqrt((1 + (k[polarization[0]][..., oi] / no) ** 2)
                              / (1 + (k[polarization[1]][..., ri] / nr) ** 2))
            s = s * (norm * torch.sqrt(no / nr))
        bad = ~torch.isfinite(s.real) | ~torch.isfinite(s.imag)
        return torch.where(bad, torch.zeros_like(s), s)

    o_inc, o_azi, o_kz = _ps_angles(kx[..., oi], ky[..., oi], k2[o_side],
                                    o_sign)
    r_inc, r_azi, r_kz = _ps_angles(kx[..., ri], ky[..., ri], k2[r_side],
                                    r_sign)
    o_evan = _evanescent(o_kz, evanescent)
    Sb = S[blk]
    zero = lambda x: torch.where(o_evan, torch.zeros_like(x), x)
    xx = zero(Sb[..., oi, ri])
    xy = zero(Sb[..., oi, ri + N])
    yx = zero(Sb[..., oi + N, ri])
    yy = zero(Sb[..., oi + N, ri + N])
    co, so, ci = torch.cos(o_azi), torch.sin(o_azi), torch.cos(o_inc)
    cr, sr, cri = torch.cos(r_azi), torch.sin(r_azi), torch.cos(r_inc)
    # real coefficients (the angles are real; rcwa.py:466-485)
    coeff = {
        'pp': (co / ci * cri * cr, so / ci * cri * cr,
               co / ci * cri * sr, so / ci * cri * sr),
        'ps': (co / ci * (-sr), so / ci * (-sr), co / ci * cr, so / ci * cr),
        'sp': (-so * cri * cr, co * cri * cr, -so * cri * sr, co * cri * sr),
        'ss': (-so * (-sr), co * (-sr), -so * cr, co * cr),
    }[polarization]
    s = coeff[0] * xx + coeff[1] * yx + coeff[2] * xy + coeff[3] * yy
    if power_norm:
        s = s * torch.sqrt(no / nr)
    bad = (~torch.isfinite(s.real) | ~torch.isfinite(s.imag)
           | _evanescent(r_kz, evanescent))
    return torch.where(bad, torch.zeros_like(s), s)


def incident_amplitudes(amp, idx, n, kx, ky, clad, sign):
    """Incident Fourier amplitudes (2N,) (reference rcwa.py:539-596): the
    pairs amp (n_orders, 2) scattered to the flat order indices idx.
    Without ``clad`` they are (x, y) pairs.  With it they are (p, s)
    pairs, turned to (x, y) by each order's rotation in the source side's
    cladding (eps, mu), given the orders' real kx, ky (..., N) and the
    side's sign (+1 forward, -1 backward); the result is then (..., 2N)."""
    t = torch.as_tensor(idx, device=amp.device)
    E = amp.new_zeros(2 * n).index_put((t,), amp[:, 0]) \
        .index_put((t + n,), amp[:, 1])
    if clad is None:
        return E
    inc, azi, _ = _ps_angles(kx, ky, _eps_mu(clad, amp), sign)
    # the ps -> xy block-diagonal rotation (rcwa.py:589-594), real
    ep, es = E[:n], E[n:]
    return torch.cat([torch.cos(inc) * torch.cos(azi) * ep
                      - torch.sin(azi) * es,
                      torch.cos(inc) * torch.sin(azi) * ep
                      + torch.cos(azi) * es], -1)
