"""Plain RCWA of one patterned layer between two claddings: the benchmark's
reference.

Written from the upstream torcwa's formulation (Kim and Lee, Computer
Physics Communications 282, 108552 (2023)): Laurent-rule convolution
matrices, the eigenmodes of P Q, layer S-matrices referenced to free space,
Redheffer star products with the two claddings, and the power-normalised xy
S-parameter.  Units are the upstream's: lengths in nm, k normalised by k0,
exp(-j w t).  The eigen-decomposition is ``torch.linalg.eig`` with the
upstream's Lorentzian-broadened backward.

Two precisions:

* ``Precision('exact')``: complex128 throughout, broadening 1e-10.  This is
  the reference every comparison is made against.
* ``Precision('tf32')``: complex64, every matrix product with its operands
  rounded to TF32 (10 mantissa bits, as the tensor cores read float32 when
  TF32 is allowed), forward and backward, broadening 1e-6.  This is the
  control: the configurations state float32 with TF32 off, and a comparison
  that passed this would not see a program that let TF32 in.

Nothing here imports the program under test: the a-Si:H table is a frozen
copy beside this file, interpolated by scipy's natural cubic spline.
"""

import math
import os

import numpy as np
import torch
from scipy.interpolate import CubicSpline

__all__ = ['Precision', 'asih_eps', 'rectangle', 'transmission']

_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'aSiH_nk.txt')


def _tf32(x):
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    if x.is_complex():
        return torch.complex(_tf32(x.real.contiguous()),
                             _tf32(x.imag.contiguous()))
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1fff).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and so in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return (g @ _tf32(b).mH if ctx.needs_input_grad[0] else None,
                _tf32(a).mH @ g if ctx.needs_input_grad[1] else None)


class Precision:
    """Where the reference's arithmetic is set: 'exact' or 'tf32'."""

    def __init__(self, mode='exact'):
        if mode not in ('exact', 'tf32'):
            raise ValueError(f'unknown precision {mode!r}')
        self.mode = mode
        self.cdt = torch.complex128 if mode == 'exact' else torch.complex64
        self.rdt = torch.float64 if mode == 'exact' else torch.float32
        self.broadening = 1e-10 if mode == 'exact' else 1e-6

    def mm(self, a, b):
        return a @ b if self.mode == 'exact' else _TF32MatMul.apply(a, b)


class _BroadenedEig(torch.autograd.Function):
    """torch.linalg.eig with the upstream torcwa's backward:
    dA = X^-H (diag(dw) + conj(F) o (X^H dX)) X^H,
    F_ij = conj(w_j - w_i) / (|w_j - w_i|^2 + eps), F_ii = 0."""

    @staticmethod
    def forward(ctx, A, eps, prec):
        w, X = torch.linalg.eig(A)
        ctx.save_for_backward(w, X)
        ctx.eps, ctx.prec = eps, prec
        return w, X

    @staticmethod
    def backward(ctx, gw, gX):
        w, X = ctx.saved_tensors
        mm = ctx.prec.mm
        n = w.shape[-1]
        if gw is None:
            gw = torch.zeros_like(w)
        if gX is None:
            gX = torch.zeros_like(X)
        s = w[..., None, :] - w[..., :, None]
        off = ~torch.eye(n, dtype=torch.bool, device=w.device)
        cF = torch.where(off, s / (s.real ** 2 + s.imag ** 2 + ctx.eps),
                         torch.zeros_like(s))
        XH = X.mH
        inner = cF * mm(XH, gX) + torch.diag_embed(gw)
        return torch.linalg.solve(XH, mm(inner, XH)), None, None


def asih_eps(lam_nm):
    """Permittivity (n + ik)^2 of a-Si:H at the wavelengths (nm), from the
    frozen table by a natural cubic spline, clamped to the table's range.
    Returns complex128 numpy."""
    wl, n, k = np.loadtxt(_TABLE).T
    lam = np.clip(np.asarray(lam_nm, np.float64), wl[0], wl[-1])
    nn = CubicSpline(wl, n, bc_type='natural')(lam)
    kk = CubicSpline(wl, k, bc_type='natural')(lam)
    return (nn + 1j * kk) ** 2


def rectangle(nx, ny, Lx, Ly, wx, wy, sharpness, dtype, device):
    """Occupancy of a centred wx x wy rectangle on the cell-centred grid
    x_i = (Lx / nx)(i + 1/2): sigmoid(sharpness (1 - max(|2u/wx|, |2v/wy|))).
    wx and wy may be tensors that carry a gradient."""
    x = (Lx / nx) * (torch.arange(nx, dtype=dtype, device=device) + 0.5)
    y = (Ly / ny) * (torch.arange(ny, dtype=dtype, device=device) + 0.5)
    u = (x - Lx / 2.)[:, None]
    v = (y - Ly / 2.)[None, :]
    level = 1. - torch.maximum(torch.abs(u / (wx / 2.)),
                               torch.abs(v / (wy / 2.)))
    return torch.sigmoid(sharpness * level)


def _conv(eps, order):
    """Laurent-rule convolution matrices (..., N, N) of rasters (..., nx,
    ny); orders flattened with x slowest."""
    nx, ny = eps.shape[-2:]
    F = torch.fft.fft2(eps) / (nx * ny)
    m = torch.arange(-order[0], order[0] + 1, device=eps.device)
    n = torch.arange(-order[1], order[1] + 1, device=eps.device)
    mi = m.repeat_interleave(len(n))
    ni = n.repeat(len(m))
    return F[..., (mi[:, None] - mi[None, :]) % nx,
             (ni[:, None] - ni[None, :]) % ny]


def _kz(eps, kx, ky):
    """sqrt(eps - kx^2 - ky^2) with Im >= 0."""
    kz = torch.sqrt(eps - kx * kx - ky * ky)
    return torch.complex(kz.real, kz.imag.abs())


def _vmat(kx, ky, kz):
    """E -> H matrix of a homogeneous medium, dense (..., 2N, 2N)."""
    d = torch.diag_embed
    return torch.cat([torch.cat([d(-ky * kx / kz), d(-kz - ky * ky / kz)], -1),
                      torch.cat([d(kz + kx * kx / kz), d(kx * ky / kz)], -1)],
                     -2)


def _star(prec, Sa, Sb):
    """Redheffer star product of [S11, S21, S12, S22] lists."""
    a11, a21, a12, a22 = Sa
    b11, b21, b12, b22 = Sb
    mm = prec.mm
    eye = torch.eye(a11.shape[-1], dtype=a11.dtype, device=a11.device)
    t1 = torch.linalg.inv(eye - mm(a12, b21))
    t2 = torch.linalg.inv(eye - mm(b21, a12))
    return [mm(b11, mm(t1, a11)),
            a21 + mm(a22, mm(t2, mm(b21, a11))),
            b12 + mm(b11, mm(t1, mm(a12, b22))),
            mm(a22, mm(t2, b22))]


def transmission(prec, eps_grid, lam_nm, order, L, thickness, eps_in,
                 eps_out, inc_deg=0., azi_deg=0., pols=('xx',)):
    """Zeroth-order forward transmission of one patterned layer.

    eps_grid (B, nx, ny) complex in ``prec``'s dtype (it may carry a
    gradient), lam_nm (B,) wavelengths, the light incident from the input
    cladding eps_in (real), eps_out above.  Returns {pol: (B,) complex} of
    the power-normalised t at order (0, 0)."""
    cdt, rdt, mm = prec.cdt, prec.rdt, prec.mm
    dev = eps_grid.device
    lam = torch.as_tensor(lam_nm, dtype=rdt, device=dev).reshape(-1)
    ox, oy = order
    N = (2 * ox + 1) * (2 * oy + 1)
    n_in = math.sqrt(eps_in)
    th, ph = math.radians(inc_deg), math.radians(azi_deg)
    m = torch.arange(-ox, ox + 1, dtype=rdt, device=dev)
    n = torch.arange(-oy, oy + 1, dtype=rdt, device=dev)
    kx = (n_in * math.sin(th) * math.cos(ph)
          + m.repeat_interleave(2 * oy + 1)[None] * lam[:, None] / L[0])
    ky = (n_in * math.sin(th) * math.sin(ph)
          + n.repeat(2 * ox + 1)[None] * lam[:, None] / L[1])
    kxc, kyc = kx.to(cdt), ky.to(cdt)

    E = _conv(eps_grid.to(cdt), order)
    Ei = torch.linalg.inv(E)
    eye = torch.eye(N, dtype=cdt, device=dev)
    col = lambda k: k[..., :, None]
    row = lambda k: k[..., None, :]
    P = torch.cat([
        torch.cat([col(kxc) * Ei * row(kyc), eye - col(kxc) * Ei * row(kxc)],
                  -1),
        torch.cat([col(kyc) * Ei * row(kyc) - eye, -col(kyc) * Ei * row(kxc)],
                  -1)], -2)
    dg = torch.diag_embed
    Q = torch.cat([torch.cat([dg(-kxc * kyc), dg(kxc * kxc) - E], -1),
                   torch.cat([E - dg(kyc * kyc), dg(kxc * kyc)], -1)], -2)
    w, X = _BroadenedEig.apply(mm(P, Q), prec.broadening, prec)
    kz = torch.sqrt(w)
    kz = torch.where(kz.imag < 0, -kz, kz)
    H = torch.linalg.solve(P, X * kz[..., None, :])

    kz0 = _kz(torch.ones((), dtype=cdt, device=dev), kxc, kyc)
    Vf = _vmat(kxc, kyc, kz0)
    W = torch.linalg.solve(Vf, H)
    A, B = X + W, X - W
    phase = torch.exp(1j * (2 * math.pi * thickness / lam.to(cdt))[:, None]
                      * kz)
    Xphi = X * phase[..., None, :]
    Bphi = B * phase[..., None, :]
    Mp = torch.linalg.inv(A + Bphi)
    Mm = torch.linalg.inv(A - Bphi)
    G, D = Mp + Mm, Mp - Mm
    eye2 = torch.eye(2 * N, dtype=cdt, device=dev)
    S11 = mm(Xphi, G) + mm(X, D)
    S21 = mm(X, G) + mm(Xphi, D) - eye2
    layer = [S11, S21, S21, S11]

    def cladding(eps, inner):
        Vc = _vmat(kxc, kyc, _kz(torch.as_tensor(eps, dtype=cdt, device=dev),
                                 kxc, kyc))
        t1 = torch.linalg.inv(Vf + Vc)
        s = mm(t1, Vf - Vc)
        if inner:
            return [2 * mm(t1, Vc), -s, s, 2 * mm(t1, Vf)]
        return [2 * mm(t1, Vf), s, -s, 2 * mm(t1, Vc)]

    S = _star(prec, cladding(eps_in, True), layer)
    S = _star(prec, S, cladding(eps_out, False))

    i0 = (2 * oy + 1) * ox + oy               # the (0, 0) order
    kx0, ky0 = kx[:, i0], ky[:, i0]

    def kz_real(eps):
        kz = torch.sqrt(torch.as_tensor(eps, dtype=cdt, device=dev)
                        - (kx0 * kx0 + ky0 * ky0).to(cdt))
        return torch.where(torch.abs(kz.real / kz.imag) < 1e-3,
                           torch.zeros_like(kz.real), kz.real)

    kz_o, kz_i = kz_real(eps_out), kz_real(eps_in)
    out = {}
    for pol in pols:
        k = {'xx': kx0, 'yy': ky0}[pol]
        off = 0 if pol == 'xx' else N
        norm = torch.sqrt(kz_o / kz_i) * torch.sqrt(
            (1 + (k / kz_o) ** 2) / (1 + (k / kz_i) ** 2))
        out[pol] = S[0][:, i0 + off, i0 + off] * norm
    return out
