"""Functional RCWA solve on complex tensors: the port's main path.

Counterpart of the main-path part of ``torcwa_tpu/fmm.py``: patterned
layers with free-space-referenced S-matrices, an input and an output
cladding, the unrolled Redheffer fold, and the xy S-parameter.  Conventions
are the upstream torcwa's: Lorentz-Heaviside units, exp(-j w t), Laurent
rule, Im(kz) >= 0 per layer type.

Wavelengths are a batch dimension written out: ``freq`` of shape (B,)
makes every layer quantity (n_layers, B, ...), and one eig kernel launch
serves every layer and wavelength.  The JAX package's split-real pairs and
its checkpoint policy (sized for 16 GB of TPU memory) are not carried
over.
"""

from typing import NamedTuple

import numpy as np
import torch

from ._constants import PI_REF, complex_dtype_of, pinned, real_dtype_of
from .core import (bdp_apply, bdp_dense, bdp_inv, interface_smatrix_in,
                   interface_smatrix_out, kz_conj_branch, matching_indices,
                   redheffer_product, vmat)
from .ops.cplx import csqrt
from .ops.eig import eig
from .ops.fourier import material_conv

__all__ = ['StackSpec', 'kvectors_real', 'pq_pair', 'solve_stack_pair',
           'redheffer_pair', 'sparam_xy_pair', 'simulate_txx']


class StackSpec(NamedTuple):
    """Static description of the layer stack."""
    order: tuple          # (order_x, order_y)
    L: tuple              # (Lx, Ly)
    n_layers: int
    has_input: bool = True
    has_output: bool = False
    homogeneous: tuple = ()


def _not_ported(what):
    raise NotImplementedError(
        f'{what} is not ported to the functional path yet (ROADMAP.md, '
        f'Queue 1 item 2, the rest of fmm.py); the class torcwa_tpu_torch.'
        f'rcwa has it')


def kvectors_real(freq, inc_ang, azi_ang, n_ref, order, L, rdtype):
    """Real transverse k-grids for freq of shape (B,): (B, N) each, ox
    slowest and oy fastest (upstream rcwa.py k-vector layout)."""
    dev = freq.device
    inc = torch.as_tensor(inc_ang, dtype=rdtype, device=dev)
    azi = torch.as_tensor(azi_ang, dtype=rdtype, device=dev)
    kx0 = n_ref * torch.sin(inc) * torch.cos(azi)
    ky0 = n_ref * torch.sin(inc) * torch.sin(azi)
    ox = torch.arange(-order[0], order[0] + 1, dtype=rdtype, device=dev)
    oy = torch.arange(-order[1], order[1] + 1, dtype=rdtype, device=dev)
    kx = kx0 + ox / (L[0] * freq[:, None])
    ky = ky0 + oy / (L[1] * freq[:, None])
    nx, ny = kx.shape[-1], ky.shape[-1]
    kxg = kx[:, :, None].expand(-1, nx, ny)
    kyg = ky[:, None, :].expand(-1, nx, ny)
    return kxg.reshape(kx.shape[0], -1), kyg.reshape(ky.shape[0], -1)


def pq_pair(eps_conv, kx, ky):
    """P, Q of a patterned layer with mu = 1 (constant blocks diagonal).

    eps_conv (..., N, N) complex, kx/ky (..., N) real; broadcast."""
    cdt = eps_conv.dtype
    kx = kx.to(cdt)
    ky = ky.to(cdt)
    n = eps_conv.shape[-1]
    einv = torch.linalg.inv(eps_conv)
    eye = torch.eye(n, dtype=cdt, device=eps_conv.device)
    kxc, kxr = kx[..., :, None], kx[..., None, :]
    kyc, kyr = ky[..., :, None], ky[..., None, :]
    p00 = kxc * einv * kyr
    p01 = eye - kxc * einv * kxr
    p10 = -eye + kyc * einv * kyr
    p11 = -(kyc * einv * kxr)
    shape = torch.broadcast_shapes(p00.shape, p01.shape)
    P = torch.cat([torch.cat([p00.expand(shape), p01.expand(shape)], -1),
                   torch.cat([p10.expand(shape), p11.expand(shape)], -1)], -2)
    d_kxky = torch.diag_embed(kx * ky)
    d_kx2 = torch.diag_embed(kx * kx)
    d_ky2 = torch.diag_embed(ky * ky)
    q01 = d_kx2 - eps_conv
    q10 = eps_conv - d_ky2
    shape = torch.broadcast_shapes(d_kxky.shape, q01.shape)
    Q = torch.cat([torch.cat([(-d_kxky).expand(shape), q01.expand(shape)], -1),
                   torch.cat([q10.expand(shape), d_kxky.expand(shape)], -1)],
                  -2)
    return P, Q


def _eye_like(M):
    n = M.shape[-1]
    return torch.eye(n, dtype=M.dtype, device=M.device)


def _layer_smatrix_tail_nomodes(P, E, kz, Vf_inv, omega, thickness):
    """S11, S21 and H of a layer from its eigenmodes; with
    Mp = (Apl + Bphi)^-1 and Mm = (Apl - Bphi)^-1,
      S11 = (Ephi + E) Mp + (Ephi - E) Mm
      S21 = (Ephi + E) Mp - (Ephi - E) Mm - I
    as two right-solves (the JAX package's no-modes tail)."""
    H = torch.linalg.solve(P, E * kz[..., None, :])
    W = bdp_apply(Vf_inv, H)
    Apl = E + W
    Bmn = E - W
    phase = torch.exp(1j * (omega * thickness)[..., None] * kz)
    Bphi = Bmn * phase[..., None, :]
    Ephi = E * phase[..., None, :]
    U = Ephi + E
    V = Ephi - E
    X1 = torch.linalg.solve(Apl + Bphi, U, left=False)
    X2 = torch.linalg.solve(Apl - Bphi, V, left=False)
    S11 = X1 + X2
    S21 = X1 - X2 - _eye_like(X1)
    return S11, S21, H


def _layer_smatrix_body(eps_conv, kx, ky, Vf_inv, omega, thickness,
                        broadening, backend):
    """Patterned layers: eps_conv (L, 1, N, N), kx/ky (B, N), omega (B,),
    thickness (L, 1) -> S11, S21, kz, E, H with leading (L, B)."""
    P, Q = pq_pair(eps_conv, kx, ky)
    A = P @ Q
    w, E = eig(A, broadening, backend)
    kz = csqrt(w)
    flip = kz.imag < 0
    kz = torch.where(flip, -kz, kz)
    S11, S21, H = _layer_smatrix_tail_nomodes(P, E, kz, Vf_inv, omega,
                                              thickness)
    return S11, S21, kz, E, H


def redheffer_pair(Sm, Sn):
    """Star product of dense S-matrices [S11, S21, S12, S22]."""
    return redheffer_product(Sm, Sn)[0]


@pinned
def solve_stack_pair(spec, freq, inc_ang, azi_ang, eps_grids, thicknesses,
                     eps_in=None, eps_out=None, broadening='auto',
                     eig_backend='kernels', mu_grids=None, eps_scalars=None,
                     mu_scalars=None, mu_in=None, mu_out=None,
                     with_modes=False, avoid_pinv_instability=False,
                     max_pinv_instability=0.005, fold='auto'):
    """Global S-matrix of a stack of patterned layers.

    Args:
      spec: StackSpec (patterned layers only).
      freq: 1/wavelength, a scalar or a (B,) tensor; the results carry a
        leading B dimension when it is a tensor with one.
      inc_ang, azi_ang: real scalars (radians).
      eps_grids: [n_layers, nx, ny] permittivity rasters (real or complex),
        in stack order; the device and precision of the solve.  With no
        layer it may be (0, nx, ny) or None, and then the claddings give
        them; the S-matrix is the claddings' alone.
      thicknesses: [n_layers] real.
      eps_in / eps_out: complex cladding permittivities when
        spec.has_input / spec.has_output.
      max_pinv_instability: read only with avoid_pinv_instability, which
        is not ported yet; any value is accepted without it.
      fold: 'auto' or 'unroll', both the unrolled Redheffer fold.  The
        JAX package's 'auto' scans from 8 layers on; a scan folds the
        same products in the same order, so the S-matrix is the same.
        'scan' itself is not ported yet.

    Returns ([S11, S21, S12, S22], internals), each block (B, 2N, 2N).
    Forward and backward run in IEEE f32 (``_constants.pinned``).
    """
    if mu_grids is not None or mu_scalars is not None or mu_in is not None \
            or mu_out is not None:
        _not_ported('magnetic materials (mu_*)')
    if eps_scalars is not None or any(spec.homogeneous):
        _not_ported('homogeneous layers')
    if with_modes:
        _not_ported('with_modes (mode propagation for fields)')
    if avoid_pinv_instability:
        _not_ported('avoid_pinv_instability (the Pinv fallback)')
    if fold not in ('auto', 'unroll'):
        raise NotImplementedError(
            f'fold={fold!r} is not ported yet (ROADMAP.md, Queue 1 item 2, '
            f'the rest of fmm.py)')

    grids = torch.as_tensor(eps_grids if eps_grids is not None else
                            eps_in if spec.has_input else eps_out)
    cdt = grids.dtype if grids.is_complex() else complex_dtype_of(grids.dtype)
    rdt = real_dtype_of(cdt)
    dev = grids.device
    order, L = spec.order, spec.L
    freq = torch.as_tensor(freq, dtype=rdt, device=dev)
    scalar = freq.dim() == 0
    freq = freq.reshape(-1)
    omega = 2 * PI_REF * freq
    thicknesses = torch.as_tensor(thicknesses, dtype=rdt, device=dev)
    one = torch.ones((), dtype=cdt, device=dev)
    if spec.has_input:
        eps_in = torch.as_tensor(eps_in, dtype=cdt, device=dev)
        n_ref = csqrt(eps_in).real
    else:
        n_ref = torch.ones((), dtype=rdt, device=dev)
    kx, ky = kvectors_real(freq, inc_ang, azi_ang, n_ref, order, L, rdt)
    kz_f = kz_conj_branch(one, kx, ky)
    Vf = vmat(kx, ky, kz_f)
    Vf_inv = bdp_inv(Vf)

    internals = dict(kx=kx, ky=ky, kz_f=kz_f, Vf=Vf)
    if spec.n_layers:
        conv = material_conv(grids, order, cdt)             # (L, N, N)
        S11s, S21s, kz, E, H = _layer_smatrix_body(
            conv[:, None], kx, ky, Vf_inv, omega, thicknesses[:, None],
            broadening, eig_backend)
        S = [S11s[0], S21s[0], S21s[0], S11s[0]]
        for i in range(1, spec.n_layers):
            S = redheffer_pair(S, [S11s[i], S21s[i], S21s[i], S11s[i]])
        # mu = 1 in every layer: the identity, as the JAX package reports it
        eye = torch.eye(conv.shape[-1], dtype=cdt, device=dev)
        internals.update(kz=kz, E=E, H=H, conv=conv,
                         mu_conv=eye.expand(conv.shape))
    else:
        # no layer: the identity S-matrix (the JAX package's empty fold)
        eye = torch.eye(2 * kx.shape[-1], dtype=cdt,
                        device=dev).repeat(kx.shape[0], 1, 1)
        S = [eye, torch.zeros_like(eye), torch.zeros_like(eye), eye.clone()]
    if spec.has_input:
        Vi = vmat(kx, ky, kz_conj_branch(eps_in, kx, ky))
        internals['Vi'] = Vi
        Sin = [bdp_dense(b) for b in interface_smatrix_in(Vf, Vi)]
        S = redheffer_pair(Sin, S)
    if spec.has_output:
        eps_out = torch.as_tensor(eps_out, dtype=cdt, device=dev)
        Vo = vmat(kx, ky, kz_conj_branch(eps_out, kx, ky))
        internals['Vo'] = Vo
        Sout = [bdp_dense(b) for b in interface_smatrix_out(Vf, Vo)]
        S = redheffer_pair(S, Sout)
    if scalar:
        S = [s[0] for s in S]
        internals = {k: (v[0] if k in ('kx', 'ky', 'kz_f', 'Vf', 'Vi', 'Vo')
                         else v[:, 0] if k in ('kz', 'E', 'H') else v)
                     for k, v in internals.items()}
    return S, internals


def sparam_xy_pair(S, kx, ky, eps_in, eps_out, order, orders, ref_order,
                   polarization='xx', direction='forward',
                   port='transmission', evanescent=1e-3, mu_in=None,
                   mu_out=None):
    """Power-normalised xy S-parameter at the given orders (upstream
    rcwa.py S-parameter, power_norm=True).  kx, ky (..., N) real; the
    result is complex (..., n_orders).  Non-finite values read as 0.
    mu_in / mu_out (magnetic claddings) are not ported yet: only None."""
    if mu_in is not None or mu_out is not None:
        _not_ported('magnetic materials (mu_*)')
    N = (2 * order[0] + 1) * (2 * order[1] + 1)
    oi = matching_indices(orders, order)
    ri = matching_indices(np.asarray(ref_order).reshape(1, 2), order)
    oi_p = torch.as_tensor(oi + (N if polarization in ('yx', 'yy') else 0))
    ri_p = torch.as_tensor(ri + (N if polarization in ('xy', 'yy') else 0))
    cdt = S[0].dtype

    def kz_real(eps):
        eps = torch.as_tensor(eps, dtype=cdt, device=kx.device)
        kzc = csqrt(eps - (kx ** 2).to(cdt) - (ky ** 2).to(cdt))
        ev = torch.abs(kzc.real / kzc.imag) < evanescent
        v = torch.where(ev, torch.zeros_like(kzc.real), kzc.real)
        return torch.cat([v, v], -1)

    kz_in = kz_real(eps_in)
    kz_out = kz_real(eps_out)
    kxr = torch.cat([kx, kx], -1)
    kyr = torch.cat([ky, ky], -1)
    pol_map = {'xx': (kxr, kxr), 'xy': (kxr, kyr),
               'yx': (kyr, kxr), 'yy': (kyr, kyr)}
    num_pol, den_pol = pol_map[polarization]
    sel = {('forward', 'transmission'): (kz_out, kz_in, 0),
           ('forward', 'reflection'): (kz_in, kz_in, 1),
           ('backward', 'reflection'): (kz_out, kz_out, 2),
           ('backward', 'transmission'): (kz_in, kz_out, 3)}
    num_kz, den_kz, blk = sel[(direction, port)]
    oi_p = oi_p.to(kx.device)
    ri_p = ri_p.to(kx.device)
    no, nr = num_kz[..., oi_p], den_kz[..., ri_p]
    norm = torch.sqrt((1 + (num_pol[..., oi_p] / no) ** 2)
                      / (1 + (den_pol[..., ri_p] / nr) ** 2))
    norm = norm * torch.sqrt(no / nr)
    s = S[blk][..., oi_p, ri_p] * norm
    bad = ~torch.isfinite(s.real) | ~torch.isfinite(s.imag)
    return torch.where(bad, torch.zeros_like(s), s)


@pinned
def simulate_txx(spec, freq, eps_grid, thickness, eps_in,
                 eig_backend='kernels', inc_ang=0.):
    """|t_xx(0,0)|^2 of one patterned layer on a substrate (the input
    cladding), free space above: the Example-1 sweep workload.  freq of
    shape (B,) gives a (B,) result."""
    grid = torch.as_tensor(eps_grid)
    S, intr = solve_stack_pair(
        spec, freq, inc_ang, 0., grid[None],
        torch.as_tensor(thickness).reshape(1), eps_in=eps_in,
        eig_backend=eig_backend)
    t = sparam_xy_pair(S, intr['kx'], intr['ky'], eps_in, 1., spec.order,
                       [0, 0], [0, 0], 'xx')
    return (t.real ** 2 + t.imag ** 2)[..., 0]
