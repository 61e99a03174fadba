"""Functional RCWA solve on complex tensors.

Counterpart of ``torcwa_tpu/fmm.py``: patterned layers (mu = 1 or a
permeability raster), homogeneous layers in O(N) block-diagonal algebra,
free-space-referenced layer S-matrices, an input and an output cladding,
the Redheffer fold (one loop, carrying the layers' mode-coupling blocks
where asked), the reference's P-inverse fallback, mode
propagation for the fields, the xy and ps S-parameters and the two
sources.  Conventions are the upstream torcwa's: Lorentz-Heaviside units,
exp(-j w t), Laurent rule, Im(kz) >= 0 per layer type.

Wavelengths are a batch dimension written out: ``freq`` of shape (B,)
makes every layer quantity (n_layers, B, ...), and one eig kernel launch
serves every patterned layer and wavelength.  The layer algebra is
``core.py``'s, shared with the class API.  The JAX package's split-real
pairs and its checkpoint policy (sized for 16 GB of TPU memory) are not
carried over.
"""

from typing import NamedTuple

import numpy as np
import torch

from ._constants import PI_REF, complex_dtype_of, pinned, real_dtype_of
from .core import (bdp_apply, bdp_dense, bdp_inv, conv_to_grid,
                   diffraction_angles, eigen_decomposition,
                   interface_smatrix_in, interface_smatrix_out,
                   kz_conj_branch, layer_H, layer_smatrix,
                   layer_smatrix_homogeneous, matching_indices, pq_matrices,
                   redheffer_product, redheffer_update_modes, vmat)
from .ops.cplx import csqrt
from .ops.fourier import material_conv

__all__ = ['StackSpec', 'kvectors_real', 'pq_pair', 'layer_smatrix_pair',
           'solve_stack_pair', 'redheffer_pair', 'sparam_xy_pair',
           'sparam_ps_pair', 'source_fourier_pair', 'source_planewave_pair',
           'diffraction_angle_pair', 'return_layer_pair', 'simulate_txx']

# the functional twins of rcwa.diffraction_angle / return_layer
# (rcwa.py:214-298): angles from intr['kx'] / intr['ky'], a layer's raster
# from a slice of intr['conv']
diffraction_angle_pair = pinned(diffraction_angles)
return_layer_pair = pinned(conv_to_grid)


class StackSpec(NamedTuple):
    """Static description of the layer stack."""
    order: tuple          # (order_x, order_y)
    L: tuple              # (Lx, Ly)
    n_layers: int
    has_input: bool = True
    has_output: bool = False
    # per-layer flags, () for all patterned: a homogeneous layer reads its
    # scalars from eps_scalars / mu_scalars and skips the eig
    homogeneous: tuple = ()


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


def _layer_smatrix_tail_nomodes(P, E, kz, Vf_inv, omega, thickness, Q=None,
                                max_pinv=0.005):
    """S11, S21, H and the P-inverse metrics of a layer from its
    eigenmodes, without the mode-coupling blocks; with
    Mp = (Apl + Bphi)^-1 and Mm = (Apl - Bphi)^-1,
      S11 = (Ephi + E) Mp + (Ephi - E) Mm
      S21 = (Ephi + E) Mp - (Ephi - E) Mm - I
    as two right-solves (the JAX package's no-modes tail).  Q arms the
    P-inverse fallback (``core.layer_H``)."""
    H, instability = layer_H(P, E, kz, Q, max_pinv)
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
    return S11, S21, H, instability


def _layer_smatrix_body(eps_conv, kx, ky, Vf_inv, omega, thickness,
                        broadening, backend, mu_conv=None, need_modes=True,
                        avoid_pinv=False, max_pinv=0.005):
    """Patterned layers, leading dimensions broadcast (the solve passes
    eps_conv (L, 1, N, N), kx/ky (B, N), omega (B,), thickness (L, 1)):
    (S11, S21, G, D, kz, E, H) with ``need_modes``, else (S11, S21, kz,
    E, H) through the cheaper tail; with ``avoid_pinv`` the (Pinv, Qinv)
    metrics follow.  mu_conv None uses the mu = 1 structure."""
    if mu_conv is None:
        P, Q = pq_pair(eps_conv, kx, ky)
    else:
        P, Q = pq_matrices(eps_conv, mu_conv, kx, ky)
    kz, E = eigen_decomposition(P, Q, broadening, backend)
    if need_modes:
        sol, ins = layer_smatrix(E, kz, P, Q, Vf_inv, omega, thickness,
                                 avoid_pinv, max_pinv)
        out = (sol.S11, sol.S21, sol.G, sol.D, kz, E, sol.H_eigvec)
    else:
        S11, S21, H, ins = _layer_smatrix_tail_nomodes(
            P, E, kz, Vf_inv, omega, thickness, Q if avoid_pinv else None,
            max_pinv)
        out = (S11, S21, kz, E, H)
    return out + (ins,) if avoid_pinv else out


@pinned
def layer_smatrix_pair(eps_conv, kx, ky, Vf_inv, omega, thickness,
                       broadening, backend, mu_conv=None, need_modes=True,
                       avoid_pinv=False, max_pinv=0.005):
    """Patterned-layer S-matrix (reference rcwa.py:1224-1281): eig of
    A = P Q, then the layer's blocks referenced to free space.

    eps_conv (and mu_conv) (..., N, N) complex, kx/ky (..., N) real,
    Vf_inv the free-space V^-1 as a bdp, omega and thickness real; leading
    dimensions broadcast.  Returns (S11, S21, G, D, kz, E, H) when
    ``need_modes``, else (S11, S21, kz, E, H); with ``avoid_pinv`` the
    detached (Pinv, Qinv) metrics follow.  S22 == S11, S12 == S21."""
    rdt = real_dtype_of(eps_conv.dtype)
    omega = torch.as_tensor(omega, dtype=rdt, device=eps_conv.device)
    thickness = torch.as_tensor(thickness, dtype=rdt, device=eps_conv.device)
    return _layer_smatrix_body(eps_conv, kx, ky, Vf_inv, omega, thickness,
                               broadening, backend, mu_conv, need_modes,
                               avoid_pinv, max_pinv)


def _homogeneous_rows(eps, mu, kx, ky, Vf, omega, thickness, need_modes):
    """A homogeneous layer's (S11, S21[, G, D], kz, E, H), densified for
    the fold, with the wavelengths' leading dimension."""
    sol = layer_smatrix_homogeneous(eps, mu, kx, ky, Vf, omega, thickness)
    S11 = bdp_dense(sol.S11)
    modes = (bdp_dense(sol.G), bdp_dense(sol.D)) if need_modes else ()
    E = bdp_dense(sol.E_eigvec).expand(S11.shape)
    return (S11, bdp_dense(sol.S21)) + modes + (
        sol.kz, E, bdp_dense(sol.H_eigvec))


def redheffer_pair(Sm, Sn):
    """Star product of dense S-matrices [S11, S21, S12, S22]."""
    return redheffer_product(Sm, Sn)[0]


def _fold(Ss, Cs, Sin, Sout):
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


@pinned
def solve_stack_pair(spec, freq, inc_ang, azi_ang, eps_grids, thicknesses,
                     eps_in=None, eps_out=None, broadening='auto',
                     eig_backend='kernels', mu_grids=None, eps_scalars=None,
                     mu_scalars=None, mu_in=None, mu_out=None,
                     with_modes=False, avoid_pinv_instability=False,
                     max_pinv_instability=0.005, fold='auto', device=None):
    """Global S-matrix of a layer stack.

    Args:
      spec: StackSpec.  ``spec.homogeneous`` flags the uniform layers: they
        read scalars from ``eps_scalars`` / ``mu_scalars`` (in stack order)
        and skip the eig (O(N) bdp algebra, the class's fast path).
      freq: 1/wavelength, a scalar or a (B,) tensor; the results carry a
        leading B dimension when it is a tensor with one, or when the
        rasters are batched (a scalar freq is then broadcast to their B).
      inc_ang, azi_ang: real scalars (radians).
      eps_grids: [n_patterned, nx, ny] permittivity rasters (real or
        complex) of the patterned layers, in stack order, shared by every
        wavelength of the batch; or [B, n_patterned, nx, ny], one raster
        per lane (B as freq's: the port's counterpart of vmap over the
        rasters).  With them the precision of the solve.  With no
        patterned layer it may be (0, nx, ny) or None, and then
        eps_scalars or the claddings give it; with no layer at all the
        S-matrix is the claddings' alone.
      thicknesses: [n_layers] real (all layers).
      eps_in / eps_out: complex cladding permittivities when
        spec.has_input / spec.has_output.
      mu_grids: [n_patterned, nx, ny] or [B, n_patterned, nx, ny]
        permeability rasters (None: mu = 1, whose structure makes P
        cheaper).
      eps_scalars / mu_scalars: [n_homogeneous] of the homogeneous layers
        (mu_scalars None: 1).
      mu_in / mu_out: cladding permeabilities (None: 1).
      with_modes: also carry each layer's mode-coupling blocks (Cf, Cb)
        through the fold, as ``internals['C']`` (with ``'G'``, ``'D'``),
        for the fields (``fields.fmm_field_adapter``).
      avoid_pinv_instability / max_pinv_instability: the reference's
        fallback in every patterned layer: where max|P P^-1 - I| reaches
        the threshold (a near-singular P at a Wood anomaly) H = Q E Kz^-1.
        The detached per-layer (Pinv, Qinv) metrics are
        ``internals['pinv_instability']``.
      fold: 'unroll', 'scan' or 'auto', the JAX package's choice of
        fold; each names the one loop of ``_fold``, which folds the same
        products in the same order as either.
      device: where the solve runs; None follows the first tensor among
        the permittivities (then freq and thicknesses), else the CUDA card,
        so a stack given only as Python numbers solves on the card.

    Returns ([S11, S21, S12, S22], internals), each block (B, 2N, 2N);
    ``internals['conv']`` and ``['mu_conv']`` are (n_layers, N, N), or
    (n_layers, B, N, N) for batched rasters.
    Forward and backward run in IEEE f32 (``_constants.pinned``).
    """
    hmask = tuple(bool(h) for h in spec.homogeneous) or (
        (False,) * spec.n_layers)
    if len(hmask) != spec.n_layers:
        raise ValueError('spec.homogeneous length != n_layers')
    if fold not in ('auto', 'unroll', 'scan'):
        raise ValueError(f"fold must be 'auto', 'unroll' or 'scan', not "
                         f"{fold!r}")
    pat = [i for i, h in enumerate(hmask) if not h]
    hom = [i for i, h in enumerate(hmask) if h]

    given = (eps_grids, eps_scalars, eps_in if spec.has_input else None,
             eps_out)
    first = torch.as_tensor(next(v for v in given if v is not None))
    cdt = first.dtype if first.is_complex() else complex_dtype_of(first.dtype)
    rdt = real_dtype_of(cdt)
    if device is None:
        device = next((v.device for v in given + (freq, thicknesses)
                       if isinstance(v, torch.Tensor)), 'cuda')
    dev = torch.device(device)
    order, L = spec.order, spec.L
    # the rasters, each (P, 1 | B, nx, ny): shared by the lanes or one a lane
    grids, batched = {}, False
    if pat:
        for key, g in (('eps', eps_grids), ('mu', mu_grids)):
            if g is not None:
                g = torch.as_tensor(g, device=dev)
                batched |= g.dim() == 4
                grids[key] = g.transpose(0, 1) if g.dim() == 4 else g[:, None]
    freq = torch.as_tensor(freq, dtype=rdt, device=dev)
    scalar = freq.dim() == 0 and not batched
    freq = freq.reshape(-1)
    lanes = {freq.shape[0]} | {g.shape[1] for g in grids.values()}
    if len(lanes - {1}) > 1:
        raise ValueError(f'frequencies and rasters give {sorted(lanes)} '
                         f'lanes; one B (or 1) was expected')
    freq = freq.expand(max(lanes))
    omega = 2 * PI_REF * freq
    thicknesses = torch.as_tensor(thicknesses, dtype=rdt, device=dev)
    one = torch.ones((), dtype=cdt, device=dev)

    def cplx(v):
        return one if v is None else torch.as_tensor(v, dtype=cdt, device=dev)

    mu_in, mu_out = cplx(mu_in), cplx(mu_out)
    if spec.has_input:
        eps_in = cplx(eps_in)
        n_ref = csqrt(eps_in * mu_in).real
    else:
        n_ref = torch.ones((), dtype=rdt, device=dev)
    kx, ky = kvectors_real(freq, inc_ang, azi_ang, n_ref, order, L, rdt)
    kz_f = kz_conj_branch(one, kx, ky)
    Vf = vmat(kx, ky, kz_f)
    Vf_inv = bdp_inv(Vf)
    internals = dict(kx=kx, ky=ky, kz_f=kz_f, Vf=Vf)

    # each layer's (S11, S21[, G, D], kz, E, H), leading dimension B
    rows = [None] * spec.n_layers
    conv = mu_conv = None
    if pat:
        conv = material_conv(grids['eps'], order, cdt)   # (P, 1 | B, N, N)
        if 'mu' in grids:
            mu_conv = material_conv(grids['mu'], order, cdt)
        out = _layer_smatrix_body(
            conv, kx, ky, Vf_inv, omega, thicknesses[pat][:, None],
            broadening, eig_backend, mu_conv, with_modes,
            avoid_pinv_instability, max_pinv_instability)
        if avoid_pinv_instability:
            internals['pinv_instability'] = out[-1]
            out = out[:-1]
        for j, i in enumerate(pat):
            rows[i] = tuple(x[j] for x in out)
    if hom:
        eps_h = torch.as_tensor(eps_scalars, dtype=cdt,
                                device=dev).reshape(-1)
        mu_h = (torch.ones(len(hom), dtype=cdt, device=dev)
                if mu_scalars is None else
                torch.as_tensor(mu_scalars, dtype=cdt, device=dev).reshape(-1))
        for j, i in enumerate(hom):
            rows[i] = _homogeneous_rows(eps_h[j], mu_h[j], kx.to(cdt),
                                        ky.to(cdt), Vf, omega,
                                        thicknesses[i], with_modes)

    if spec.n_layers:
        stack = lambda k: torch.stack([r[k] for r in rows])
        base = 4 if with_modes else 2
        if with_modes:
            internals.update(G=stack(2), D=stack(3))
        internals.update(kz=stack(base), E=stack(base + 1),
                         H=stack(base + 2))
        # eps and mu convolution matrices of every layer in stack order
        # (a homogeneous layer's: the scalar times the identity), one a
        # lane for batched rasters
        eye = torch.eye(kx.shape[-1], dtype=cdt, device=dev)
        shape = ((kx.shape[0],) if batched else ()) + eye.shape

        def lanes_of(m):
            return m.expand(shape) if batched else m.reshape(shape)

        convs, mus = [], []
        for i in range(spec.n_layers):
            if hmask[i]:
                j = hom.index(i)
                convs.append(lanes_of(eps_h[j] * eye))
                mus.append(lanes_of(mu_h[j] * eye))
            else:
                j = pat.index(i)
                convs.append(lanes_of(conv[j]))
                mus.append(lanes_of(eye if mu_conv is None else mu_conv[j]))
        internals.update(conv=torch.stack(convs), mu_conv=torch.stack(mus))
        Ss = [[r[0], r[1], r[1], r[0]] for r in rows]
        Cs = ([(torch.cat([r[2], r[3]], -2), torch.cat([r[3], r[2]], -2))
               for r in rows] if with_modes else None)
    else:
        # no layer: the identity S-matrix (the JAX package's empty fold)
        eye = torch.eye(2 * kx.shape[-1], dtype=cdt,
                        device=dev).repeat(kx.shape[0], 1, 1)
        Ss = [[eye, torch.zeros_like(eye), torch.zeros_like(eye),
               eye.clone()]]
        Cs = [] if with_modes else None
    Sin = Sout = None
    if spec.has_input:
        Vi = vmat(kx, ky, kz_conj_branch(eps_in * mu_in, kx, ky))
        internals['Vi'] = Vi
        Sin = [bdp_dense(b) for b in interface_smatrix_in(Vf, Vi)]
    if spec.has_output:
        eps_out = cplx(eps_out)
        Vo = vmat(kx, ky, kz_conj_branch(eps_out * mu_out, kx, ky))
        internals['Vo'] = Vo
        Sout = [bdp_dense(b) for b in interface_smatrix_out(Vf, Vo)]
    S, C = _fold(Ss, Cs, Sin, Sout)
    if with_modes:
        internals['C'] = C
    if scalar:
        S = [s[0] for s in S]
        internals = {k: _drop_batch(k, v) for k, v in internals.items()}
    return S, internals


def _drop_batch(key, v):
    """An internals entry of a scalar-freq solve without the B dimension."""
    if key in ('kx', 'ky', 'kz_f', 'Vf', 'Vi', 'Vo'):
        return v[0]
    if key in ('kz', 'E', 'H', 'G', 'D'):
        return v[:, 0]
    if key == 'pinv_instability':
        return tuple(x[:, 0] for x in v)
    if key == 'C':
        return [(cf[0], cb[0]) for cf, cb in v]
    return v


def _cladding(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def sparam_xy_pair(S, kx, ky, eps_in, eps_out, order, orders, ref_order,
                   polarization='xx', direction='forward',
                   port='transmission', evanescent=1e-3, mu_in=None,
                   mu_out=None):
    """Power-normalised xy S-parameter at the given orders (upstream
    rcwa.py S-parameter, power_norm=True).  kx, ky (..., N) real; the
    result is complex (..., n_orders).  Non-finite values read as 0.  The
    claddings' kz use eps * mu where mu_in / mu_out are given."""
    if mu_in is not None:
        eps_in = _cladding(eps_in, S[0]) * _cladding(mu_in, S[0])
    if mu_out is not None:
        eps_out = _cladding(eps_out, S[0]) * _cladding(mu_out, S[0])
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


def sparam_ps_pair(S, kx, ky, eps_in, eps_out, order, orders, ref_order,
                   polarization='pp', direction='forward',
                   port='transmission', evanescent=1e-3, mu_in=None,
                   mu_out=None):
    """Power-normalised ps S-parameter at the given orders (reference
    rcwa.py:410-521): the xx, xy, yx and yy entries recombined with each
    order's inclination and azimuth.  kx, ky (..., N) real; the result is
    complex (..., n_orders).  The claddings' kz use eps * mu where mu_in /
    mu_out are given.  Zero where the reference order is evanescent; an
    evanescent output order keeps |Re kz| in the normalisation instead of
    0, as the reference does (rcwa.py:490 against 495)."""
    cdt = S[0].dtype
    eps_in, eps_out = _cladding(eps_in, S[0]), _cladding(eps_out, S[0])
    if mu_in is not None:
        eps_in = eps_in * _cladding(mu_in, S[0])
    if mu_out is not None:
        eps_out = eps_out * _cladding(mu_out, S[0])
    N = (2 * order[0] + 1) * (2 * order[1] + 1)
    t = lambda i: torch.as_tensor(i, device=kx.device)
    oi = t(matching_indices(orders, order))
    ri = t(matching_indices(np.asarray(ref_order).reshape(1, 2), order))
    idx, o_sign, r_sign, o_eps, r_eps = {
        ('forward', 'transmission'): (0, 1., 1., eps_out, eps_in),
        ('forward', 'reflection'): (1, -1., 1., eps_in, eps_in),
        ('backward', 'reflection'): (2, 1., -1., eps_out, eps_out),
        ('backward', 'transmission'): (3, -1., -1., eps_in, eps_out),
    }[(direction, port)]

    def kz_c(eps, kxs, kys):
        return csqrt(eps - (kxs ** 2).to(cdt) - (kys ** 2).to(cdt))

    def angles(sel, eps, sign):
        kxs, kys = kx[..., sel], ky[..., sel]
        kzc = kz_c(eps, kxs, kys)
        kz = sign * torch.abs(kzc.real)
        evan = torch.abs(kzc.real / kzc.imag) < evanescent
        return (torch.atan2(torch.sqrt(kxs ** 2 + kys ** 2), kz),
                torch.atan2(kys, kxs), evan)

    o_inc, o_azi, o_evan = angles(oi, o_eps, o_sign)
    r_inc, r_azi, r_evan = angles(ri, r_eps, r_sign)
    Sb = S[idx]
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

    def kz_real(eps, keep_abs_for_evan):
        kzc = kz_c(eps, kx, ky)
        ev = torch.abs(kzc.real / kzc.imag) < evanescent
        return torch.where(ev, torch.abs(kzc.real) if keep_abs_for_evan
                           else torch.zeros_like(kzc.real), kzc.real)

    kz_in, kz_out = kz_real(eps_in, False), kz_real(eps_out, True)
    num_kz, den_kz = {('forward', 'transmission'): (kz_out, kz_in),
                      ('forward', 'reflection'): (kz_in, kz_in),
                      ('backward', 'reflection'): (kz_out, kz_out),
                      ('backward', 'transmission'): (kz_in, kz_out),
                      }[(direction, port)]
    s = s * torch.sqrt(num_kz[..., oi] / den_kz[..., ri])
    bad = ~torch.isfinite(s.real) | ~torch.isfinite(s.imag) | r_evan
    return torch.where(bad, torch.zeros_like(s), s)


def source_fourier_pair(order, amplitude, orders, direction='forward',
                        notation='xy', kx=None, ky=None, eps_in=None,
                        mu_in=None, eps_out=None, mu_out=None,
                        rdtype=torch.float32, device=None):
    """Incident Fourier amplitudes for the functional path (reference
    rcwa.py:539-596, the class's ``source_fourier``).

    Args:
      order: (order_x, order_y).
      amplitude: [n_orders, 2] complex (x, y) or, in 'ps' notation, (p, s)
        amplitudes per order (array or tensor).
      orders: [[m, n], ...] diffraction orders.
      notation: 'xy' or 'ps'; 'ps' needs kx / ky (real, from
        solve_stack_pair's internals) and the source side's cladding
        eps / mu (None: 1).
      rdtype: the precision (float32 gives complex64).
      device: where E_i is made; None follows kx, else a tensor amplitude,
        else the CUDA card.

    Returns E_i, complex (2N,), or (..., 2N) for kx of shape (..., N) in
    'ps' notation.
    """
    cdt = complex_dtype_of(rdtype)
    if device is None:
        device = (kx.device if kx is not None else amplitude.device
                  if isinstance(amplitude, torch.Tensor) else 'cuda')
    if not isinstance(amplitude, torch.Tensor):
        amplitude = np.asarray(amplitude, dtype=np.complex128)
    amp = torch.as_tensor(amplitude, dtype=cdt, device=device).reshape(-1, 2)
    N = (2 * order[0] + 1) * (2 * order[1] + 1)
    idx = torch.as_tensor(matching_indices(orders, order), device=device)
    E_i = amp.new_zeros(2 * N).index_put((idx,), amp[:, 0]) \
        .index_put((idx + N,), amp[:, 1])
    if notation == 'ps':
        fwd = direction == 'forward'
        em = [torch.as_tensor(1. if v is None else v, dtype=cdt,
                              device=device)
              for v in ((eps_in, mu_in) if fwd else (eps_out, mu_out))]
        kzc = csqrt(em[0] * em[1] - (kx ** 2).to(cdt) - (ky ** 2).to(cdt))
        kz = (1. if fwd else -1.) * torch.abs(kzc.real)
        inc = torch.atan2(torch.sqrt(kx ** 2 + ky ** 2), kz)
        azi = torch.atan2(ky, kx)
        # the ps -> xy block-diagonal rotation (rcwa.py:589-594), real
        ep, es = E_i[:N], E_i[N:]
        E_i = torch.cat([torch.cos(inc) * torch.cos(azi) * ep
                         - torch.sin(azi) * es,
                         torch.cos(inc) * torch.sin(azi) * ep
                         + torch.cos(azi) * es], -1)
    return E_i


def source_planewave_pair(order, amplitude=(1., 0.), direction='forward',
                          notation='xy', **kw):
    """Plane-wave source: the Fourier source at order (0, 0)
    (rcwa.py:526-537)."""
    amp = (amplitude.reshape(1, 2) if isinstance(amplitude, torch.Tensor)
           else np.asarray(amplitude).reshape(1, 2))
    return source_fourier_pair(order, amp, [[0, 0]], direction, notation,
                               **kw)


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
