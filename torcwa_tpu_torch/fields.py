"""Field reconstruction on xz, yz and xy planes for the class API.

Counterpart of the segment engine of ``torcwa_tpu/fields.py``
(``_region_fourier_fields``, ``_layer_segments``, ``_synth``,
``field_plane``, ``field_xy``), on complex tensors:

* the z samples are grouped into contiguous runs inside one region (the
  input cladding, internal layer i, the output cladding), as the
  reference's per-z branching assigns them;
* the Fourier-domain fields of a run's samples come from one
  (2N, 2N) x (2N, nz) product with the mode-phase matrix;
* the spatial field is synthesised by a dense DFT product, which takes
  arbitrary sample axes (reference rcwa.py:699-705).

The reconstruction reads the solved ``rcwa`` instance's state, or the
same state built by :class:`fmm_field_adapter` from the functional solve's
outputs, runs in IEEE f32 forward and backward (``_constants.pinned``),
and returns at the solver's output convention.  The axes are concrete:
which region a z sample lies in is decided on the host.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import torch

from ._constants import pinned
from .core import LayerSolution, bdp_apply, bdp_dense
from .ops.cplx import csqrt

__all__ = ['field_plane', 'field_xy', 'fmm_field_adapter']


class fmm_field_adapter:
    """The solved state that :func:`field_plane` and :func:`field_xy`
    read, built from ``fmm.solve_stack_pair`` outputs, so the fields of a
    functional solve come from the class's engine unchanged.

    Args:
      spec: the StackSpec the stack was solved with.
      S: the global S blocks of ``solve_stack_pair`` at one wavelength (a
        scalar freq).
      internals: its internals; a stack with layers needs
        ``with_modes=True`` (the ``'C'`` entry).
      E_i: the incident amplitudes, complex (2N,) or (2N, 1) (e.g.
        ``fmm.source_planewave_pair``).
      thicknesses: the layer thicknesses, concrete: which region a z
        sample lies in is decided on the host.
      omega: 2 pi freq.
      eps_in, mu_in, eps_out, mu_out: the claddings (None: 1).
      source_direction: 'forward' or 'backward'.

    The fields come back as complex tensors, on the device of the solve.
    """

    def __init__(self, spec, S, internals, E_i, thicknesses, omega,
                 eps_in=None, mu_in=None, eps_out=None, mu_out=None,
                 source_direction='forward'):
        kx = internals['kx']
        if kx.dim() != 1:
            raise ValueError('fmm_field_adapter takes one wavelength: solve '
                             'with a scalar freq')
        cdt = S[0].dtype
        self._rdtype, self._device = kx.dtype, kx.device
        c = lambda v: torch.as_tensor(1. if v is None else v, dtype=cdt,
                                      device=kx.device)
        self.order_N = kx.shape[-1]
        self.omega = omega
        self.Kx_norm_dn = kx.to(cdt)
        self.Ky_norm_dn = internals['ky'].to(cdt)
        self.E_i_vec = torch.as_tensor(E_i, dtype=cdt,
                                       device=kx.device).reshape(-1, 1)
        self.eps_in, self.mu_in = c(eps_in), c(mu_in)
        self.eps_out, self.mu_out = c(eps_out), c(mu_out)
        self.Vf = internals['Vf']
        self._has_input_layer = spec.has_input
        self._has_output_layer = spec.has_output
        self.Vi = internals.get('Vi')
        self.Vo = internals.get('Vo')
        self.S = S
        self.source_direction = source_direction
        self.layer_N = spec.n_layers
        self.thickness = [float(t) for t in
                          np.asarray(torch.as_tensor(thicknesses).detach()
                                     .cpu()).reshape(-1)]
        self.C, self.layers, self.eps_conv, self.mu_conv = [], [], [], []
        if spec.n_layers:
            if 'C' not in internals:
                raise ValueError(
                    'field reconstruction over internal layers needs '
                    'solve_stack_pair(..., with_modes=True)')
            self.C = internals['C']
            self.layers = [LayerSolution(
                S11=None, S21=None, G=None, D=None, kz=internals['kz'][i],
                E_eigvec=internals['E'][i], H_eigvec=internals['H'][i])
                for i in range(spec.n_layers)]
            self.eps_conv = list(internals['conv'])
            self.mu_conv = list(internals['mu_conv'])
        # the functional solve densifies its homogeneous layers
        self._layer_is_bd = [False] * spec.n_layers

    def _out(self, z):
        return z


def _zphase(kz, omega, z):
    """exp(1j omega kz z) as a (len(kz), len(z)) matrix."""
    return torch.exp(1j * omega * kz[:, None] * z[None, :])


def _region_fourier_fields(sim, region, z_prop):
    """Fourier coefficients (6, N, nz) of (Ex, Ey, Ez, Hx, Hy, Hz) at the
    z samples z_prop (each measured from its region's own boundary) of
    one region: -1 (input cladding), sim.layer_N (output cladding) or an
    internal layer's index."""
    N = sim.order_N
    omega = sim.omega
    Kx, Ky = sim.Kx, sim.Ky
    z = torch.as_tensor(z_prop, dtype=Kx.real.dtype, device=Kx.device)
    E_i = sim.E_i                                      # (2N, 1)
    Kxc, Kyc = Kx[:, None], Ky[:, None]
    fwd = sim.source_direction == 'forward'

    if region == -1 or region == sim.layer_N:
        inp = region == -1
        eps, mu = ((sim.eps_in, sim.mu_in) if inp
                   else (sim.eps_out, sim.mu_out))
        V = (sim.Vi if sim.has_input else sim.Vf) if inp else \
            (sim.Vo if sim.has_output else sim.Vf)
        kz = csqrt(eps * mu - (Kx * Kx + Ky * Ky))
        # the input cladding keeps the Im(kz) <= 0 branch (rcwa.py:650)
        kz = torch.complex(kz.real, -kz.imag.abs() if inp
                           else kz.imag.abs())
        z_phase = _zphase(torch.cat([kz, kz]), omega, z)     # (2N, nz)
        z_conj = z_phase.conj()
        zero = torch.zeros_like(z_phase)
        if inp and fwd:
            Exy_p = E_i * z_phase
            Exy_m = (sim.S[1] @ E_i) * z_conj
        elif inp:
            Exy_p = zero
            Exy_m = (sim.S[3] @ E_i) * z_conj
        elif fwd:
            Exy_p = (sim.S[0] @ E_i) * z_phase
            Exy_m = zero
        else:
            Exy_p = (sim.S[2] @ E_i) * z_phase
            Exy_m = E_i * z_conj
        Hxy_p = bdp_apply(V, Exy_p)
        Hxy_m = -bdp_apply(V, Exy_m)
        Ex = Exy_p[:N] + Exy_m[:N]
        Ey = Exy_p[N:] + Exy_m[N:]
        Hx = Hxy_p[:N] + Hxy_m[:N]
        Hy = Hxy_p[N:] + Hxy_m[N:]
        Hz = (Kxc * Ey - Kyc * Ex) / mu
        Ez = (Kyc * Hx - Kxc * Hy) / eps
        return torch.stack([Ex, Ey, Ez, Hx, Hy, Hz])

    # an internal layer
    lay = sim.layers[region]
    cf, cb = sim.C[region]
    c = (cf if fwd else cb) @ E_i                      # (4N, 1)
    cp, cm = c[:2 * N, 0], c[2 * N:, 0]
    E, H = lay.E_eigvec, lay.H_eigvec
    if sim.is_bd[region]:
        E, H = bdp_dense(E), bdp_dense(H)
    thick = torch.as_tensor(sim.thickness[region], dtype=z.dtype,
                            device=z.device)
    pp = _zphase(lay.kz, omega, z)                     # (2N, nz)
    pm = _zphase(lay.kz, omega, thick - z)
    Exy = (E * cp) @ pp + (E * cm) @ pm
    Hxy = (H * cp) @ pp - (H * cm) @ pm
    Ex, Ey = Exy[:N], Exy[N:]
    Hx, Hy = Hxy[:N], Hxy[N:]
    Hz = torch.linalg.inv(sim.mu_conv[region]) @ (Kxc * Ey - Kyc * Ex)
    Ez = torch.linalg.inv(sim.eps_conv[region]) @ (Kyc * Hx - Kxc * Hy)
    return torch.stack([Ex, Ey, Ez, Hx, Hy, Hz])


def _layer_segments(sim, z_axis):
    """Each z sample's region, in contiguous runs, and its distance from
    that region's boundary, clamped as the reference does
    (rcwa.py:624-634: region -1 for z < 0, and each cumulative boundary
    crossed strictly raises the region by one)."""
    z = np.asarray(z_axis, dtype=np.float64).reshape(-1)
    thick = np.array([float(t.detach()) if isinstance(t, torch.Tensor)
                      else float(t) for t in sim.thickness], dtype=np.float64)
    zp = np.cumsum(thick)
    zm = np.concatenate([[0.0], zp[:-1]]) if len(zp) else np.zeros((0,))
    region = np.zeros(len(z), dtype=np.int64)
    region[z < 0.] = -1
    for b in zp:
        region[z > b] += 1

    z_prop = np.zeros_like(z)
    for i, (zi, r) in enumerate(zip(z, region)):
        if r == -1:
            z_prop[i] = zi if zi <= 0. else 0.
        elif r == sim.layer_N:
            z_prop[i] = zi if len(zp) == 0 else max(zi - zp[-1], 0.)
        else:
            z_prop[i] = zi - zm[r]

    runs = []
    start = 0
    for i in range(1, len(z) + 1):
        if i == len(z) or region[i] != region[start]:
            runs.append((int(region[start]), start, i))
            start = i
    return runs, z_prop


def _synth(phase, f_mn):
    """Spatial synthesis: (t, N) phases times (6, N, nz) coefficients."""
    return torch.einsum('tn,fnz->ftz', phase, f_mn)


def _state(sim):
    """What the reconstruction reads of a solved instance: its tensors
    (the inputs of the pinned graph) and its flags."""
    return dict(
        Kx=sim.Kx_norm_dn, Ky=sim.Ky_norm_dn, E_i=sim.E_i_vec, S=sim.S,
        C=sim.C, omega=sim.omega, Vf=sim.Vf,
        Vi=sim.Vi if sim._has_input_layer else None,
        Vo=sim.Vo if sim._has_output_layer else None,
        eps_in=sim.eps_in, mu_in=sim.mu_in, eps_out=sim.eps_out,
        mu_out=sim.mu_out, layers=sim.layers, eps_conv=sim.eps_conv,
        mu_conv=sim.mu_conv, thickness=sim.thickness,
        is_bd=sim._layer_is_bd, layer_N=sim.layer_N, order_N=sim.order_N,
        has_input=sim._has_input_layer, has_output=sim._has_output_layer,
        source_direction=sim.source_direction)


@pinned
def _plane(st, plane, t, fixed, runs, z_prop):
    sim = SimpleNamespace(**st)
    if plane == 'xz':
        th = sim.Kx[None, :] * t[:, None] + sim.Ky[None, :] * fixed
    else:
        th = sim.Kx[None, :] * fixed + sim.Ky[None, :] * t[:, None]
    xy_phase = torch.exp(1j * sim.omega * th)
    return torch.cat([_synth(xy_phase, _region_fourier_fields(
        sim, region, z_prop[i0:i1])) for region, i0, i1 in runs], dim=2)


def field_plane(sim, plane, t_axis, z_axis, fixed):
    """Fields on an xz or yz plane.

    Args:
      sim: solved rcwa instance with a source.
      plane: 'xz' (t_axis = x, fixed = y) or 'yz' (t_axis = y, fixed = x).
      t_axis, z_axis: sampling coordinates; fixed: the other transverse
        coordinate.

    Returns ([Ex, Ey, Ez], [Hx, Hy, Hz]), each (len(t_axis), len(z_axis)),
    at the solver's output convention.
    """
    if plane not in ('xz', 'yz'):
        raise ValueError(f'Unknown plane {plane!r}')
    t = torch.as_tensor(t_axis, dtype=sim._rdtype,
                        device=sim._device).reshape(-1)
    runs, z_prop = _layer_segments(sim, z_axis)
    out = _plane(_state(sim), plane, t, fixed, runs, z_prop)
    return ([sim._out(out[k]) for k in range(3)],
            [sim._out(out[k]) for k in range(3, 6)])


@pinned
def _xy(st, layer_num, z_prop, x, y):
    sim = SimpleNamespace(**st)
    f_mn = _region_fourier_fields(sim, layer_num, np.array([z_prop]))[..., 0]
    phase_x = torch.exp(1j * sim.omega * sim.Kx[None, :] * x[:, None])
    phase_y = torch.exp(1j * sim.omega * sim.Ky[None, :] * y[:, None])
    return torch.einsum('xn,fn,yn->fxy', phase_x, f_mn, phase_y)


def field_xy(sim, layer_num, x_axis, y_axis, z_prop=0.):
    """Fields on an xy plane at z_prop inside region ``layer_num`` (-1 the
    input cladding, sim.layer_N the output cladding) (rcwa.py:959-1112).
    A layer_num that is not an int or out of range warns and gives None."""
    if not isinstance(layer_num, int):
        warnings.warn('Parameter "layer_num" must be int type. Return None.',
                      UserWarning)
        return None
    if layer_num < -1 or layer_num > sim.layer_N:
        warnings.warn('Layer number is out of range. Return None.',
                      UserWarning)
        return None
    if layer_num == -1:
        z_prop = z_prop if z_prop <= 0. else 0.
    elif layer_num == sim.layer_N:
        z_prop = z_prop if z_prop >= 0. else 0.
    as_axis = lambda a: torch.as_tensor(a, dtype=sim._rdtype,
                                        device=sim._device).reshape(-1)
    out = _xy(_state(sim), layer_num, float(z_prop), as_axis(x_axis),
              as_axis(y_axis))
    return ([sim._out(out[k]) for k in range(3)],
            [sim._out(out[k]) for k in range(3, 6)])
