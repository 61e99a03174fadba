"""RCWA solver with the reference-compatible, differentiable class API.

Counterpart of ``torcwa_tpu/solver.py``: ``rcwa`` has the reference
solver's method names, arguments and conventions (Lorentz-Heaviside
units, c = 1, exp(-j w t)), so a reference script ports with an import
change.  Every heavy stage is a pure function of complex tensors wrapped in
``_constants.pinned``, so the class works under autograd, each method's
forward and backward run in IEEE f32, and the state between methods is
plain tensors under the JAX class's attribute names (``Kx_norm_dn``,
``Vf``, ``layers``, ``_layer_is_bd``, ``S``, ``C``, ``eps_conv``,
``mu_conv``, ``Pinv_instability``, ...), which ``fields.py`` reads.

A patterned layer's eigenmodes go through ``ops.eig`` and, with
``eig_backend='auto'`` or ``'kernels'``, through the hand-written CUDA
kernels (``ops/eig_qr.py``); a homogeneous layer (scalar eps and mu) stays
in O(N) block-diagonal algebra.  The solver runs on ``device``: the CUDA
card unless the caller passes ``device='cpu'``.

This module owns the class front end: the argument conventions, the
k-grids (a complex incidence angle, measured in either cladding) and the
state.  The layer algebra and every stage after the layers (free space
and the claddings, the Redheffer fold, the S-parameters and the source)
are ``core.py``'s, the same functions that the functional solve
(``fmm``) runs.
"""

import warnings

import numpy as np
import torch

from ._constants import PI_REF, pinned, real_dtype_of, validate_sim_dtype
from . import core
from . import fields as _fields
from .core import bdp_dense
from .ops.cplx import csqrt
from .ops.eig import Eig
from .ops.fourier import material_conv

__all__ = ['rcwa']

# eig backends by the names the class takes: the hand-written kernels
# ('auto', and the JAX package's 'qr'), or torch.linalg.eig ('torch', and
# the JAX package's host-LAPACK 'callback')
_BACKENDS = {'auto': 'kernels', 'kernels': 'kernels', 'qr': 'kernels',
             'torch': 'torch', 'callback': 'torch'}


# ---------------------------------------------------------------------------
# Pure stages (the class keeps their results as its state)
# ---------------------------------------------------------------------------

@pinned
def _kvectors(inc, azi, eps_ang, mu_ang, ox, oy, Gx, Gy, clad_in, clad_out):
    """k-vector grids, then free space and the claddings on them
    (``core.claddings``); clad_in / clad_out are (eps, mu) or None."""
    n_med = csqrt(eps_ang * mu_ang).real
    kx0 = n_med * torch.sin(inc) * torch.cos(azi)
    ky0 = n_med * torch.sin(inc) * torch.sin(azi)
    kx, ky = kx0 + ox * Gx, ky0 + oy * Gy
    Kx = kx[:, None].expand(-1, len(ky)).reshape(-1)
    Ky = ky[None, :].expand(len(kx), -1).reshape(-1)
    return dict(core.claddings(Kx, Ky, clad_in, clad_out), kx0=kx0, ky0=ky0,
                Kx=Kx, Ky=Ky)


@pinned
def _patterned_layer(eps_c, mu_c, Kx, Ky, Vf_inv, omega, thickness,
                     broadening, backend, stable_grad, avoid_pinv, max_pinv):
    P, Q = core.pq_matrices(eps_c, mu_c, Kx, Ky)
    kz, E = core.eigen_decomposition(P, Q, broadening, backend, stable_grad)
    return core.layer_smatrix(E, kz, P, Q, Vf_inv, omega, thickness,
                              avoid_pinv_instability=avoid_pinv,
                              max_pinv_instability=max_pinv)


_homogeneous_layer = pinned(core.layer_smatrix_homogeneous)
_diffraction_angles = pinned(core.diffraction_angles)
_conv_to_grid = pinned(core.conv_to_grid)
_global_smatrix = pinned(core.fold)
_s_parameters = pinned(core.sparams)
_incident = pinned(core.incident_amplitudes)


def _is_scalar_like(v):
    """Homogeneity test of the reference (rcwa.py:156-157)."""
    if isinstance(v, (int, float, complex)):
        return True
    arr = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return arr.ndim == 0 or (arr.ndim == 1 and arr.shape[0] == 1)


def _pick(value, names, default, what):
    for canon, aliases in names.items():
        if value in aliases:
            return canon
    warnings.warn(f'Invalid {what}. Set as {default}.', UserWarning)
    return default


_DIRECTIONS = {'forward': ('f', 'forward'), 'backward': ('b', 'backward')}
_POLARIZATIONS = ('xx', 'yx', 'xy', 'yy', 'pp', 'sp', 'ps', 'ss')


class rcwa:
    """Rigorous coupled-wave analysis (Fourier modal method).

    Parameters mirror the reference (rcwa.py:9-33) and the JAX class:
      freq: simulation frequency (1 / length unit)
      order: [order_x, order_y] Fourier truncation
      L: [Lx, Ly] lattice constants
      dtype: torch.complex64 (default) or torch.complex128
      device: where the solve runs; the CUDA card by default (None too),
        ``'cpu'`` on request
      stable_eig_grad: the broadened eig backward (else unbroadened)
      avoid_Pinv_instability / max_Pinv_instability: the P-inverse
        fallback and its threshold
      eig_backend: 'auto' or 'kernels' (the hand-written eig kernels; on
        a CPU tensor their plain versions), 'torch' (torch.linalg.eig);
        the JAX names 'qr' and 'callback' mean 'kernels' and 'torch'.  The
        kernels take complex64 only: a complex128 solver on the card needs
        ``eig_backend='torch'`` and raises TypeError without it.
      output: 'auto' or 'complex' (extraction methods return complex
        tensors) or 'pair' ((real, imag) tuples).

    Broadening: with ``stable_eig_grad=True`` the eig backward uses
    ``Eig.broadening_parameter`` if the user changed it from the
    reference's default 1e-10, else the dtype-aware 'auto' value (1e-10 at
    float64, 1e-6 at float32).  So setting it to 1e-10 explicitly still
    means 'auto': at float32, 1e-10 lies far below the eigensolver's noise
    and inflates gradients ~100x.
    """

    def __init__(self, freq, order, L, *, dtype=torch.complex64,
                 device='cuda', stable_eig_grad=True,
                 avoid_Pinv_instability=False, max_Pinv_instability=0.005,
                 eig_backend='auto', output='auto'):
        self._dtype = validate_sim_dtype(dtype)
        self._rdtype = real_dtype_of(self._dtype)
        self._device = torch.device('cuda' if device is None else device)
        if eig_backend not in _BACKENDS:
            raise ValueError(f'Unknown eig backend: {eig_backend!r} (one of '
                             f'{sorted(_BACKENDS)})')
        self.eig_backend = _BACKENDS[eig_backend]
        if self._device.type == 'cuda' and self._dtype == torch.complex128 \
                and self.eig_backend == 'kernels':
            raise TypeError(
                "a complex128 solve on a CUDA device needs "
                "eig_backend='torch': the eig kernels take complex64 only "
                "(ROADMAP.md, Queue 2b item 5)")
        if output not in ('auto', 'complex', 'pair'):
            warnings.warn('Invalid output mode. Set as complex.', UserWarning)
            output = 'complex'
        self._complex_out = output != 'pair'
        self.stable_eig_grad = bool(stable_eig_grad)

        on = avoid_Pinv_instability is True
        self.avoid_Pinv_instability = on
        self.max_Pinv_instability = float(max_Pinv_instability) if on else None
        self.Pinv_instability = [] if on else None
        self.Qinv_instability = [] if on else None

        # simulation parameters (rcwa.py:59-72)
        self.freq = freq
        self.omega = 2 * PI_REF * freq
        self.order = [int(order[0]), int(order[1])]
        self.order_x = np.arange(-self.order[0], self.order[0] + 1)
        self.order_y = np.arange(-self.order[1], self.order[1] + 1)
        self.order_N = len(self.order_x) * len(self.order_y)
        self.L = L
        self.Gx_norm = 1 / (L[0] * freq)
        self.Gy_norm = 1 / (L[1] * freq)

        # claddings default to free space (rcwa.py:74-78)
        self.eps_in = self._p(1.)
        self.mu_in = self._p(1.)
        self.eps_out = self._p(1.)
        self.mu_out = self._p(1.)
        self._has_input_layer = False
        self._has_output_layer = False

        # layer state (rcwa.py:80-93)
        self.layer_N = 0
        self.thickness = []
        self.eps_conv, self.mu_conv = [], []
        self.layers = []          # list[core.LayerSolution]
        self._layer_is_bd = []    # True for homogeneous (bdp) layers

    # -- conversions ------------------------------------------------------

    def _p(self, x):
        """User input (number, array or tensor) as a complex tensor of the
        simulation's dtype on its device; a tensor keeps its graph."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self._device, dtype=self._dtype)
        return torch.as_tensor(np.asarray(x), dtype=self._dtype,
                               device=self._device)

    def _r(self, x):
        """A real parameter (thickness, omega) as a real tensor."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self._device, dtype=self._rdtype)
        return torch.as_tensor(x, dtype=self._rdtype, device=self._device)

    def _out(self, z):
        """The output convention: a complex tensor or a (real, imag) pair."""
        return z if self._complex_out else (z.real, z.imag)

    @property
    def _broadening(self):
        """The eig backward's broadening: ``Eig.broadening_parameter`` if
        the user changed it from the reference default 1e-10, else 'auto'."""
        b = Eig.broadening_parameter
        return 'auto' if b == 1e-10 else b

    # -- setup ------------------------------------------------------------

    def add_input_layer(self, eps=1., mu=1.):
        """The semi-infinite input cladding (rcwa.py:95-107)."""
        self.eps_in = self._p(eps)
        self.mu_in = self._p(mu)
        self._has_input_layer = True
        self.Sin = []

    def add_output_layer(self, eps=1., mu=1.):
        """The semi-infinite output cladding (rcwa.py:109-121)."""
        self.eps_out = self._p(eps)
        self.mu_out = self._p(mu)
        self._has_output_layer = True
        self.Sout = []

    def set_incident_angle(self, inc_ang, azi_ang, angle_layer='input'):
        """Incidence and azimuth (radians), measured in the input or the
        output cladding; builds the k-vectors (rcwa.py:123-144)."""
        self.inc_ang = self._p(inc_ang)
        self.azi_ang = self._p(azi_ang)
        self.angle_layer = _pick(
            angle_layer, {'input': ('i', 'in', 'input'),
                          'output': ('o', 'out', 'output')},
            'input', 'angle layer')
        self._kvectors()

    def add_layer(self, thickness, eps=1., mu=1.):
        """Add one internal layer and solve its eigenmodes and S-matrix
        now (rcwa.py:146-170).  Scalar eps and mu make a homogeneous layer;
        a raster (nx, ny) of either makes a patterned one."""
        is_eps_h = _is_scalar_like(eps)
        is_mu_h = _is_scalar_like(mu)
        N = self.order_N
        eye = torch.eye(N, dtype=self._dtype, device=self._device)

        def conv(v, homogeneous):
            v = self._p(v)
            if homogeneous:
                v = v.reshape(())
                return v, v * eye
            return v, material_conv(v, self.order, self._dtype)

        eps_v, eps_c = conv(eps, is_eps_h)
        mu_v, mu_c = conv(mu, is_mu_h)
        self.eps_conv.append(eps_c)
        self.mu_conv.append(mu_c)
        self.layer_N += 1
        self.thickness.append(thickness)
        omega, t = self._r(self.omega), self._r(thickness)

        if is_eps_h and is_mu_h:
            sol = _homogeneous_layer(eps_v, mu_v, self.Kx_norm_dn,
                                     self.Ky_norm_dn, self.Vf, omega, t)
        else:
            sol, instability = _patterned_layer(
                eps_c, mu_c, self.Kx_norm_dn, self.Ky_norm_dn, self.Vf_inv,
                omega, t,
                self._broadening if self.stable_eig_grad else 0.0,
                self.eig_backend, self.stable_eig_grad,
                self.avoid_Pinv_instability,
                self.max_Pinv_instability if self.avoid_Pinv_instability
                else 0.005)
            if instability is not None:
                self.Pinv_instability.append(instability[0])
                self.Qinv_instability.append(instability[1])
        self.layers.append(sol)
        self._layer_is_bd.append(is_eps_h and is_mu_h)

    # -- global solve -----------------------------------------------------

    def solve_global_smatrix(self):
        """Fold the layers' S-matrices and the claddings' by Redheffer star
        products, propagating the mode-coupling blocks (rcwa.py:173-211;
        ``core.fold``).  S22 == S11 and S12 == S21 in a layer; Cf = [G; D],
        Cb = [D; G]."""
        Ss, Cs = [], []
        for sol, bd in zip(self.layers, self._layer_is_bd):
            s11, s21, G, D = (bdp_dense(m) if bd else m
                              for m in (sol.S11, sol.S21, sol.G, sol.D))
            Ss.append([s11, s21, s21, s11])
            Cs.append((torch.cat([G, D]), torch.cat([D, G])))
        if not Ss:
            eye = torch.eye(2 * self.order_N, dtype=self._dtype,
                            device=self._device)
            Ss = [[eye, torch.zeros_like(eye), torch.zeros_like(eye), eye]]
        Sin = ([bdp_dense(b) for b in self.Sin] if self._has_input_layer
               else None)
        Sout = ([bdp_dense(b) for b in self.Sout] if self._has_output_layer
                else None)
        self.S, self.C = _global_smatrix(Ss, Cs, Sin, Sout)

    # -- extraction -------------------------------------------------------

    def diffraction_angle(self, orders, *, layer='output', unit='radian'):
        """Propagation angles (inclination, azimuth) of the given orders in
        a cladding (rcwa.py:214-262)."""
        layer = _pick(layer, {'input': ('i', 'in', 'input'),
                              'output': ('o', 'out', 'output')},
                      'output', 'layer')
        unit = _pick(unit, {'radian': ('r', 'rad', 'radian'),
                            'degree': ('d', 'deg', 'degree')},
                     'radian', 'unit')
        eps, mu = ((self.eps_in, self.mu_in) if layer == 'input'
                   else (self.eps_out, self.mu_out))
        return _diffraction_angles(self.Kx_norm_dn, self.Ky_norm_dn, eps, mu,
                                   orders, self.order, unit)

    def return_layer(self, layer_num, nx=100, ny=100):
        """A layer's eps and mu rasters recovered from its truncated
        Fourier coefficients (rcwa.py:264-298)."""
        return (self._out(_conv_to_grid(self.eps_conv[layer_num], self.order,
                                        nx, ny)),
                self._out(_conv_to_grid(self.mu_conv[layer_num], self.order,
                                        nx, ny)))

    def S_parameters(self, orders, *, direction='forward',
                     port='transmission', polarization='xx',
                     ref_order=[0, 0], power_norm=True, evanscent=1e-3):
        """S-parameters at the given diffraction orders (rcwa.py:300-524):
        xy ('xx', 'yx', 'xy', 'yy') and ps ('pp', 'sp', 'ps', 'ss')
        polarizations, the reference's power normalization and zeroing of
        evanescent orders, its asymmetric handling of evanescent output
        orders in the ps basis included."""
        direction = _pick(direction, _DIRECTIONS, 'forward',
                          'propagation direction')
        port = _pick(port, {'transmission': ('t', 'transmission'),
                            'reflection': ('r', 'reflection')},
                     'transmission', 'port')
        polarization = _pick(polarization, {p: (p,) for p in _POLARIZATIONS},
                             'xx', 'polarization')
        return self._out(_s_parameters(
            self.S, self.Kx_norm_dn.real, self.Ky_norm_dn.real,
            (self.eps_in, self.mu_in), (self.eps_out, self.mu_out),
            core.matching_indices(orders, self.order),
            core.matching_indices(ref_order, self.order), polarization,
            direction, port, power_norm, evanscent))

    # -- sources ----------------------------------------------------------

    def source_planewave(self, *, amplitude=[1., 0.], direction='forward',
                         notation='xy'):
        """Plane-wave source: the Fourier source at order (0, 0)
        (rcwa.py:526-537)."""
        self.source_fourier(amplitude=amplitude, orders=[0, 0],
                            direction=direction, notation=notation)

    def source_fourier(self, *, amplitude, orders, direction='forward',
                       notation='xy'):
        """Incident Fourier amplitudes at the given orders, (x, y) or
        (p, s) pairs (rcwa.py:539-596)."""
        if not isinstance(amplitude, torch.Tensor):
            amplitude = np.asarray(amplitude, dtype=np.complex128)
        amp = self._p(amplitude).reshape(-1, 2)
        direction = _pick(direction, _DIRECTIONS, 'forward',
                          'source direction')
        if notation not in ('xy', 'ps'):
            warnings.warn('Invalid amplitude notation. Set as xy notation.',
                          UserWarning)
            notation = 'xy'
        self.source_direction = direction
        fwd = direction == 'forward'
        clad = ((self.eps_in, self.mu_in) if fwd
                else (self.eps_out, self.mu_out))
        self.E_i_vec = _incident(
            amp, core.matching_indices(orders, self.order), self.order_N,
            self.Kx_norm_dn.real, self.Ky_norm_dn.real,
            clad if notation == 'ps' else None, 1. if fwd else -1.)[:, None]

    @property
    def E_i(self):
        """The incident Fourier amplitudes (2N, 1), at the output
        convention."""
        return self._out(self.E_i_vec)

    # -- field reconstruction ---------------------------------------------

    def field_xz(self, x_axis, z_axis, y):
        """Fields on the xz plane at fixed y (rcwa.py:598-775)."""
        return _fields.field_plane(self, 'xz', x_axis, z_axis, y)

    def field_yz(self, y_axis, z_axis, x):
        """Fields on the yz plane at fixed x (rcwa.py:777-957)."""
        return _fields.field_plane(self, 'yz', y_axis, z_axis, x)

    def field_xy(self, layer_num, x_axis, y_axis, z_prop=0.):
        """Fields on an xy plane at one z inside a region
        (rcwa.py:959-1112)."""
        return _fields.field_xy(self, layer_num, x_axis, y_axis, z_prop)

    # -- internals ----------------------------------------------------------

    def _kvectors(self):
        """k-vectors, the free-space V and the cladding interfaces."""
        ang = ((self.eps_in, self.mu_in) if self.angle_layer == 'input'
               else (self.eps_out, self.mu_out))
        k = _kvectors(
            self.inc_ang, self.azi_ang, *ang, self._r(self.order_x),
            self._r(self.order_y), self.Gx_norm, self.Gy_norm,
            (self.eps_in, self.mu_in) if self._has_input_layer else None,
            (self.eps_out, self.mu_out) if self._has_output_layer else None)
        self.kx0_norm, self.ky0_norm = k['kx0'], k['ky0']
        self.Kx_norm_dn, self.Ky_norm_dn = k['Kx'], k['Ky']
        self.Vf, self.Vf_inv = k['Vf'], k['Vf_inv']
        if self._has_input_layer:
            self.Vi, self.Sin = k['Vi'], k['Sin']
        if self._has_output_layer:
            self.Vo, self.Sout = k['Vo'], k['Sout']
