"""The class API and the functional solve against each other, on the CPU.

Both front ends run one implementation of everything after the layers
(``core.claddings``, ``core.fold``, ``core.sparams`` and
``core.incident_amplitudes``); what differs is how each turns its
arguments into those functions' inputs.  This file holds that seam: one
stack (a lossy patterned layer, a homogeneous spacer and a second
patterned layer between two dielectric claddings, at oblique incidence)
solved through ``rcwa`` and through ``solve_stack_pair``, complex128 with
``eig_backend='torch'``.  No JAX: the JAX package holds each front end in
its own test files.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch.core import matching_indices  # noqa: E402

torch.set_num_threads(2)

ORDER = (2, 2)
L = (400., 350.)
GRID = 24
FREQ = 1 / 600.
INC, AZI = math.radians(10.), math.radians(30.)
EPS_IN, EPS_OUT = 1.46 ** 2, 1.2 ** 2
THICK = [80., 40., 120.]
SPACER = 2.1
ORDERS = [[0, 0], [1, 0], [-1, 1], [0, -2], [2, 2]]
XY, PS = ('xx', 'xy', 'yx', 'yy'), ('pp', 'ps', 'sp', 'ss')
SIDES = [(d, p) for d in ('forward', 'backward')
         for p in ('transmission', 'reflection')]


def _rasters():
    """A lossy rectangle and a real-valued disc, (2, GRID, GRID)."""
    x = (np.arange(GRID) + 0.5) / GRID
    X, Y = np.meshgrid(x, x, indexing='ij')
    rect = (np.abs(X - 0.4) < 0.25) & (np.abs(Y - 0.55) < 0.15)
    disc = (X - 0.5) ** 2 + (Y - 0.45) ** 2 < 0.3 ** 2
    return np.stack([1. + (11. + 0.6j) * rect, 1. + 3. * disc])


def _class(layers=True):
    sim = tp.rcwa(FREQ, ORDER, L, dtype=torch.complex128, device='cpu',
                  eig_backend='torch')
    sim.add_input_layer(eps=EPS_IN)
    sim.add_output_layer(eps=EPS_OUT)
    sim.set_incident_angle(INC, AZI)
    if layers:
        grids = _rasters()
        sim.add_layer(THICK[0], eps=grids[0])
        sim.add_layer(THICK[1], eps=SPACER)
        sim.add_layer(THICK[2], eps=grids[1])
    sim.solve_global_smatrix()
    return sim


def _functional(layers=True):
    spec = tp.StackSpec(order=ORDER, L=L, n_layers=3 if layers else 0,
                        has_input=True, has_output=True,
                        homogeneous=(False, True, False) if layers else ())
    return tp.solve_stack_pair(
        spec, FREQ, INC, AZI,
        torch.as_tensor(_rasters()) if layers else None,
        THICK if layers else [],
        eps_in=torch.tensor(EPS_IN, dtype=torch.complex128), eps_out=EPS_OUT,
        eps_scalars=[SPACER] if layers else None, eig_backend='torch',
        with_modes=True, device='cpu')


@pytest.fixture(scope='module')
def solved():
    return _class(), _functional()


def _close(got, ref, tol):
    got, ref = got.detach().reshape(ref.shape), ref.detach()
    scale = ref.abs().max()
    assert (got - ref).abs().max() <= tol * scale, (
        float((got - ref).abs().max()), float(scale))


def _sparam(S, intr, pol, direction, port):
    f = tp.sparam_xy_pair if pol in XY else tp.sparam_ps_pair
    return f(S, intr['kx'], intr['ky'], EPS_IN, EPS_OUT, ORDER, ORDERS,
             [0, 0], pol, direction, port)


@pytest.mark.parametrize('layers', [True, False],
                         ids=['three_layers', 'claddings_only'])
def test_global_smatrix(solved, layers):
    """All four blocks of the global S-matrix agree, and so do the
    S-parameters read from them; with no layer the S-matrix is the
    claddings' alone."""
    sim, (S, intr) = solved if layers else (_class(False), _functional(False))
    for got, ref in zip(sim.S, S):
        _close(got, ref, 1e-9)
    _close(sim.Vi, intr['Vi'], 1e-12)
    _close(sim.Vo, intr['Vo'], 1e-12)
    if not layers:
        for d, p in SIDES:
            _close(sim.S_parameters(ORDERS, direction=d, port=p,
                                    polarization='pp'),
                   _sparam(S, intr, 'pp', d, p), 1e-9)


@pytest.mark.parametrize('pol', XY + PS)
def test_sparameters(solved, pol):
    """Each polarisation at both ports in both directions."""
    sim, (S, intr) = solved
    for d, p in SIDES:
        got = sim.S_parameters(ORDERS, direction=d, port=p,
                               polarization=pol)
        ref = _sparam(S, intr, pol, d, p)
        assert ref.abs().max() > 0.
        _close(got, ref, 1e-9)


def test_sparameters_without_power_norm(solved):
    """power_norm=False reads the S-matrix's entries in xy, and leaves out
    only the kz ratio in ps (checked at order (0, 0), the one that
    propagates in both claddings)."""
    sim, _ = solved
    n = sim.order_N
    idx = matching_indices(ORDERS, ORDER)
    i0 = matching_indices([0, 0], ORDER)
    blocks = {('forward', 'transmission'): 0, ('forward', 'reflection'): 1,
              ('backward', 'reflection'): 2, ('backward', 'transmission'): 3}
    kx, ky = sim.Kx_norm_dn.real, sim.Ky_norm_dn.real

    def kz(eps):
        return torch.sqrt(eps - kx ** 2 - ky ** 2)

    for d, p in SIDES:
        for pol in XY:
            got = sim.S_parameters(ORDERS, direction=d, port=p,
                                   polarization=pol, power_norm=False)
            ref = sim.S[blocks[d, p]][idx + (n if pol[0] == 'y' else 0),
                                      i0 + (n if pol[1] == 'y' else 0)]
            _close(got, ref, 1e-15)
        o_eps = EPS_OUT if (d == 'forward') == (p == 'transmission') \
            else EPS_IN
        r_eps = EPS_IN if d == 'forward' else EPS_OUT
        ratio = torch.sqrt(kz(o_eps)[i0] / kz(r_eps)[i0])
        for pol in PS:
            raw = sim.S_parameters([0, 0], direction=d, port=p,
                                   polarization=pol, power_norm=False)
            _close(raw * ratio, sim.S_parameters(
                [0, 0], direction=d, port=p, polarization=pol), 1e-12)


@pytest.mark.parametrize('direction', ['forward', 'backward'])
@pytest.mark.parametrize('notation', ['xy', 'ps'])
def test_sources(solved, notation, direction):
    """The Fourier source, one (x, y) or (p, s) pair an order."""
    sim, (_, intr) = solved
    amp = [[1., 0.5j], [0.3 - 0.1j, -0.2], [0., 1.]]
    orders = [[0, 0], [1, -1], [-2, 2]]
    sim.source_fourier(amplitude=amp, orders=orders, direction=direction,
                       notation=notation)
    ref = tp.source_fourier_pair(
        ORDER, amp, orders, direction, notation, kx=intr['kx'],
        ky=intr['ky'], eps_in=EPS_IN, eps_out=EPS_OUT, rdtype=torch.float64,
        device='cpu')
    assert sim.E_i_vec.shape == (2 * sim.order_N, 1)
    _close(sim.E_i_vec, ref, 1e-12)
