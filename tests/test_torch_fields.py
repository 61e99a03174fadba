"""Field reconstruction of the port's class API against the JAX package's.

The same numpy inputs go through ``torcwa_tpu.rcwa`` on the CPU in
float64 (eig by host LAPACK) and through ``torcwa_tpu_torch.rcwa`` on the
CPU at complex128 with ``eig_backend='torch'``; every field component
within 1e-8 of the largest |field| of the plane.  Then the port alone at
complex64 against the reference's field goldens (``tests/golden``), at the
JAX golden tests' tolerances (2e-3 or 3e-3 of the largest |field|).  Order
(2, 2), grid 32, against the JAX package.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

import torcwa_tpu as tt  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402

torch.set_num_threads(2)

L = [300., 300.]
GRID = 32
TILT = 10. * np.pi / 180
# z samples in every region: the input cladding, the three layers (a
# boundary exactly), the output cladding
Z = np.array([-120., -10., 0., 60., 200., 250., 300., 380., 450., 520.])
T_AXIS = np.linspace(0., 300., 7)


def _rasters():
    g = tt.geometry(Lx=L[0], Ly=L[1], nx=GRID, ny=GRID, edge_sharpness=500.,
                    dtype=jnp.float64)
    rect = np.asarray(g.rectangle(160., 100., 150., 150., theta=0.2))
    circ = np.asarray(g.circle(70., 150., 150.))
    return rect, circ


def _mixed(mod, **kw):
    rect, circ = _rasters()
    sim = mod.rcwa(freq=1 / 500., order=[2, 2], L=L, **kw)
    sim.add_input_layer(eps=1.46 ** 2)
    sim.add_output_layer(eps=1.2 ** 2)
    sim.set_incident_angle(TILT, 30. * np.pi / 180)
    sim.add_layer(thickness=200., eps=rect * (4.0 + 0.1j) + (1 - rect))
    sim.add_layer(thickness=100., eps=2.56)
    sim.add_layer(thickness=150., eps=circ * 2.0709 ** 2 + (1 - circ))
    sim.solve_global_smatrix()
    return sim


def _magnetic(mod, **kw):
    rect, _ = _rasters()
    sim = mod.rcwa(freq=1 / 620., order=[2, 2], L=L, **kw)
    sim.add_input_layer(eps=1.46 ** 2, mu=1.2)
    sim.add_output_layer(eps=1.1 ** 2, mu=0.9)
    sim.set_incident_angle(TILT, 35. * np.pi / 180)
    sim.add_layer(thickness=180., eps=2.25, mu=1.6)
    sim.add_layer(thickness=240., eps=rect * (4.2 + 0.25j) + (1 - rect),
                  mu=rect * (1.8 + 0.05j) + (1 - rect) * 1.1)
    sim.solve_global_smatrix()
    return sim


PORT = dict(dtype=torch.complex128, device='cpu', eig_backend='torch')


@pytest.fixture(scope='module')
def mixed():
    return _mixed(tt, dtype=jnp.complex128), _mixed(tp, **PORT)


def _stack(fields):
    E, H = fields
    return np.stack([np.asarray(c) for c in list(E) + list(H)])


def _close(ours, ref, tol):
    ours, ref = _stack(ours), _stack(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize('plane', ['xz', 'yz'])
@pytest.mark.parametrize('source', [
    dict(amplitude=[1., 0.3j]),
    dict(amplitude=[0.2, 1.], direction='backward'),
    dict(amplitude=[1., 0.5j], notation='ps')])
def test_field_planes_match_jax(mixed, plane, source):
    sj, st = mixed
    for sim in (sj, st):
        sim.source_planewave(**source)
    fn = lambda s: getattr(s, f'field_{plane}')(T_AXIS, Z, 110.)
    _close(fn(st), fn(sj), 1e-8)


@pytest.mark.parametrize('region', [-1, 0, 1, 2, 3])
def test_field_xy_matches_jax(mixed, region):
    sj, st = mixed
    for sim in (sj, st):
        sim.source_fourier(amplitude=[[1., 0.], [0.3, 0.2j]],
                           orders=[[0, 0], [1, 0]])
    x, y = np.linspace(0., 300., 6), np.linspace(0., 300., 5)
    for z in (-30., 40.):
        _close(st.field_xy(region, x, y, z), sj.field_xy(region, x, y, z),
               1e-8)


def test_magnetic_fields_match_jax():
    sj, st = _magnetic(tt, dtype=jnp.complex128), _magnetic(tp, **PORT)
    for sim in (sj, st):
        sim.source_planewave(amplitude=[1., 0.3], direction='forward')
    z = np.linspace(-100., 520., 9)
    _close(st.field_xz(T_AXIS, z, 150.), sj.field_xz(T_AXIS, z, 150.), 1e-8)


def test_field_xy_refuses_a_bad_layer_number(mixed):
    _, st = mixed
    st.source_planewave()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        assert st.field_xy(1.0, [0.], [0.]) is None
        assert st.field_xy(st.layer_N + 1, [0.], [0.]) is None
    assert len(w) == 2
    with pytest.raises(ValueError):
        tp.fields.field_plane(st, 'xy', [0.], [0.], 0.)


def test_fields_carry_the_thickness_gradient():
    # a field probe inside the last layer, differentiated in that layer's
    # thickness, against central differences of the same float64 solve
    def probe(t):
        sim = tp.rcwa(freq=1 / 500., order=[1, 1], L=L, **PORT)
        sim.add_input_layer(eps=1.46 ** 2)
        sim.set_incident_angle(TILT, 0.)
        sim.add_layer(thickness=t, eps=2.56)
        sim.source_planewave(amplitude=[1., 0.])
        sim.solve_global_smatrix()
        E, _ = sim.field_xz([0., 80.], [30., 60.], 0.)
        return (E[0].abs() ** 2).sum()

    t = torch.tensor(150., dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(probe(t), t)
    h = 1e-3
    at = lambda v: float(probe(torch.tensor(v, dtype=torch.float64)))
    fd = (at(150. + h) - at(150. - h)) / (2 * h)
    assert abs(float(g) - fd) <= 1e-6 * abs(fd)


# ---------------------------------------------------------------------------
# Field goldens of the reference, complex64 with eig_backend='torch'
# ---------------------------------------------------------------------------

SUBSTRATE_EPS = 1.46 ** 2
SU8_EPS = 1.6 ** 2
# a-Si:H eps at the golden wavelengths, as tests/test_golden_solver.py
# records them
SI_EPS = {532.: 12.011610263133004 + 0.5259120147560001j,
          650.: 10.362267239174999 + 0.15362360819199997j}
PORT32 = dict(dtype=torch.complex64, device='cpu', eig_backend='torch')


def _golden_fields(ours, ref, atol):
    ours = np.stack([np.asarray(c) for c in ours])
    scale = np.abs(ref).max()
    assert np.allclose(ours, ref, atol=atol * scale), \
        (np.abs(ours - ref).max(), scale)


def _rcwa_geo():
    return tp.geometry(Lx=L[0], Ly=L[1], nx=256, ny=256, edge_sharpness=1000.,
                       dtype=torch.float32, device='cpu')


def test_golden_example1_fields(golden):
    g = golden('example1')
    geom = torch.as_tensor(g['geom'])
    sim = tp.rcwa(freq=1 / 532., order=[5, 5], L=L, **PORT32)
    sim.add_input_layer(eps=SUBSTRATE_EPS)
    sim.set_incident_angle(inc_ang=0., azi_ang=0.)
    sim.add_layer(thickness=300., eps=geom * SI_EPS[532.] + (1. - geom))
    sim.solve_global_smatrix()
    sim.source_planewave(amplitude=[1., 0.], direction='forward')
    x, y = np.linspace(0., L[0], 24), np.linspace(0., L[1], 20)
    z = np.linspace(-200., 500., 29)
    E, H = sim.field_xz(x, z, L[1] / 2)
    _golden_fields(E, g['fxz_E'], 2e-3)
    _golden_fields(H, g['fxz_H'], 2e-3)
    E, H = sim.field_yz(y, z, L[0] / 2)
    _golden_fields(E, g['fyz_E'], 2e-3)
    _golden_fields(H, g['fyz_H'], 2e-3)
    for layer, zp, key in ((0, 150., 'fxy_E'), (-1, -50., 'fxy_in_E'),
                           (1, 100., 'fxy_out_E')):
        E, _ = sim.field_xy(layer, x, y, z_prop=zp)
        _golden_fields(E, g[key], 2e-3)
    sim.source_planewave(amplitude=[0., 1.], direction='backward')
    E, H = sim.field_xz(x, z, L[1] / 2)
    _golden_fields(E, g['fxz_bwd_E'], 2e-3)
    _golden_fields(H, g['fxz_bwd_H'], 2e-3)


def test_golden_example2_fields(golden):
    g = golden('example2')
    geom = _rcwa_geo().rectangle(Wx=120., Wy=120., Cx=150., Cy=150.)
    sim = tp.rcwa(freq=1 / 532., order=[4, 4], L=L, **PORT32)
    sim.add_input_layer(eps=SUBSTRATE_EPS)
    sim.add_output_layer(eps=1.2 ** 2)
    sim.set_incident_angle(inc_ang=15. * np.pi / 180,
                           azi_ang=20. * np.pi / 180)
    sim.add_layer(thickness=300., eps=geom * SI_EPS[532.] + (1. - geom))
    sim.solve_global_smatrix()
    sim.source_planewave(amplitude=[1., 0.5j], direction='forward',
                         notation='ps')
    E, H = sim.field_xz(np.linspace(0., L[0], 16),
                        np.linspace(-100., 400., 11), L[1] / 2)
    _golden_fields(E, g['fxz_E'], 3e-3)
    _golden_fields(H, g['fxz_H'], 3e-3)


def test_golden_example1_1_fields(golden):
    g = golden('example1_1')
    si = SI_EPS[650.]
    geo = _rcwa_geo()
    sim = tp.rcwa(freq=1 / 650., order=[3, 3], L=L, **PORT32)
    sim.add_input_layer(eps=SUBSTRATE_EPS)
    sim.set_incident_angle(inc_ang=0., azi_ang=0.)
    for th in (0., 30 / 180 * np.pi, 60 / 180 * np.pi):
        geom = geo.rectangle(Wx=180., Wy=100., Cx=150., Cy=150., theta=th)
        sim.add_layer(thickness=200., eps=geom * si + (1. - geom) * SU8_EPS)
        sim.add_layer(thickness=100., eps=SU8_EPS)
    sim.solve_global_smatrix()
    sim.source_planewave(amplitude=[1., 1.j], direction='forward')
    E, H = sim.field_xz(np.linspace(0., L[0], 12),
                        np.linspace(-100., 1000., 23), L[1] / 2)
    _golden_fields(E, g['fxz_E'], 3e-3)
    _golden_fields(H, g['fxz_H'], 3e-3)


def test_golden_magnetic_fields(golden):
    g = golden('magnetic')
    geo = tp.geometry(Lx=L[0], Ly=L[1], nx=192, ny=192, edge_sharpness=1000.,
                      dtype=torch.float32, device='cpu')
    geom = geo.rectangle(150., 110., L[0] / 2., L[1] / 2., theta=0.3)
    sim = tp.rcwa(freq=1 / 620., order=[3, 3], L=L, **PORT32)
    sim.add_input_layer(eps=1.46 ** 2, mu=1.2)
    sim.add_output_layer(eps=1.1 ** 2, mu=0.9)
    sim.set_incident_angle(inc_ang=10. * np.pi / 180,
                           azi_ang=35. * np.pi / 180)
    sim.add_layer(thickness=180., eps=2.25, mu=1.6)
    sim.add_layer(thickness=240., eps=geom * (4.2 + 0.25j) + (1. - geom),
                  mu=geom * (1.8 + 0.05j) + (1. - geom) * 1.1)
    sim.solve_global_smatrix()
    sim.source_planewave(amplitude=[1., 0.3], direction='forward')
    E, H = sim.field_xz(np.linspace(0., L[0], 12),
                        np.linspace(-100., 520., 15), L[1] / 2)
    _golden_fields(E, g['fxz_E'], 3e-3)
    _golden_fields(H, g['fxz_H'], 3e-3)
