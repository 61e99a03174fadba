"""The class-API examples of the port (examples/torch/: Examples 0, 2 and
4) against their JAX twins (examples/*.py) on the CPU, float64 (complex128
classes), at low order on a small grid.

Each port example's functions (``rcwa_reflection``, ``T_of_R`` /
``dT_dR``, and Example 2's ``simulate`` / ``diffraction_angles`` /
``field_maps``) against the twin's on the same configuration, within
1e-9: the twin's order, grid and precision are set through its ``tt``,
whose class and rasters are wrapped for the test, the port's are
arguments.  Example 2's twin has no functions, so its ``__main__`` steps
are repeated here through the JAX class.  The scripts' ``__main__`` runs
are in ``test_torch_examples.py``.
"""

import functools
import importlib.util
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torcwa_tpu as tt  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C128 = torch.complex128


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(os.path.join(ROOT, 'examples', 'torch', f'{name}.py'),
                 f'torch_{name}')


def _twin(name):
    return _load(os.path.join(ROOT, 'examples', f'{name}.py'), f'jax_{name}')


def _class_tt(monkeypatch, twin, order=None, grid=None):
    """The twin's ``tt`` with its class in complex128 (at ``order``) and
    its rasters in float64 (at ``grid``), the Eig broadening restored
    after the test."""
    def rcwa(**kw):
        kw.update(dtype=jnp.complex128)
        if order is not None:
            kw.update(order=list(order))
        return tt.rcwa(**kw)

    def geometry(**kw):
        kw.update(dtype=jnp.float64)
        if grid is not None:
            kw.update(nx=grid, ny=grid)
        return tt.geometry(**kw)

    monkeypatch.setattr(tt.Eig, 'broadening_parameter',
                        tt.Eig.broadening_parameter)
    monkeypatch.setattr(twin, 'tt', types.SimpleNamespace(
        rcwa=rcwa, geometry=geometry, Eig=tt.Eig))


def _close(got, want, tol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def test_example0_matches_its_twin_and_fresnel(monkeypatch):
    port, twin = _port('example0_fresnel'), _twin('example0_fresnel')
    _class_tt(monkeypatch, twin)
    for ang in (0, 40, 80):
        got = port.rcwa_reflection(ang, 'cpu', C128)
        _close(got, twin.rcwa_reflection(ang))
        _close(got, port.fresnel(ang), 1e-9)
        assert port.fresnel(ang) == twin.fresnel(ang)


def test_example4_matches_its_twin(monkeypatch):
    # T and the broadened dT/dR at R = 90 nm, order (1, 1), grid 40; the
    # twin's Eig.broadening_parameter and the port's are left as found
    port, twin = (_port('example4_gradient_check'),
                  _twin('example4_gradient_check'))
    _class_tt(monkeypatch, twin, order=(1, 1), grid=40)
    kw = dict(order=(1, 1), device='cpu', grid=40)
    keep = port.tp.Eig.broadening_parameter
    for stable in (True, False):
        T, g = port.dT_dR(90., stable, 1e-10, **kw)
        _close(T, float(twin.T_of_R(90., stable=stable)))
        want = float(jax.grad(functools.partial(
            twin.T_of_R, stable=stable, broadening=1e-10))(90.))
        _close(g, want)
    assert port.tp.Eig.broadening_parameter == keep
    fd = (float(port.T_of_R(90. + port.DR, **kw))
          - float(port.T_of_R(90. - port.DR, **kw))) / (2 * port.DR)
    assert np.isclose(port.dT_dR(90., **kw)[1], fd, rtol=5e-2, atol=2e-5)


def test_example2_matches_its_twins_steps():
    # the twin's __main__ steps through the JAX class at order (2, 2),
    # grid 60, complex128: the diffraction angles and |E|^2 on both planes
    port = _port('example2_fields')
    order, grid = (2, 2), 60
    g = tt.geometry(Lx=500., Ly=500., nx=grid, ny=grid, edge_sharpness=1000.,
                    dtype=jnp.float64)
    sq = g.square(W=300., Cx=250., Cy=250.)
    sim = tt.rcwa(freq=1 / 600., order=list(order), L=port.L,
                  dtype=jnp.complex128)
    sim.add_input_layer(eps=1.46 ** 2)
    sim.add_output_layer(eps=1.)
    sim.set_incident_angle(inc_ang=np.deg2rad(20.), azi_ang=0.)
    sim.add_layer(thickness=400., eps=sq * (3.5 ** 2) + (1. - sq))
    sim.solve_global_smatrix()
    ang = sim.diffraction_angle(orders=port.ORDERS, layer='output',
                                unit='degree')
    sim.source_planewave(amplitude=[1., 0.], direction='forward')
    x = jnp.linspace(0., 500., 101)
    z = jnp.linspace(-300., 700., 101)
    abs2 = lambda fs: sum(jnp.abs(f) ** 2 for f in fs)
    I_xz = abs2(sim.field_xz(x, z, y=250.)[0])
    I_xy = abs2(sim.field_xy(layer_num=0, x_axis=x, y_axis=x,
                             z_prop=200.)[0])

    ps = port.simulate(order, 'cpu', C128, 'torch', grid)
    inc, azi = port.diffraction_angles(ps)
    _close(inc, np.atleast_1d(np.asarray(ang[0])))
    _close(azi, np.atleast_1d(np.asarray(ang[1])))
    got_xz, got_xy = port.field_maps(ps)
    _close(got_xz.numpy(), np.asarray(I_xz))
    _close(got_xy.numpy(), np.asarray(I_xy))
    port.check_envelope(got_xz, got_xy)
