"""The sweep examples of the port (examples/torch/: Examples 1, 1-1 and 3,
through the functional solve) against their JAX twins (examples/*.py) on
the CPU, float64, at low order on a small grid; then each of the six
scripts of Examples 0-4 run as ``__main__`` once.

Each port example's functions (``t00``, ``t_elements``, ``t00_of_wxwy``)
against the twin's on the same configuration, within 1e-9: the twin's
order, grid and precision are monkeypatched to match (its module
constants), the port's are arguments.  Then each port script's
``__main__`` at tiny knobs with ``EXn_DEVICE=cpu``, writing into a
temporary directory.  The class-API examples (0, 2 and 4) are held to
their twins in ``test_torch_examples_class.py``.
"""

import importlib.util
import os
import runpy

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


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


def _close(got, want, tol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def test_example1_matches_its_twin(monkeypatch):
    # order (1, 1), grid 40, three wavelengths in one batch (one raster a
    # wavelength) against the twin's t00 one wavelength at a time
    port, twin = (_port('example1_wavelength_sweep'),
                  _twin('example1_wavelength_sweep'))
    order, grid = (1, 1), 40
    for k, v in (('ORDER', order), ('GRID', grid), ('rdtype', jnp.float64)):
        monkeypatch.setattr(twin, k, v)
    geom_j = twin.build_geom()
    geom = port.build_geom(grid, 'cpu', F64)
    _close(geom.numpy(), np.asarray(geom_j), 1e-14)
    lams = np.array([400., 555., 700.])
    want = [float(twin.t00(jnp.asarray(1. / lam), geom_j)) for lam in lams]
    got = port.t00(torch.as_tensor(1. / lams), geom, order, 'torch')
    _close(got.numpy(), want)
    # the kernels' route (plain versions on the CPU) in chunks of 2
    chunked = port.sweep(torch.as_tensor(1. / lams), geom, order, 'kernels',
                         chunk=2)
    _close(chunked, want, 1e-9)


@pytest.mark.parametrize('order_n', [0, 1])
def test_example1_1_matches_its_twin(order_n, monkeypatch):
    port, twin = (_port('example1_1_multilayer'),
                  _twin('example1_1_multilayer'))
    for k, v in (('NX', 40), ('NY', 40), ('RDTYPE', jnp.float64)):
        monkeypatch.setattr(twin, k, v)
    assert port.SI_EPS == twin._si
    want = twin.t_elements(order_n)
    got = port.t_elements(order_n, 'cpu', F64, 'torch', grid=(40, 40))
    _close(np.array(got), np.array([complex(*p) for p in want]))
    _close(port.circular(*got), twin.circular(*want))


def test_example3_matches_its_twin(monkeypatch):
    port, twin = (_port('example3_parameter_sweep'),
                  _twin('example3_parameter_sweep'))
    order, grid = (1, 1), 40
    for k, v in (('ORDER', order), ('GRID', grid), ('rdtype', jnp.float64),
                 ('SI_RE', jnp.asarray(twin._si.real, jnp.float64)),
                 ('SI_IM', jnp.asarray(twin._si.imag, jnp.float64))):
        monkeypatch.setattr(twin, k, v)
    assert port.SI_EPS == twin._si
    w, pts = port.grid_points(3)
    w_j = np.linspace(50., 250., 3).astype(np.float32)
    np.testing.assert_array_equal(w, w_j)
    pts = pts[[0, 4, 7]]
    want = [complex(*map(float, twin.t00_of_wxwy(*map(jnp.asarray, p))))
            for p in pts.astype(np.float64)]
    got = port.t00_of_wxwy(pts[:, 0], pts[:, 1], order, grid, 'cpu', F64,
                           'torch')
    _close(got.numpy(), np.array(want))
    # one batch against batches of two through the kernels' plain versions
    _close(port.sweep(pts, 2, order=order, grid=grid, device='cpu',
                      dtype=F64), np.array(want))


@pytest.mark.parametrize('name,prefix,env,outputs', [
    ('example0_fresnel', 'EX0', {}, []),
    ('example2_fields', 'EX2', {'EX2_ORDER': '1,1'}, []),
    ('example4_gradient_check', 'EX4', {'EX4_ORDER': '1,1'}, []),
    ('example1_wavelength_sweep', 'EX1',
     {'EX1_ORDER': '1', 'EX1_NLAM': '3', 'EX1_GRID': '40'}, []),
    ('example1_1_multilayer', 'EX11', {'EX11_ORDERS': '0,1'},
     ['example1_1_data_order_0.mat', 'example1_1_data_order_1.mat']),
    ('example3_parameter_sweep', 'EX3',
     {'EX3_ORDER': '1', 'EX3_NW': '2', 'EX3_GRID': '40'},
     ['example3_sweep.mat'])])
def test_example_main_runs_on_the_cpu(name, prefix, env, outputs, tmp_path,
                                      monkeypatch, capsys):
    # each script's __main__ at tiny knobs on the CPU (the kernels' plain
    # versions), its own assertions included, writing into tmp_path;
    # Example 1 also holds its sweep to a golden file of its own values
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(f'{prefix}_DEVICE', 'cpu')
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if prefix == 'EX1':
        port = _port(name)
        geom = port.build_geom(40, 'cpu')
        freqs = torch.as_tensor(1. / np.array([400., 700.]),
                                dtype=torch.float32)
        t = port.t00(freqs, geom, (1, 1), 'torch')
        np.savez(tmp_path / 'golden.npz', lambs=np.array([400., 700.]),
                 txx=np.sqrt(t.numpy()).astype(np.complex128))
        monkeypatch.setenv('EX1_GOLDEN', str(tmp_path / 'golden.npz'))
    path = os.path.join(ROOT, 'examples', 'torch', f'{name}.py')
    runpy.run_path(path, run_name='__main__')
    out = capsys.readouterr().out
    assert 'cpu' in out or prefix in ('EX0', 'EX2', 'EX4')
    for f in outputs:
        assert (tmp_path / f).exists(), f
    if prefix == 'EX1':
        rel = float(out.split('max rel=')[1].split()[0])
        assert 'lambda match=True' in out and rel <= 1e-4
