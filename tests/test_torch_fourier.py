"""Port parity: Fourier factorization and geometry against torcwa_tpu.

Same numpy inputs through the JAX package (CPU, float64) and the port.
Tolerance 1e-12 relative to the largest entry: both sides evaluate the
same float64 formulas (an FFT gather against the JAX DFT matmuls), so
only summation-order round-off separates them.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

import torcwa_tpu as tt  # noqa: E402
from torcwa_tpu.ops.fourier import material_conv_pair  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch.ops.fourier import material_conv  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-12


@pytest.mark.parametrize('order,grid', [((2, 2), 32), ((3, 1), 48),
                                        ((2, 2), 48), ((3, 1), 32)])
def test_material_conv_matches_jax(order, grid):
    rng = np.random.default_rng(grid + 10 * order[0])
    re = rng.standard_normal((grid, grid))
    im = rng.standard_normal((grid, grid))
    ref = material_conv_pair((jnp.asarray(re), jnp.asarray(im)), order)
    ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    got = material_conv(torch.as_tensor(re + 1j * im), order).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_material_conv_batched_matches_single():
    rng = np.random.default_rng(5)
    grids = torch.as_tensor(rng.standard_normal((3, 32, 32)))
    batched = material_conv(grids, (2, 2))
    for i in range(3):
        assert torch.equal(batched[i], material_conv(grids[i], (2, 2)))


@pytest.mark.parametrize('shape', ['rectangle', 'circle', 'ellipse',
                                   'rhombus', 'super_ellipse'])
def test_geometry_matches_jax(shape):
    args = {'rectangle': (160., 120., 150., 140., 0.3),
            'circle': (95., 150., 150.),
            'ellipse': (90., 60., 140., 160., 0.5),
            'rhombus': (150., 100., 150., 150., 0.2),
            'super_ellipse': (150., 110., 150., 150., 0.1, 3.)}[shape]
    gj = tt.geometry(Lx=300., Ly=300., nx=48, ny=40, edge_sharpness=500.,
                     dtype=jnp.float64)
    gt = tp.geometry(Lx=300., Ly=300., nx=48, ny=40, edge_sharpness=500.,
                     dtype=torch.float64, device='cpu')
    ref = np.asarray(getattr(gj, shape)(*args))
    got = getattr(gt, shape)(*args).numpy()
    assert np.abs(got - ref).max() <= TOL


def test_geometry_boolean_ops_and_rcwa_geo(monkeypatch):
    gt = tp.geometry(Lx=300., Ly=300., nx=32, ny=32, edge_sharpness=500.,
                     dtype=torch.float64, device='cpu')
    a = gt.circle(90., 150., 150.)
    b = gt.rectangle(100., 200., 150., 150.)
    tp.rcwa_geo.Lx = tp.rcwa_geo.Ly = 300.
    tp.rcwa_geo.nx = tp.rcwa_geo.ny = 32
    tp.rcwa_geo.edge_sharpness = 500.
    tp.rcwa_geo.dtype = torch.float64
    monkeypatch.setattr(tp.rcwa_geo, 'device', 'cpu')
    assert torch.equal(tp.rcwa_geo.circle(90., 150., 150.), a)
    assert torch.equal(gt.union(a, b), torch.maximum(a, b))
    assert torch.equal(gt.intersection(a, b), torch.minimum(a, b))
    assert torch.equal(gt.difference(a, b), torch.minimum(a, 1. - b))
