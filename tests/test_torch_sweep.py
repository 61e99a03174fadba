"""The port's sweeps split over devices (``torcwa_tpu_torch.parallel``)
against ``torcwa_tpu.parallel`` on the CPU.

The port runs on meshes of 1 and 3 CPU devices (a mesh may name a device
more than once, which exercises the padding and the split); the JAX
package on meshes of 1 and 3 of the 8 virtual devices of
``tests/conftest.py``.  The port's functions take a batch of points, the
JAX package's one point.  Then an order-(2, 2) float64 wavelength sweep
through ``shard_sweep``, against the direct batched solve and the JAX
package's vmap.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torcwa_tpu import fmm as jf  # noqa: E402
from torcwa_tpu import parallel as jp  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import parallel as pp  # noqa: E402

torch.set_num_threads(2)

MESHES = [1, 3]


def _meshes(k):
    return pp.sweep_mesh(['cpu'] * k), jp.sweep_mesh(jax.devices()[:k])


def _toy_batch(x):
    # the toy point of tests/test_parallel_sweep.py, on a batch
    return {'t': torch.sin(3.0 * x) * x, 'r': (torch.cos(x) ** 2,)}


def _toy_point(x):
    return {'t': jnp.sin(3.0 * x) * x, 'r': (jnp.cos(x) ** 2,)}


def test_mesh_holds_the_given_devices():
    mesh = pp.sweep_mesh(['cpu', 'cpu'])
    assert mesh.devices == (torch.device('cpu'),) * 2
    assert mesh.axis_names == jp.sweep_mesh().axis_names == ('sweep',)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            pp.sweep_mesh()


@pytest.mark.parametrize('k', MESHES)
@pytest.mark.parametrize('n', [8, 16, 5, 13])   # divisible by 3 and not
def test_shard_sweep_matches_jax(n, k):
    pm, jm = _meshes(k)
    xs = np.linspace(0.3, 2.1, n)
    got = pp.shard_sweep(_toy_batch, pm)(torch.as_tensor(xs))
    want = jp.shard_sweep(_toy_point, jm)(jnp.asarray(xs))
    for a, b in ((got['t'], want['t']), (got['r'][0], want['r'][0])):
        assert a.shape == (n,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-15)


def _toy_loss_batch(x, theta):
    return (torch.sin(theta[None, :] * x[:, None]) ** 2).sum(-1) \
        / theta.numel()


def _toy_loss_point(x, theta):
    return jnp.sum(jnp.sin(theta * x) ** 2) / theta.size


@pytest.mark.parametrize('k', MESHES)
@pytest.mark.parametrize('n', [8, 16, 5, 13])
def test_sweep_and_grad_matches_jax(n, k):
    pm, jm = _meshes(k)
    xs = np.linspace(0.2, 1.7, n)
    theta = np.array([0.7, 1.3, 2.9])
    loss, grad = pp.sweep_and_grad(_toy_loss_batch, pm)(
        torch.as_tensor(xs), torch.as_tensor(theta))
    want_loss, want_grad = jp.sweep_and_grad(_toy_loss_point, jm)(
        jnp.asarray(xs), jnp.asarray(theta))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-13)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=1e-12)


def test_sweep_and_grad_mean_is_exact_with_padding():
    # 5 points on 3 devices: one padding point (the last repeated) with
    # weight zero; the mean and its gradient are those of the 5 points
    xs = torch.linspace(0.1, 0.9, 5, dtype=torch.float64)
    theta = {'a': torch.tensor(1.1, dtype=torch.float64),
             'b': [torch.tensor([0.4, 0.6], dtype=torch.float64)]}

    def loss(x, th):
        return th['a'] * torch.sin(x) + th['b'][0].sum() * x ** 2

    val, grad = pp.sweep_and_grad(loss, pp.sweep_mesh(['cpu'] * 3))(
        xs, theta)
    a = theta['a'].clone().requires_grad_(True)
    b = theta['b'][0].clone().requires_grad_(True)
    want = loss(xs, {'a': a, 'b': [b]}).mean()
    ga, gb = torch.autograd.grad(want, (a, b))
    assert float(val) == pytest.approx(float(want.detach()), rel=1e-15)
    assert float(grad['a']) == pytest.approx(float(ga), rel=1e-15)
    assert isinstance(grad['b'], list)
    np.testing.assert_allclose(grad['b'][0].numpy(), gb.numpy(), rtol=1e-15)
    # the JAX package's padded mean on the same points
    jval, jgrad = jp.sweep_and_grad(
        lambda x, th: th['a'] * jnp.sin(x) + jnp.sum(th['b'][0]) * x ** 2,
        jp.sweep_mesh(jax.devices()[:3]))(
            jnp.asarray(xs.numpy()),
            {'a': jnp.asarray(1.1), 'b': [jnp.asarray([0.4, 0.6])]})
    assert float(val) == pytest.approx(float(jval), rel=1e-13)
    np.testing.assert_allclose(grad['b'][0].numpy(),
                               np.asarray(jgrad['b'][0]), rtol=1e-13)


ORDER = (2, 2)
L = (300., 300.)
GRID = 32
EPS_SUB = 1.46 ** 2


def _raster():
    rng = np.random.default_rng(11)
    return 1. + 8. * (rng.random((GRID, GRID)) > 0.5)


def test_wavelength_sweep_through_shard_sweep():
    # order (2, 2), float64: five wavelengths split over 3 devices (one
    # padding point) equal to one batched solve of the five, and to the
    # JAX package's vmap of its per-wavelength solve
    eps = _raster()
    spec = tp.StackSpec(order=ORDER, L=L, n_layers=1, has_input=True)
    grid = torch.as_tensor(eps)

    def sweep(freqs):
        return tp.simulate_txx(spec, freqs, grid, 250., EPS_SUB,
                               eig_backend='torch', inc_ang=0.1)

    freqs = torch.as_tensor(1. / np.linspace(500., 700., 5))
    got = pp.shard_sweep(sweep, pp.sweep_mesh(['cpu'] * 3))(freqs)
    direct = sweep(freqs)
    assert got.shape == (5,)
    assert (got - direct).abs().max() <= 1e-12 * direct.abs().max()

    jspec = jf.StackSpec(order=ORDER, L=L, n_layers=1, has_input=True)
    sub = (jnp.asarray(EPS_SUB), jnp.asarray(0.))

    def point(freq):
        S, intr = jf.solve_stack_pair(
            jspec, freq, jnp.asarray(0.1), jnp.asarray(0.),
            (jnp.asarray(eps)[None], jnp.zeros((1, GRID, GRID))),
            jnp.asarray([250.]), eps_in=sub)
        tr, ti = jf.sparam_xy_pair(S, intr['kx'], intr['ky'], sub,
                                   (jnp.asarray(1.), jnp.asarray(0.)), ORDER,
                                   [0, 0], [0, 0], 'xx')
        return (tr ** 2 + ti ** 2)[0]

    want = np.asarray(jax.jit(jax.vmap(point))(jnp.asarray(freqs.numpy())))
    assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()
