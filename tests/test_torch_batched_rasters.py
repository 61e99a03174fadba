"""Batched rasters in the port's ``solve_stack_pair``: one raster a lane,
[B, n_patterned, nx, ny], against a loop of per-point solves and against
the JAX package's vmap over ``eps_grids``, forward and raster gradient.

Rasters are made with numpy from a seed; float64 on the CPU, order (1, 1)
or (2, 1), a small grid.  The port's eig goes through ``torch.linalg.eig``
('torch') or the kernels' plain versions ('kernels'); the JAX package's
through host LAPACK.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torcwa_tpu import fmm as jf  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402

torch.set_num_threads(2)

L = (300., 300.)
GRID = 24
LAMS = np.array([480., 555., 640.])
EPS_SUB = 1.46 ** 2


def _rasters(seed, shape):
    rng = np.random.default_rng(seed)
    return (1. + 3. * rng.random(shape)) + 0.05j * rng.random(shape)


def _stack(order=(2, 1)):
    # a patterned layer, a homogeneous spacer, a patterned layer; both
    # claddings
    return dict(
        spec=tp.StackSpec(order=order, L=L, n_layers=3, has_input=True,
                          has_output=True, homogeneous=(False, True, False)),
        thick=[120., 60., 90.], eps_in=EPS_SUB, eps_out=1.2,
        eps_scalars=[2.5])


def _solve(eps, freq, backend, mu=None, order=(2, 1), inc=0.17):
    st = _stack(order)
    return tp.solve_stack_pair(
        st['spec'], freq, inc, 0.3, torch.as_tensor(eps), st['thick'],
        eps_in=st['eps_in'], eps_out=st['eps_out'],
        eps_scalars=st['eps_scalars'], eig_backend=backend,
        mu_grids=None if mu is None else torch.as_tensor(mu), device='cpu')


@pytest.mark.parametrize('backend', ['torch', 'kernels'])
@pytest.mark.parametrize('with_mu', [False, True])
def test_batched_rasters_equal_a_loop_of_solves(backend, with_mu):
    # each lane of one batched solve against its own solve, float64 to
    # 1e-12 of max|S|: the blocks, and the lane's conv matrices
    eps = _rasters(0, (3, 2, GRID, GRID))
    mu = 1. + 0.5 * _rasters(1, (3, 2, GRID, GRID)).real if with_mu else None
    freq = torch.as_tensor(1. / LAMS)
    S, intr = _solve(eps, freq, backend, mu)
    assert S[0].shape == (3, 30, 30)
    assert intr['conv'].shape == (3, 3, 15, 15)
    for b in range(3):
        Sb, ib = _solve(eps[b], freq[b], backend,
                        None if mu is None else mu[b])
        for x, y in zip(S, Sb):
            assert (x[b] - y).abs().max() <= 1e-12 * y.abs().max()
        for k in ('conv', 'mu_conv', 'kz'):
            assert (intr[k][:, b] - ib[k]).abs().max() <= 1e-12 * \
                ib[k].abs().max(), k


def test_scalar_freq_broadcasts_to_the_rasters_batch():
    # a scalar freq gives every lane the same wavelength; a freq of
    # another length than the rasters' batch is refused
    eps = _rasters(2, (4, 2, GRID, GRID))
    S, intr = _solve(eps, 1. / 520., 'torch', order=(1, 1))
    assert S[0].shape == (4, 18, 18) and intr['kx'].shape == (4, 9)
    S1, _ = _solve(eps[2], 1. / 520., 'torch', order=(1, 1))
    assert (S[0][2] - S1[0]).abs().max() <= 1e-12 * S1[0].abs().max()
    with pytest.raises(ValueError, match='lanes'):
        _solve(eps, torch.as_tensor(1. / LAMS), 'torch', order=(1, 1))


# diffraction orders read by the forward check; the gradient reads (0, 0)
# alone: an evanescent order's zeroed entry has a NaN gradient in both
# packages
ORDERS = [[0, 0], [1, 0], [0, 1]]


def _jax_txx(order, inc, orders=ORDERS):
    """The JAX package's |t_xx|^2 and |t_yy|^2 at the orders, vmapped
    over (freq, eps rasters) of the same stack, float64."""
    st = _stack(order)
    spec = jf.StackSpec(order=order, L=L, n_layers=3, has_input=True,
                        has_output=True, homogeneous=(False, True, False))
    c = lambda v: (jnp.asarray(float(np.real(v))), jnp.asarray(0.))
    sub, out = c(st['eps_in']), c(st['eps_out'])

    def point(freq, er, ei):
        S, intr = jf.solve_stack_pair(
            spec, freq, jnp.asarray(inc), jnp.asarray(0.3), (er, ei),
            jnp.asarray(st['thick']), eps_in=sub, eps_out=out,
            eps_scalars=(jnp.asarray(st['eps_scalars']), jnp.zeros(1)))
        vals = []
        for pol in ('xx', 'yy'):
            tr, ti = jf.sparam_xy_pair(S, intr['kx'], intr['ky'], sub, out,
                                       order, orders, [0, 0], pol)
            vals.append(tr ** 2 + ti ** 2)
        return jnp.stack(vals)

    return jax.vmap(point)


def _port_txx(eps, order, inc, orders=ORDERS, backend='torch'):
    S, intr = _solve(eps, torch.as_tensor(1. / LAMS), backend, order=order,
                     inc=inc)
    return torch.stack([
        tp.sparam_xy_pair(S, intr['kx'], intr['ky'], EPS_SUB, 1.2, order,
                          orders, [0, 0], pol).abs() ** 2
        for pol in ('xx', 'yy')], 1)


def test_batched_rasters_match_jax_vmap_over_eps_grids():
    # the port's one batched solve against jax.vmap over (freq, rasters):
    # |t|^2 of three orders in two polarizations, float64, 1e-9
    eps = _rasters(3, (3, 2, GRID, GRID))
    ref = np.asarray(jax.jit(_jax_txx((2, 1), 0.17))(
        jnp.asarray(1. / LAMS), jnp.asarray(eps.real),
        jnp.asarray(eps.imag)))
    got = _port_txx(eps, (2, 1), 0.17).numpy()
    assert got.shape == ref.shape == (3, 2, 3)
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()


def test_batched_raster_gradient_matches_jax_at_10_degrees():
    # d mean(|t|^2) / d Re(raster) of every lane against the JAX package's
    # gradient through vmap, float64 at 10 degrees (off the degenerate
    # normal incidence), relative L2 1e-8
    eps = _rasters(4, (3, 2, GRID, GRID))
    inc = float(np.deg2rad(10.))
    vm = _jax_txx((1, 1), inc, [[0, 0]])
    ref = np.asarray(jax.jit(jax.grad(lambda er: jnp.mean(vm(
        jnp.asarray(1. / LAMS), er, jnp.asarray(eps.imag)))))(
            jnp.asarray(eps.real)))
    er = torch.as_tensor(eps.real).requires_grad_(True)
    _port_txx(er + 1j * torch.as_tensor(eps.imag), (1, 1), inc,
              [[0, 0]]).mean().backward()
    got = er.grad.numpy()
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert np.linalg.norm(got - ref) <= 1e-8 * np.linalg.norm(ref)
