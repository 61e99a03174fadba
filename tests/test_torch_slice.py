"""Port parity on the main path: the Example-1 slice end to end.

The same numpy rasters (made with the JAX package's own geometry) go
through torcwa_tpu on the CPU (eig by host LAPACK) and through the port
(backend 'kernels', whose wrappers take the plain versions of the CUDA
kernels for CPU tensors).  Order (2, 2), grid 32, 2 wavelengths.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torcwa_tpu as tt  # noqa: E402
from torcwa_tpu import fmm as jf  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import convert  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels  # noqa: E402

torch.set_num_threads(2)

ORDER = (2, 2)
L = (300., 300.)
GRID = 32
THICK = 600.
EPS_HI = 2.0709 ** 2
EPS_SUB = 1.46 ** 2
LAMS = np.array([450., 620.])


def _raster(rd):
    g = tt.geometry(Lx=L[0], Ly=L[1], nx=GRID, ny=GRID, edge_sharpness=500.,
                    dtype=rd)
    occ = np.asarray(g.rectangle(160., 160., L[0] / 2, L[1] / 2))
    return (occ * EPS_HI + (1. - occ)).astype(rd)


def _spec(**kw):
    return jf.StackSpec(order=ORDER, L=L, n_layers=1, has_input=True, **kw)


@pytest.mark.parametrize('rd,tol', [(np.float64, 1e-9), (np.float32, 1e-4)])
def test_simulate_txx_matches_jax(rd, tol):
    # float64: both sides solve the same system to ~1e-14, 1e-9 leaves
    # room for the eig backends' different round-off; float32: 1e-4 is
    # ~1000 ulps, the f32 eig + LU error of a 2N = 50 solve
    eps = _raster(rd)
    ref = [float(jf.simulate_txx(_spec(), jnp.asarray(1 / lam, rd),
                                 jnp.asarray(eps), jnp.zeros(eps.shape, rd),
                                 jnp.asarray(THICK, rd),
                                 jnp.asarray(EPS_SUB, rd)))
           for lam in LAMS]
    cv = convert.from_jax_pairs(eps_grids=(eps[None], np.zeros_like(eps)[None]),
                                spec=_spec(), device='cpu')
    eig_kernels.reset_launch_counts()
    got = tp.simulate_txx(cv['spec'], torch.as_tensor(1 / LAMS.astype(rd)),
                          cv['eps_grids'][0], THICK, EPS_SUB).numpy()
    assert sum(eig_kernels.LAUNCHES.values()) == 0   # CPU: plain versions
    assert np.all(np.abs(got - ref) <= tol * np.abs(ref))


@functools.lru_cache(maxsize=None)
def _jax_grad_fn():
    """jit(grad) of mean |t_xx|^2 w.r.t. the raster, incidence traced, so
    that one compile serves every tilt."""
    spec = _spec()
    one = (jnp.asarray(1.), jnp.asarray(0.))
    sub = (jnp.asarray(EPS_SUB), jnp.asarray(0.))

    def loss_jax(er, inc):
        vals = []
        for lam in LAMS:
            S, intr = jf.solve_stack_pair(
                spec, jnp.asarray(1 / lam), inc, jnp.asarray(0.),
                (er[None], jnp.zeros_like(er)[None]), jnp.asarray([THICK]),
                eps_in=sub)
            tr, ti = jf.sparam_xy_pair(S, intr['kx'], intr['ky'], sub, one,
                                       ORDER, [0, 0], [0, 0], 'xx')
            vals.append((tr ** 2 + ti ** 2)[0])
        return sum(vals) / len(vals)

    return jax.jit(jax.grad(loss_jax))


def _jax_grad(eps, inc):
    """The JAX package's float64 gradient of mean |t_xx|^2."""
    return np.asarray(_jax_grad_fn()(jnp.asarray(eps), jnp.asarray(inc)))


def _port_grad(eps, inc):
    """The port's gradient of the same loss, in the precision of eps."""
    rd = eps.dtype.type
    cv = convert.from_jax_pairs(eps_grids=(eps[None], np.zeros_like(eps)[None]),
                                thicknesses=np.array([THICK], rd),
                                eps_in=(rd(EPS_SUB), rd(0.)), spec=_spec(),
                                device='cpu')
    er = cv['eps_grids'].real.clone().requires_grad_(True)
    S, intr = tp.solve_stack_pair(cv['spec'], torch.as_tensor(1 / LAMS.astype(rd)),
                                  inc, 0., er, cv['thicknesses'],
                                  eps_in=cv['eps_in'])
    t = tp.sparam_xy_pair(S, intr['kx'], intr['ky'], cv['eps_in'], 1., ORDER,
                          [0, 0], [0, 0], 'xx')
    (t.abs() ** 2).mean().backward()
    got = er.grad[0].double().numpy()
    assert np.isfinite(got).all()
    return got


def test_raster_gradient_matches_jax_at_tilt():
    # 0.2 deg off normal: at exactly 0 deg the broadened VJP is basis-
    # dependent by design (tests/test_degenerate_grad.py), so the two eig
    # backends would legitimately differ there.  float64, relative L2 1e-6.
    eps = _raster(np.float64)
    inc = np.deg2rad(0.2)
    ref = _jax_grad(eps, inc)
    got = _port_grad(eps, inc)
    assert np.linalg.norm(got - ref) <= 1e-6 * np.linalg.norm(ref)


def test_float32_raster_gradient_matches_jax_at_10_degrees():
    # float32 through the kernels' route against the float64 JAX gradient,
    # at a tilt where the closest mode pairs are far enough apart for
    # float32 to resolve them.  Measured: cosine 0.99997, relative L2
    # 7.9e-3; without the complex128-residual refinement of the eig
    # (ops/eig_qr.py) the eigenvectors of the close pairs give cosine 0.907
    # and relative L2 0.46.  Bounds: cosine >= 0.999, relative L2 <= 3e-2.
    inc = np.deg2rad(10.)
    ref = _jax_grad(_raster(np.float64), inc)
    got = _port_grad(_raster(np.float32), inc)
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos >= 0.999
    assert np.linalg.norm(got - ref) <= 3e-2 * np.linalg.norm(ref)


def test_two_layers_with_output_cladding_match_jax():
    # the unrolled Redheffer fold and the output interface, float64
    rng = np.random.default_rng(4)
    eps = np.stack([_raster(np.float64),
                    1.5 + rng.random((GRID, GRID))])
    spec = jf.StackSpec(order=(1, 1), L=L, n_layers=2, has_input=True,
                        has_output=True)
    thick = np.array([300., 150.])
    e_in, e_out = (EPS_SUB, 0.), (1.2, 0.01)
    S_ref, _ = jax.jit(lambda e: jf.solve_stack_pair(
        spec, jnp.asarray(1 / 530.), jnp.asarray(0.1), jnp.asarray(0.3),
        (e, jnp.zeros(eps.shape)), jnp.asarray(thick),
        eps_in=tuple(map(jnp.asarray, e_in)),
        eps_out=tuple(map(jnp.asarray, e_out))))(jnp.asarray(eps))
    cv = convert.from_jax_pairs(eps_grids=(eps, np.zeros_like(eps)),
                                thicknesses=thick, eps_in=e_in,
                                eps_out=e_out, spec=spec, device='cpu')
    S, _ = tp.solve_stack_pair(cv['spec'], 1 / 530., 0.1, 0.3,
                               cv['eps_grids'], cv['thicknesses'],
                               eps_in=cv['eps_in'], eps_out=cv['eps_out'])
    for blk, (r, i) in zip(S, S_ref):
        ref = np.asarray(r) + 1j * np.asarray(i)
        assert np.abs(blk.numpy() - ref).max() <= 1e-9 * np.abs(ref).max()


@pytest.mark.parametrize('kw', [dict(with_modes=True), dict(fold='scan'),
                                dict(mu_in=1.), dict(
                                    avoid_pinv_instability=True)])
def test_unported_options_raise(kw):
    # the four options the port once refused, each now against the JAX
    # package on one layer at float64: the S-blocks to 1e-9, with modes
    # each layer's gauge-free E Cf and E Cb, with the fallback its metrics
    eps = _raster(np.float64)[None]
    jkw = {k: (jnp.asarray(v), jnp.asarray(0.)) if k == 'mu_in' else v
           for k, v in kw.items()}
    S_ref, ir = jax.jit(lambda e: jf.solve_stack_pair(
        _spec(), jnp.asarray(1 / 500.), jnp.asarray(0.1), jnp.asarray(0.),
        (e, jnp.zeros_like(e)), jnp.asarray([100.]),
        eps_in=(jnp.asarray(EPS_SUB), jnp.asarray(0.)), **jkw))(
            jnp.asarray(eps))
    cv = convert.from_jax_pairs(eps_grids=(eps, np.zeros_like(eps)),
                                spec=_spec(), device='cpu')
    S, intr = tp.solve_stack_pair(cv['spec'], 1 / 500., 0.1, 0.,
                                  cv['eps_grids'], [100.], eps_in=EPS_SUB,
                                  **kw)
    cplx = lambda p: np.asarray(p[0]) + 1j * np.asarray(p[1])
    for blk, ref in zip(S, S_ref):
        ref = cplx(ref)
        assert np.abs(blk.numpy() - ref).max() <= 1e-9 * np.abs(ref).max()
    if 'with_modes' in kw:
        E, E_ref = intr['E'][0].numpy(), cplx(ir['E'])[0]
        for C, C_ref in zip(intr['C'][0], ir['C'][0]):
            got, ref = E @ C.numpy()[:50], E_ref @ cplx(C_ref)[:50]
            assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()
    if 'avoid_pinv_instability' in kw:
        for got, ref in zip(intr['pinv_instability'],
                            ir['pinv_instability']):
            assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-12
