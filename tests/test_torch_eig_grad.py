"""Port parity: the broadened eig VJP and the eig forward.

The port's backward is held against torcwa_tpu's ``_eig_pair_bwd`` given
the SAME (w, V) and cotangents, so eigenvector phase plays no part; float64,
1e-10 relative (the two evaluate one formula, a complex solve against an
augmented real one).  A complex cotangent gr + i gi is the JAX pair
(gr, gi) and nothing else.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from torcwa_tpu.ops.eig import _eig_pair_bwd  # noqa: E402
from torcwa_tpu import fmm as jfmm  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch.ops.eig import eig, eig_backward  # noqa: E402
from torcwa_tpu_torch.ops.fourier import material_conv  # noqa: E402

torch.set_num_threads(2)


def _case(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((2, n, n)) + 1j * rng.standard_normal((2, n, n))
    w, V = np.linalg.eig(A)
    gw = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    gV = (rng.standard_normal((2, n, n))
          + 1j * rng.standard_normal((2, n, n)))
    return w, V, gw, gV


def _p(z):
    return jnp.asarray(z.real), jnp.asarray(z.imag)


def _jax_bwd(w, V, gw, gV, broadening):
    p = _p
    res = p(w) + p(V)
    cts = p(gw) + p(gV)
    gr, gi = _eig_pair_bwd(broadening, 'callback', res, cts)
    return np.asarray(gr) + 1j * np.asarray(gi)


@pytest.mark.parametrize('broadening', ['auto', None, 1e-3])
@pytest.mark.parametrize('n', [6, 20])
def test_backward_matches_jax(n, broadening):
    w, V, gw, gV = _case(n, n)
    ref = _jax_bwd(w, V, gw, gV, broadening)
    t = torch.as_tensor
    got = eig_backward(t(w), t(V), t(gw), t(gV), broadening).numpy()
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


def test_autograd_uses_broadened_backward():
    # through autograd: dA of L = Re sum(gw* w) + Re sum(gV* V) is the VJP
    w, V, gw, gV = _case(8, 3)
    A = torch.as_tensor(V @ (w[..., None] * np.linalg.inv(V)))
    A.requires_grad_(True)
    wt, Vt = eig(A, 'auto', 'torch')
    loss = (torch.as_tensor(gw).conj() * wt).real.sum() \
        + (torch.as_tensor(gV).conj() * Vt).real.sum()
    loss.backward()
    ref = eig_backward(wt.detach(), Vt.detach(), torch.as_tensor(gw),
                       torch.as_tensor(gV), 'auto')
    assert torch.allclose(A.grad, ref, rtol=0, atol=1e-12)


def test_gauge_invariant_gradient_matches_finite_differences():
    # sum |w|^2 does not depend on eigenvector phase; with 'auto'
    # broadening (1e-10 at float64) on a well-separated spectrum the VJP
    # is exact to ~1e-10, central differences to ~h^2
    rng = np.random.default_rng(11)
    n = 10
    A0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    D = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = torch.as_tensor(A0, dtype=torch.complex128).requires_grad_(True)
    w, _ = eig(A, 'auto', 'kernels')
    (w.abs() ** 2).sum().backward()
    h = 1e-6
    f = lambda M: np.sum(np.abs(np.linalg.eigvals(M)) ** 2)  # noqa: E731
    fd = (f(A0 + h * D) - f(A0 - h * D)) / (2 * h)
    an = float((A.grad.conj() * torch.as_tensor(D)).real.sum())
    assert abs(an - fd) <= 1e-6 * abs(fd)


def _order1_pq():
    g = tp.geometry(Lx=300., Ly=300., nx=32, ny=32, edge_sharpness=500.,
                    dtype=torch.float64)
    occ = g.circle(95., 150., 150.)
    eps = occ * 4.2 + (1. - occ)
    freq = torch.tensor([1 / 473.], dtype=torch.float64)
    kx, ky = tp.kvectors_real(freq, 0.05, 0., 1.46, (1, 1), (300., 300.),
                              torch.float64)
    P, Q = tp.pq_pair(material_conv(eps, (1, 1)), kx, ky)
    return (P @ Q)[0]


def test_kernels_forward_matches_numpy_on_pq():
    # backend 'kernels' on a CPU tensor runs the plain versions of the
    # three kernels in float64; eigenvalues to 1e-10 of the spectral
    # radius (nearest match), eigenpairs to a 1e-10 residual
    A = _order1_pq()
    w, V = eig(A, backend='kernels')
    w0 = np.linalg.eig(A.numpy())[0]
    wn = w.numpy()
    scale = np.abs(w0).max()
    assert np.abs(wn[:, None] - w0[None, :]).min(axis=1).max() <= 1e-10 * scale
    An, Vn = A.numpy(), V.numpy()
    assert np.abs(An @ Vn - Vn * wn).max() <= 1e-10 * scale
    assert np.allclose(np.linalg.norm(Vn, axis=0), 1., atol=1e-12)


def _close_pair_c64(n, seed):
    # random spectrum with one pair 1e-3 apart (O(1) eigenvalues), rounded
    # to complex64: its eigenvectors are 1e3x more sensitive than the rest
    rng = np.random.default_rng(seed)
    lam = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    lam[:, 1] = lam[:, 0] + 1e-3
    X = rng.standard_normal((2, n, n)) + 1j * rng.standard_normal((2, n, n))
    A = (X * lam[:, None, :]) @ np.linalg.inv(X)
    return torch.as_tensor(A.astype(np.complex64))


@pytest.mark.parametrize('n', [32, 96])
def test_kernels_forward_complex64_is_refined(n):
    # the complex64 QR route ends in one refinement step with a complex128
    # residual: its eigenvectors match the complex128 eig of the SAME
    # complex64 matrix to 1 - |cos| <= 1e-6 (measured 7.7e-9 at n = 32 and
    # 1.7e-8 at n = 96; 1.1e-5 and 1.8e-4 without the step), and the
    # eigen-residual is at the complex64 rounding of V (<= 3e-7 max|A|,
    # measured 3.2e-8)
    A = _close_pair_c64(n, n)
    w, V = eig(A, backend='kernels')
    assert w.dtype == torch.complex64 and V.dtype == torch.complex64
    A64 = A.numpy().astype(np.complex128)
    w0, V0 = np.linalg.eig(A64)
    wn, Vn = w.numpy().astype(np.complex128), V.numpy().astype(np.complex128)
    for b in range(2):
        idx = np.abs(w0[b][:, None] - wn[b][None, :]).argmin(axis=1)
        Vm = Vn[b][:, idx]
        cos = np.abs((Vm.conj() * V0[b]).sum(0)) / (
            np.linalg.norm(Vm, axis=0) * np.linalg.norm(V0[b], axis=0))
        assert (1 - cos).max() <= 1e-6
        res = np.abs(A64[b] @ Vn[b] - Vn[b] * wn[b]).max()
        assert res <= 3e-7 * np.abs(A64[b]).max()


def test_refinement_keeps_nan_lanes_and_degenerate_pairs():
    # a NaN lane (a QR lane that did not converge) stays NaN and leaves the
    # other lane alone; an exactly double eigenvalue keeps its basis
    from torcwa_tpu_torch.ops.eig_qr import _refine
    A = _close_pair_c64(12, 5)
    A[0, :2, :] = 0
    A[0, :, :2] = 0
    A[0, 0, 0] = A[0, 1, 1] = 2.                  # double eigenvalue 2
    w, V = torch.linalg.eig(A.to(torch.complex128))
    w, V = w.to(torch.complex64), V.to(torch.complex64)
    w[1] = float('nan')                           # as the QR route poisons
    V[1] = float('nan')
    wr, Vr = _refine(A, w, V)
    assert torch.isnan(wr[1]).all() and torch.isnan(Vr[1]).all()
    assert torch.isfinite(wr[0]).all() and torch.isfinite(Vr[0]).all()
    two = (w[0] - 2).abs() < 1e-6
    assert int(two.sum()) == 2
    # the pair's two vectors stay independent (no O(1) mixing)
    P = Vr[0][:, two].to(torch.complex128)
    assert torch.linalg.svdvals(P).min() >= 0.5


def test_pq_pair_matches_jax():
    A = _order1_pq()
    g = np.asarray
    import torcwa_tpu as tt
    gj = tt.geometry(Lx=300., Ly=300., nx=32, ny=32, edge_sharpness=500.,
                     dtype=jnp.float64)
    eps = gj.circle(95., 150., 150.) * 4.2 + (1. - gj.circle(95., 150., 150.))
    kx, ky = jfmm.kvectors_real(jnp.asarray(1 / 473.), jnp.asarray(0.05),
                                jnp.asarray(0.), jnp.asarray(1.46), (1, 1),
                                (300., 300.), jnp.float64)
    conv = jfmm.dft_conv_pair((eps, jnp.zeros_like(eps)), (1, 1), 32, 32)
    P, Q = jfmm.pq_pair(conv, kx, ky)
    Pr, Pi = P
    Qr, Qi = Q
    ref = (g(Pr) + 1j * g(Pi)) @ (g(Qr) + 1j * g(Qi))
    assert np.abs(A.numpy() - ref).max() <= 1e-11 * np.abs(ref).max()
