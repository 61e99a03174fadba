"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The host with
the card has no JAX, which ``tests/conftest.py`` imports, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Inputs are random complex64 matrices made with numpy from a seed, small
enough (n = 40) for the plain versions to be quick on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops.eig_qr import eig_qr  # noqa: E402

pytestmark = pytest.mark.cuda

B, N = 2, 40


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def _rand(dev, seed=0, n=N):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    return torch.as_tensor(a.astype(np.complex64), device=dev)


def _launch(name, fn, *args, **kw):
    before = ek.LAUNCHES[name]
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert ek.LAUNCHES[name] == before + 1
    return out


def test_hessenberg_kernel_matches_plain(dev):
    # n = 40 random: the reduction is forward-stable here, so H and Q agree
    # element-wise; 1e-4 ||A||_2 is ~50x the float32 forward error measured
    # at n = 48 on the card
    A = _rand(dev)
    H, Q = _launch('hessenberg', ek.hessenberg, A)
    Hp, Qp = ek.hessenberg_plain(A)
    a2 = torch.linalg.matrix_norm(A, ord=2)
    assert bool(((H - Hp).abs().amax((-2, -1)) <= 1e-4 * a2).all())
    assert float((Q - Qp).abs().max()) <= 1e-4
    res = torch.linalg.matrix_norm(Q @ H @ Q.mH - A) / torch.linalg.matrix_norm(A)
    assert float(res.max()) <= 1e-5


def test_schur_qr_kernel_matches_plain(dev):
    # eigenvalue sets within 1e-4 of the spectral radius (the kernel and
    # the plain version chase round-off in another order), Schur residual
    # 1e-5, sweep counts within 30%
    A = _rand(dev, 1)
    H, Q = ek.hessenberg_plain(A)
    T, Z, (hi, sw) = _launch('schur_qr', ek.schur_qr, H, Q,
                             return_stats=True)
    Tp, _, hip, swp = ek.schur_qr_plain(H, Q)
    assert bool((hi == 0).all()) and bool((hip == 0).all())
    w = torch.diagonal(T, dim1=-2, dim2=-1)[..., :, None]
    wp = torch.diagonal(Tp, dim1=-2, dim2=-1)[..., None, :]
    dist = (w - wp).abs().amin(-1).amax(-1)
    assert bool((dist <= 1e-4 * wp.abs().amax((-2, -1))).all())
    assert bool((torch.tril(T, -1) == 0).all())
    res = torch.linalg.matrix_norm(Z @ T @ Z.mH - A) / torch.linalg.matrix_norm(A)
    assert float(res.max()) <= 1e-5
    assert abs(int(sw.max()) - int(swp.max())) <= 0.3 * int(swp.max())


def test_schur_qr_kernel_poisons_nonconverged_lanes(dev):
    # a budget of one sweep per row cannot converge: NaN eigenvalues
    A = _rand(dev, 2)
    H, Q = ek.hessenberg_plain(A)
    T, _, (hi, _) = _launch('schur_qr', ek.schur_qr, H, Q, max_iter_factor=1,
                            return_stats=True)
    assert bool((hi > 0).all())
    assert bool(torch.isnan(torch.diagonal(T, dim1=-2, dim2=-1)).all())


def test_tri_vectors_kernel_matches_plain(dev):
    # same T into both; distinct random eigenvalues keep the
    # back-substitution well conditioned, so 1e-4 relative holds
    A = _rand(dev, 3)
    H, Q = ek.hessenberg_plain(A)
    T, _ = ek.schur_qr_plain(H, Q)[:2]
    Y = _launch('tri_vectors', ek.tri_vectors, T.contiguous())
    Yp = ek.tri_vectors_plain(T)
    assert float((Y - Yp).abs().max()) <= 1e-4 * float(Yp.abs().max())


def test_eig_qr_on_the_card_solves_the_eigenproblem(dev):
    # the three kernels end to end: eigen-residual ||A V - V diag(w)|| at
    # float32 level (1e-4 ||A||), eigenvalues against complex128
    A = _rand(dev, 4)
    w, V = eig_qr(A)
    res = (A @ V - V * w[..., None, :]).abs().amax((-2, -1))
    assert bool((res <= 1e-4 * torch.linalg.matrix_norm(A, ord=2)).all())
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    dist = (w.to(torch.complex128)[..., :, None]
            - w_ref[..., None, :]).abs().amin(-1).amax(-1)
    assert bool((dist <= 1e-4 * w_ref.abs().amax(-1)).all())


@pytest.mark.parametrize('bad', ['complex128', 'noncontiguous', 'shape'])
def test_wrappers_refuse_what_the_kernels_do_not_take(dev, bad):
    A = _rand(dev, 5)
    if bad == 'complex128':
        A, err = A.to(torch.complex128), TypeError
    elif bad == 'noncontiguous':
        A, err = A.transpose(-1, -2), ValueError
    else:
        A, err = A[:, :, :-1], ValueError
    with pytest.raises(err):
        ek.hessenberg(A)
    with pytest.raises(err):
        ek.tri_vectors(A)
