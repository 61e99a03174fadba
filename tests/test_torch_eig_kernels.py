"""Port parity: the plain versions of the three eig kernels against the
Pallas kernels they replace, run in the Pallas interpreter on the CPU.

Inputs are float32 (the Pallas kernels are float32-only), random complex
matrices made with numpy, B = 2 lanes.  The CUDA kernels themselves run
only on the card (``python3 chip_smoke.py``); on a CPU tensor each
wrapper takes its plain version, which is what is tested here.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from torcwa_tpu.ops.eig_qr_pallas import (  # noqa: E402
    hessenberg_pallas, schur_qr_pallas_acc, eig_tri_vectors_pallas,
    _call_vec)
from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402

torch.set_num_threads(2)
B = 2


def _pair(z):
    return (jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))


def _np(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _t(z):
    return torch.as_tensor(np.asarray(z, np.complex64))


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n, n))
            + 1j * rng.standard_normal((B, n, n))).astype(np.complex64)


def _pallas_hess(A):
    Hr, Hi, Qr, Qi = hessenberg_pallas(*_pair(A), interpret=True)
    return _np((Hr, Hi)), _np((Qr, Qi))


@pytest.mark.parametrize('n', [16, 32])
def test_hessenberg_plain_matches_pallas(n):
    # same reflector convention, so H and Q agree element by element up
    # to float32 forward error, which grows as ~n eps ||A||_F (measured
    # against a float64 run at n = 32: 1.8e-5 max|A| for Pallas, 5.7e-5
    # for the plain version).  The bound is therefore 1e-5 ||A||_F per
    # lane, not 1e-5 max|A|, which is ~10x tighter at n = 32 and which
    # the two float32 reductions do not meet.  Measured plain vs Pallas
    # on these inputs: H 3.8e-6 / 2.7e-6 max|A| at n = 16 and 1.4e-5 /
    # 5.8e-5 max|A| (4.3e-6 ||A||_F) at n = 32; Q 1.2e-6 and 1.6e-5,
    # against 1e-5 sqrt(n).  A tighter test needs a float64 Pallas run.
    A = _rand(n, n)
    H_ref, Q_ref = _pallas_hess(A)
    H, Q = ek.hessenberg(_t(A))
    for b in range(B):
        fro = np.linalg.norm(A[b])
        assert np.abs(H[b].numpy() - H_ref[b]).max() <= 1e-5 * fro
        assert np.abs(Q[b].numpy() - Q_ref[b]).max() <= 1e-5 * np.sqrt(n)
    assert ek.LAUNCHES['hessenberg'] == 0          # CPU: no kernel launch


@pytest.mark.parametrize('n', [16, 32])
def test_schur_qr_plain_matches_pallas(n):
    A = _rand(n, 100 + n)
    H, Q = _pallas_hess(A)
    Tr, Ti, Zr, Zi, (hi_ref, sw_ref) = schur_qr_pallas_acc(
        *_pair(H), *_pair(Q), interpret=True, return_stats=True)
    T, Z, (hi, sweeps) = ek.schur_qr(_t(H), _t(Q), return_stats=True)
    T_ref = _np((Tr, Ti))
    # same convergence flags (0 == converged)
    assert (hi.numpy() == 0).tolist() == (np.asarray(hi_ref) == 0).tolist()
    # Pallas reports the batch's sweep count, the port each lane's: the
    # batch needs as many sweeps as its slowest lane.  The chase order of
    # round-off differs (deferred columns vs direct rotations), so the
    # counts agree to a band, not exactly.
    assert abs(int(sweeps.max()) - int(sw_ref[0])) <= 0.3 * int(sw_ref[0])
    for b in range(B):
        w = np.diag(T[b].numpy())
        w_ref = np.diag(T_ref[b])
        # eigenvalue sets, nearest match, 1e-4 of the spectral radius
        dist = np.abs(w[:, None] - w_ref[None, :]).min(axis=1).max()
        assert dist <= 1e-4 * np.abs(w_ref).max()
        # Schur form: Z accumulates onto Q, so A = Z T Z^H, T triangular
        Tb, Zb = T[b].numpy().astype(np.complex128), Z[b].numpy()
        assert np.abs(np.tril(Tb, -1)).max() == 0
        res = np.linalg.norm(Zb @ Tb @ Zb.conj().T - A[b])
        assert res <= 1e-5 * np.linalg.norm(A[b])


def test_schur_qr_nonconvergence_poisons_with_nan():
    # a starved budget: both implementations flag the lanes and the
    # wrapper puts NaN on their diagonals (zgeev INFO analogue)
    A = _rand(16, 7)
    H, Q = _pallas_hess(A)
    Tr, _, _, _, (hi_ref, _) = schur_qr_pallas_acc(
        *_pair(H), *_pair(Q), max_iter_factor=0, interpret=True,
        return_stats=True)
    T, _, (hi, sweeps) = ek.schur_qr(_t(H), _t(Q), max_iter_factor=0,
                                     return_stats=True)
    assert (np.asarray(hi_ref) > 0).all() and (hi.numpy() > 0).all()
    assert int(sweeps.max()) == 0
    assert np.isnan(np.diagonal(np.asarray(Tr), axis1=1, axis2=2)).all()
    assert torch.isnan(torch.diagonal(T, dim1=1, dim2=2)).all()


@pytest.mark.parametrize('n', [16, 32])
def test_tri_vectors_plain_matches_pallas(n):
    # same T, Z into both: distinct random eigenvalues keep the
    # back-substitution well conditioned, so 1e-5 holds element-wise
    A = _rand(n, 200 + n)
    H, Q = _pallas_hess(A)
    Tr, Ti, Zr, Zi = schur_qr_pallas_acc(*_pair(H), *_pair(Q),
                                         interpret=True)
    T, Z = _np((Tr, Ti)), _np((Zr, Zi))
    Yr, Yi = _call_vec(Tr, Ti, True)
    Vr, Vi = eig_tri_vectors_pallas(Tr, Ti, Zr, Zi, interpret=True)
    Y = ek.tri_vectors(_t(T)).numpy()
    Y_ref = _np((Yr, Yi))
    assert np.abs(Y - Y_ref).max() <= 1e-5 * np.abs(Y_ref).max()
    V = Z @ Y
    V = V / np.linalg.norm(V, axis=-2, keepdims=True)
    assert np.abs(V - _np((Vr, Vi))).max() <= 1e-5
