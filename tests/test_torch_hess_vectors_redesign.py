"""The schedules of the redesigned Hessenberg and blocked-vectors kernels,
modelled in plain PyTorch on the CPU and held against the plain versions
and the JAX package's Pallas kernels (interpret mode).

* ``csrc/tri_vectors_blocked.cu`` runs the in-block recurrence by
  columns: a warp per column, sums seeded from S, each y_i added into the
  rows above once formed.  ``vec_blocked.tri_vectors_block_plain(...,
  by_columns=True)`` takes that order.
* ``csrc/hessenberg.cu`` reduces each matrix on a cluster of P CTAs, with
  column j of H on rank j mod P; u = beta H v is summed as P partial sums,
  one a rank, added in rank order.  ``eig_kernels.hessenberg_plain(A,
  cluster=P)`` takes that order.

The models run in float64 against the plain versions (orders of summation
part at round-off, ~1e-14 here); the Pallas kernels are float32-only, so
the comparisons with them run in float32 at float32 tolerances.  The CUDA
kernels are held to the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3, 4 and 6).
Inputs come from numpy ``default_rng(seed)``.
"""

import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.linalg as sl  # noqa: E402

from torcwa_tpu.ops.eig_qr_pallas import hessenberg_pallas  # noqa: E402
from torcwa_tpu.ops.vec_blocked import eig_tri_vectors_blocked  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops import vec_blocked as vb  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

BLOCK = 64


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _schur_T(n, seed):
    """Upper-triangular complex Schur factor of a random matrix."""
    T, _ = sl.schur(_crand((n, n), seed), output='complex')
    return T


def _blocked(T, by_columns, block=BLOCK):
    """tri_vectors_blocked with the plain in-block recurrence."""
    n = T.shape[-1]
    dmin = vb.pivot_floor(T)
    Y = torch.eye(n, dtype=T.dtype)
    for r1 in range(n, 0, -block):
        r0 = max(r1 - block, 0)
        vb.tri_vectors_block_plain(T, T[r0:r1, r1:] @ Y[r1:], dmin, Y, r0,
                                   r1, by_columns=by_columns)
    return Y


def _separated(T, rel=1e-3):
    w = np.diag(T)
    gap = np.abs(w[:, None] - w[None, :]) + np.eye(len(w)) * 1e30
    return gap.min(1) > rel * np.abs(w).max()


# ---------------------------------------------------------------------------
# the recurrence by columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [96, 300])
def test_column_recurrence_matches_the_rows_and_the_pallas_kernel(n):
    # float64: the column order against today's row order within 1e-10 of
    # max|Y| on the separated columns (measured ~1e-15); both unit upper
    # triangular with T Y = Y diag(lambda).  float32, the same T rounded:
    # the column order against the Pallas kernel (Z = I, so its V is Y with
    # unit columns) within 1e-5 on the separated columns (measured 2e-7)
    T = _schur_T(n, n)
    sep = _separated(T)
    assert sep.sum() > 0.9 * n
    Tt = torch.as_tensor(T)
    Yc, Yr = _blocked(Tt, True), _blocked(Tt, False)
    scale = float(Yr.abs().max())
    assert float((Yc - Yr).abs()[:, sep].max()) <= 1e-10 * scale
    assert float(torch.tril(Yc, -1).abs().max()) == 0
    assert bool((torch.diagonal(Yc) == 1).all())
    assert float((Tt @ Yc - Yc * torch.diagonal(Tt)).abs()[:, sep].max()) \
        <= 1e-10 * float(Tt.abs().max()) * scale

    T32 = T.astype(np.complex64)
    with jax.default_matmul_precision('highest'):
        Vr, Vi = eig_tri_vectors_blocked(
            jnp.asarray(T32.real), jnp.asarray(T32.imag),
            jnp.eye(n, dtype=jnp.float32), jnp.zeros((n, n), jnp.float32),
            block=BLOCK, interpret=True)
    V_ref = np.asarray(Vr) + 1j * np.asarray(Vi)
    Y32 = _blocked(torch.as_tensor(T32), True).numpy()
    V = Y32 / np.linalg.norm(Y32, axis=0)
    assert np.abs(V - V_ref)[:, sep].max() <= 1e-5


def test_column_recurrence_reaches_every_row_and_column_of_a_block():
    # one block of the width the kernel takes (128) over all of T (r0 = 0),
    # and a ragged first block: columns inside the block (Y's unit entry
    # seeds the sums) and right of it, rows down to the block's top
    T = torch.as_tensor(_schur_T(200, 3))
    for block in (vb.MAX_BLOCK, 72):
        Yc, Yr = _blocked(T, True, block), _blocked(T, False, block)
        assert float((Yc - Yr).abs().max()) <= 1e-10 * float(Yr.abs().max())


# ---------------------------------------------------------------------------
# the Hessenberg reduction on a cluster
# ---------------------------------------------------------------------------

def _jax_hess(A):
    A = A.astype(np.complex64)
    Hr, Hi, Qr, Qi = hessenberg_pallas(
        jnp.asarray(A.real), jnp.asarray(A.imag), interpret=True)
    return (np.asarray(Hr) + 1j * np.asarray(Hi),
            np.asarray(Qr) + 1j * np.asarray(Qi))


@pytest.mark.parametrize('n', [12, 40])
@pytest.mark.parametrize('cluster', [8, 16])
def test_cluster_order_matches_the_plain_reduction_and_the_pallas_kernel(
        n, cluster):
    # float64, random matrices (forward-stable): the rank-ordered partial
    # sums of u against the plain reduction element by element within
    # 1e-10 ||A||_2 (measured ~3e-14); at n = 12 and P = 16 four ranks own
    # no column.  float32: the model and the Pallas kernel each against
    # the float64 result, within 1e-4 ||A||_F per lane for H (~40 n eps:
    # float32 forward error grows as ~n eps ||A||_F; measured up to 2.3e-5
    # for the model and 3.4e-6 for Pallas at n = 40, and up to 1.5e-5 for
    # the plain version and the model alike over 24 other lanes) and
    # 1e-4 sqrt(n) for Q
    A = _crand((2, n, n), 100 + n)
    At = torch.as_tensor(A)
    H, Q = ek.hessenberg_plain(At, cluster=cluster)
    Hp, Qp = ek.hessenberg_plain(At)
    a2 = torch.linalg.matrix_norm(At, ord=2)
    assert bool(((H - Hp).abs().amax((-2, -1)) <= 1e-10 * a2).all())
    assert float((Q - Qp).abs().max()) <= 1e-10
    assert float(torch.tril(H, -2).abs().max()) == 0

    H32, Q32 = ek.hessenberg_plain(torch.as_tensor(A.astype(np.complex64)),
                                   cluster=cluster)
    fro = np.linalg.norm(A, axis=(-2, -1))
    for Hf, Qf in ((H32.numpy(), Q32.numpy()), _jax_hess(A)):
        assert np.all(np.abs(Hf - H.numpy()).max((-2, -1)) <= 1e-4 * fro)
        assert np.abs(Qf - Q.numpy()).max() <= 1e-4 * np.sqrt(n)


def test_cluster_order_on_an_order_2_wave_matrix_is_gauge_free_right():
    # A = P Q of chip_smoke.py's layer at order (2, 2) (2N = 50), 10 deg,
    # two wavelengths.  The subdiagonal of such a matrix nears breakdown,
    # so only the gauge-free checks apply (chip_smoke.kernel_checks):
    # float64 residual, unitarity and the two reconstructions within
    # 1e-12; float32 against the Pallas kernel: residuals 1e-5 and the
    # reconstructions within 1e-5 ||A||_F
    _, A = chip_smoke.wave_matrices(torch, tp, (2, 2), chip_smoke.LAMS[:2],
                                    np.radians(10.), torch.float64, 'cpu')
    A = A.contiguous()
    n = A.shape[-1]
    fro = torch.linalg.matrix_norm(A)
    eye = torch.eye(n, dtype=A.dtype)
    H, Q = ek.hessenberg_plain(A, cluster=ek.CLUSTER)
    Hp, Qp = ek.hessenberg_plain(A)
    rec, rec_p = Q @ H @ Q.mH, Qp @ Hp @ Qp.mH
    assert float((torch.linalg.matrix_norm(rec - A) / fro).max()) <= 1e-12
    assert float((Q.mH @ Q - eye).abs().max()) <= 1e-12
    assert bool(((rec - rec_p).abs().amax((-2, -1)) <= 1e-12 * fro).all())

    A32 = A.to(torch.complex64)
    H32, Q32 = ek.hessenberg_plain(A32, cluster=ek.CLUSTER)
    H_ref, Q_ref = _jax_hess(A.numpy())
    a = A32.numpy()
    fro32 = np.linalg.norm(a, axis=(-2, -1))
    rec32 = (Q32 @ H32 @ Q32.mH).numpy()
    rec_ref = Q_ref @ H_ref @ np.conj(np.swapaxes(Q_ref, -1, -2))
    for r in (rec32, rec_ref):
        assert np.all(np.linalg.norm(r - a, axis=(-2, -1)) <= 1e-5 * fro32)
    assert np.all(np.abs(rec32 - rec_ref).max((-2, -1)) <= 1e-5 * fro32)


def test_hessenberg_dispatch_by_n():
    # a cluster of 8 where a CTA's columns of H fit in shared memory, else
    # one of 16, else the one-block kernel; hessenberg_cluster mirrors the
    # choice of the C entry point (csrc/hessenberg.cu: cluster_size,
    # cluster_smem, kSmemPerBlock)
    src = open(os.path.join(os.path.dirname(ek.__file__), '..', 'csrc',
                            'hessenberg.cu')).read()
    assert int(re.search(r'kSmemPerBlock = (\d+);', src).group(1)) \
        == ek.SMEM_PER_BLOCK
    assert int(re.search(r'kCluster = (\d+);', src).group(1)) == ek.CLUSTER
    assert int(re.search(r'kMaxCluster = (\d+);', src).group(1)) \
        == ek.CLUSTER_WIDE
    # every n the cluster holds fits the lanes' registers (n <= 32 kPerLane)
    assert ek.CLUSTER_MAX_N <= 32 * int(
        re.search(r'kPerLane = (\d+);', src).group(1))
    assert int(re.search(r'kQBatch = (\d+);', src).group(1)) == 4
    cap = ek.CLUSTER_MAX_N
    assert ek.cluster_smem_bytes(cap, ek.CLUSTER_WIDE) <= ek.SMEM_PER_BLOCK \
        < ek.cluster_smem_bytes(cap + 1, ek.CLUSTER_WIDE)
    for n in (40, 338, 450):                       # the main path's sizes
        assert ek.hessenberg_cluster(n) == ek.CLUSTER
    for n in (578, 640, cap):
        assert ek.hessenberg_cluster(n) == ek.CLUSTER_WIDE
    assert ek.hessenberg_cluster(cap + 1) == 0
    # on a CPU tensor the wrapper is the plain version and launches nothing
    A = torch.as_tensor(_crand((1, 20, 20), 7))
    before = ek.LAUNCHES['hessenberg']
    H, Q = ek.hessenberg(A)
    Hp, Qp = ek.hessenberg_plain(A)
    assert ek.LAUNCHES['hessenberg'] == before
    assert torch.equal(H, Hp) and torch.equal(Q, Qp)


# ---------------------------------------------------------------------------
# a fault repaired: Givens rotations from carries below the normal range
# ---------------------------------------------------------------------------

def _givens_unscaled(x, y):
    """eig_kernels._givens before the repair (and the JAX package's
    eig_qr_pallas_ms._givens): the squares of x and y taken unscaled."""
    ax2 = x.real ** 2 + x.imag ** 2
    ay2 = y.real ** 2 + y.imag ** 2
    dn, ax = torch.sqrt(ax2 + ay2), torch.sqrt(ax2)
    one, zero = torch.ones_like(dn), torch.zeros_like(dn)
    c = torch.where(dn > 0, ax / torch.where(dn > 0, dn, one), one)
    den = torch.where(ax > 0, ax, one) * torch.where(dn > 0, dn, one)
    both = (ax > 0) & (dn > 0)
    sr = torch.where(both, (x.real * y.real + x.imag * y.imag) / den, zero)
    si = torch.where(both, (x.imag * y.real - x.real * y.imag) / den, zero)
    swap = (ax2 == 0) & (ay2 > 0)
    return (torch.where(swap, zero, c),
            torch.complex(torch.where(swap, one, sr), torch.where(swap, zero, si)))


@pytest.mark.parametrize('scale', [1e-20, 1e-22, 1e-30, 1e-40])
def test_givens_stays_unitary_below_the_normal_range(scale):
    # x and y of a bulge whose squares fall below float32's normal range
    # (1.2e-38): unscaled, the squares keep a few bits and c^2 + |s|^2
    # misses 1 by up to 1e-2 (csrc/schur_qr_ms.cu lost Z's unitarity to
    # 1.5e-2 on an order-6 wave matrix through such a rotation), or they
    # vanish and the rotation leaves y; scaled by a power of two first, the
    # rotation is unitary and, for x and y in the normal range, zeroes y to
    # float32 round-off (at 1e-40 x and y are themselves denormal, and a
    # product with them is only as exact as the denormal spacing)
    eps = 1.1920929e-07
    z = _crand((2, 256), 11) * scale
    x = torch.as_tensor(z[0].astype(np.complex64))
    y = torch.as_tensor(z[1].astype(np.complex64))
    c, s = ek._givens(x, y)
    assert float((c ** 2 + s.abs() ** 2 - 1).abs().max()) <= 4 * eps
    r = (c * x + s * y).abs()
    if scale >= 1e-30:
        assert bool(((-s.conj() * x + c * y).abs() <= 4 * eps * r).all())
    c0, s0 = _givens_unscaled(x, y)
    if scale >= 1e-22:
        assert float((c0 ** 2 + s0.abs() ** 2 - 1).abs().max()) > 1e3 * eps
    else:
        assert float(((-s0.conj() * x + c0 * y).abs() / r).max()) > 0.1


@pytest.mark.parametrize('dtype', [torch.complex64, torch.complex128])
def test_givens_scaling_keeps_the_bits_in_the_normal_range(dtype):
    # the power-of-two scaling is exact: wherever no square underflows the
    # rotation is the unscaled formula's bit for bit (exact zeros included)
    z = _crand((2, 3000), 12) * np.repeat([1e-3, 1., 1e3], 1000)
    z[:, :5] = 0
    z[0, 5:10] = 0
    x, y = torch.as_tensor(z[0]).to(dtype), torch.as_tensor(z[1]).to(dtype)
    c, s = ek._givens(x, y)
    c0, s0 = _givens_unscaled(x, y)
    assert torch.equal(c, c0) and torch.equal(s, s0)
