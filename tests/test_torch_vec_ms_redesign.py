"""The schedules of the redesigned ``schur_qr_ms`` and ``tri_vectors``
kernels, modelled in plain PyTorch on the CPU and held against the plain
versions and the JAX package's Pallas kernel (interpret mode).

* ``csrc/ms_cluster.cuh`` chases on a thread-block cluster of P CTAs,
  column j of H (and row j of Z) on rank j mod P: rotations formed once a
  step from carries that the column owners send, rows before columns, the
  column rotations split between the owners of columns k and k + 1.
  ``schur_qr_ms.schur_qr_ms_plain(..., cluster=P)`` takes that schedule
  (``chase_cluster_plain``), each update written by its owner only.
* ``csrc/tri_vectors.cu`` runs a warp per column with the recurrence by
  columns: each y_i, once formed, added into the sums of the rows above
  it.  ``eig_kernels.tri_vectors_plain(..., by_columns=True)`` takes that
  order.

The models run in float64; the Pallas kernel is float32-only, so that
comparison runs in float32 at the Pallas tests' tolerance.  The CUDA
kernels are held to the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3, 9 and 10).
Inputs come from numpy ``default_rng(seed)``.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402
import scipy.linalg as sl  # noqa: E402

from torcwa_tpu.ops.eig_qr_pallas import _call_vec  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops import schur_qr_ms as sq  # noqa: E402

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(ek.__file__), '..', 'csrc')


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ---------------------------------------------------------------------------
# schur_qr_ms: the cluster schedule
# ---------------------------------------------------------------------------

_PLAIN = {}


def _plain_ms(n, m):
    """schur_qr_ms_plain of one random float64 Hessenberg matrix, once per
    (n, m) for the whole module."""
    if (n, m) not in _PLAIN:
        H, Q = ek.hessenberg_plain(torch.as_tensor(_crand((1, n, n), n + m)))
        _PLAIN[(n, m)] = (H[0], Q[0], sq.schur_qr_ms_plain(
            H[0], Q[0], m=m, return_stats=True))
    return _PLAIN[(n, m)]


@pytest.mark.parametrize('n,P,m', [
    (64, 8, 4), (64, 16, 4), (64, 16, 8), (64, 8, 16), (96, 8, 8),
    (96, 16, 16)])
def test_cluster_schedule_matches_the_plain_qr(n, P, m):
    # float64, random matrices, every sweep to convergence: the per-rank
    # schedule against the plain version's whole-matrix chase.  T, Z and
    # the stats (window bottom, sweeps, rotations) within 1e-12 (measured:
    # equal bit for bit); at n = 64 and P = 16 a rank owns 4 columns, and
    # m = 16 puts 16 bulges, 2 a column owner, in one step
    H, Q, (T, Z, st) = _plain_ms(n, m)
    Tc, Zc, stc = sq.schur_qr_ms_plain(H, Q, m=m, return_stats=True,
                                       cluster=P)
    assert [int(x) for x in stc] == [int(x) for x in st]
    assert int(st[0]) == 0
    assert float((Tc - T).abs().max()) <= 1e-12
    assert float((Zc - Z).abs().max()) <= 1e-12


def test_cluster_schedule_chase_is_the_plain_chase():
    # one chase over an inner active block [lo, hi] (rows above lo are
    # rotated by the column rotations, columns right of hi by the row
    # rotations), where the first bulge's carry and the bulges that enter
    # later are sent by the owner of column lo
    from torcwa_tpu_torch.ops import schur_ms as sm
    n, m, lo, hi, P = 40, 8, 5, 33, 16
    H, Q = ek.hessenberg_plain(torch.as_tensor(_crand((1, n, n), 5)))
    H, Q = H[0], Q[0]
    shifts = sm.trailing_shifts_plain(H, lo, hi, m)
    nb = min(m, (hi - lo - 1) // 2 + 1)
    Hp, Zp = H.clone(), Q.clone()
    zero = torch.zeros(m, dtype=H.dtype)
    sm.chase_plain(Hp, shifts, zero, zero.clone(), 0, n, lo,
                   hi - 1 + 2 * (nb - 1), lo, hi, Z=Zp)
    Hc, Zc = H.clone(), Q.clone()
    sq.chase_cluster_plain(Hc, Zc, shifts, lo, hi, P)
    assert torch.equal(Hc, Hp) and torch.equal(Zc, Zp)
    assert not torch.equal(Hc, H)


@pytest.mark.parametrize('m', [4, 16, 64])
def test_cluster_dispatch_by_n(m):
    # P from n alone: 8 where a rank holds at most 32 columns, else 16;
    # Z^T in shared memory beside H where both fit, else in device memory;
    # where H alone does not fit, the one-block kernel.  The mirror reads
    # its constants from csrc/ms_cluster.cuh
    src = open(os.path.join(CSRC, 'ms_cluster.cuh')).read()

    def const(name):
        return int(re.search(rf'{name} = (\d+);', src).group(1))

    assert const('kSmall') == sq.CLUSTER
    assert const('kWide') == sq.CLUSTER_WIDE
    assert const('kSmallCols') == sq.CLUSTER_COLS
    assert const('kSmemPerBlock') == sq.SMEM_PER_BLOCK
    assert const('kStaticReserve') == sq.STATIC_RESERVE
    assert const('kThreads') == 512
    for n in (2, 5, 64, 200, 256):
        assert sq.schur_qr_ms_cluster(n, m) == (8, True)
    assert sq.schur_qr_ms_cluster(257, m)[0] == 16
    assert sq.schur_qr_ms_cluster(1, m) == (0, False)
    # the main path's sizes at m = 16: orders 6 and 7 hold Z^T beside H,
    # order 8 only H
    if m == 16:
        assert sq.schur_qr_ms_cluster(338, m) == (16, True)
        assert sq.schur_qr_ms_cluster(450, m) == (16, True)
        assert sq.schur_qr_ms_cluster(578, m) == (16, False)
        assert sq.schur_qr_ms_cluster(700, m) == (0, False)
    room = sq.SMEM_PER_BLOCK - sq.STATIC_RESERVE
    last = {}
    for n in range(257, 1200):
        p, zs = sq.schur_qr_ms_cluster(n, m)
        if p:
            assert sq.cluster_smem_bytes(n, p, m, zs) <= room
        if not zs:
            assert sq.cluster_smem_bytes(n, 16, m, True) > room
        last[(p, zs)] = n
    # the placements come in one order as n grows, each over one range
    order = sorted(last, key=last.get)
    assert order == [(16, True), (16, False), (0, False)]


def test_cluster_schedule_on_a_cpu_tensor_launches_nothing():
    H, Q = ek.hessenberg_plain(torch.as_tensor(
        _crand((1, 32, 32), 4).astype(np.complex64)))
    before = ek.LAUNCHES['schur_qr_ms']
    T, Z, st = sq.schur_qr_ms(H[0], Q[0], m=8, return_stats=True)
    Tp, Zp, stp = sq.schur_qr_ms_plain(H[0], Q[0], m=8, return_stats=True)
    assert ek.LAUNCHES['schur_qr_ms'] == before
    assert torch.equal(T, Tp) and torch.equal(Z, Zp)
    assert [int(x) for x in st] == [int(x) for x in stp]


# ---------------------------------------------------------------------------
# tri_vectors: the recurrence by columns
# ---------------------------------------------------------------------------

def _schur_T(n, seed, repeat=None, dtype=np.complex128):
    """Upper-triangular complex Schur factor of a random matrix; with
    ``repeat`` = (a, b, c, d, delta): lambda_b = lambda_a exactly (D = 0,
    the pivot becomes dmin) and lambda_d = lambda_c + delta (|D| < dmin
    for a small delta, the pivot is scaled up to dmin)."""
    T, _ = sl.schur(_crand((n, n), seed), output='complex')
    T = T.astype(dtype)
    if repeat is not None:
        a, b, c, d, delta = repeat
        T[b, b] = T[a, a]
        T[d, d] = T[c, c] + delta
    return T


def _floored(T, i, j):
    """Whether the pivot lambda_i - lambda_j is below dmin_j."""
    Tt = torch.as_tensor(T)
    eps, smlnum = ek._consts(Tt.dtype)
    lam = torch.diagonal(Tt)
    dmin = max(eps * max(float(lam[j].abs()),
                         float(Tt.abs().sum(0).amax())), smlnum)
    return float((lam[i] - lam[j]).abs()) < dmin


def _col_err(Y, Yr):
    """max over columns of max|Y - Yr| in the column / max|Yr| in it."""
    return float(((Y - Yr).abs().amax(-2) / Yr.abs().amax(-2)).max())


CASES = {'distinct': None,
         'repeated': (3, 11, 20, 21, 2e-15)}


@pytest.mark.parametrize('n', [40, 160])
@pytest.mark.parametrize('case', sorted(CASES))
def test_column_recurrence_matches_the_rows(n, case):
    # float64: the column order against the row order of tri_vectors_plain
    # within 1e-10 of each column's largest entry (measured ~1e-15); with
    # an exactly repeated eigenvalue (a zero pivot set to dmin) and a
    # near-repeated one (2e-15 apart, under dmin ~ 1e-14: the pivot
    # scaled to dmin) the two columns grow by ~1/dmin and still agree
    T = _schur_T(n, 30 + n, CASES[case])
    if case == 'repeated':
        assert _floored(T, 3, 11) and _floored(T, 20, 21)
    Tt = torch.as_tensor(T)[None]
    Yc = ek.tri_vectors_plain(Tt, by_columns=True)
    Yr = ek.tri_vectors_plain(Tt)
    assert _col_err(Yc, Yr) <= 1e-10
    assert float(torch.tril(Yc, -1).abs().max()) == 0
    assert bool((torch.diagonal(Yc, dim1=-2, dim2=-1) == 1).all())
    if case == 'repeated':
        assert float(Yc[0, :, 11].abs().max()) > 1e10


@pytest.mark.parametrize('n', [16, 32])
@pytest.mark.parametrize('case', sorted(CASES))
def test_column_recurrence_matches_the_pallas_kernel(n, case):
    # float32, the Pallas kernel _kernel_vec in interpret mode on the same
    # T (B = 2 lanes): the column order within 1e-5 of max|Y| per lane, the
    # tolerance of tests/test_torch_eig_kernels.py for the plain version;
    # measured ~1e-7.  Near-repeated in float32: 1e-6 apart against
    # dmin ~ 3e-6
    rep = None if CASES[case] is None else (3, 11, 5, 6, 1e-6)
    T = np.stack([_schur_T(n, 50 + n + b, rep, np.complex64)
                  for b in range(2)])
    if rep is not None:
        assert _floored(T[0], 3, 11) and _floored(T[0], 5, 6)
    Yr, Yi = _call_vec(jnp.asarray(T.real), jnp.asarray(T.imag), True)
    Y_ref = np.asarray(Yr) + 1j * np.asarray(Yi)
    Y = ek.tri_vectors_plain(torch.as_tensor(T), by_columns=True).numpy()
    scale = np.abs(Y_ref).max((-2, -1), keepdims=True)
    assert np.all(np.abs(Y - Y_ref).max((-2, -1), keepdims=True)
                  <= 1e-5 * scale)


def test_vector_slots_by_n():
    # the warp kernel keeps ceil(n / 32) row sums a lane in registers,
    # compiled in steps of 4 slots up to 20 (n <= 640); larger n takes the
    # one-block kernel.  The mirror reads its constants from the source
    src = open(os.path.join(CSRC, 'tri_vectors.cu')).read()
    assert int(re.search(r'kMaxSlots = (\d+);', src).group(1)) \
        == ek.VEC_MAX_SLOTS
    assert int(re.search(r'kSlotStep = (\d+);', src).group(1)) \
        == ek.VEC_SLOT_STEP
    for n, slots in ((1, 4), (64, 4), (128, 4), (129, 8), (338, 12),
                     (450, 16), (578, 20), (640, 20), (641, 0), (882, 0)):
        assert ek.tri_vectors_slots(n) == slots
    # on a CPU tensor the wrapper is the plain version, launching nothing
    T = torch.as_tensor(_schur_T(24, 9, dtype=np.complex64))[None]
    before = ek.LAUNCHES['tri_vectors']
    assert torch.equal(ek.tri_vectors(T), ek.tri_vectors_plain(T))
    assert ek.LAUNCHES['tri_vectors'] == before
