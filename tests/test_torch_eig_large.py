"""Port parity on the large-n eig route: the blocked Hessenberg reduction,
the multishift AED Schur QR and the blocked triangular eigenvectors against
the JAX package (Pallas kernels in interpret mode) and numpy, on the CPU.

On CPU tensors the port's wrappers take their plain PyTorch versions, which
is what runs here; the CUDA kernels are held against the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).  Inputs
come from numpy ``default_rng(seed)``.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torcwa_tpu as tt  # noqa: E402
from torcwa_tpu import fmm as jf  # noqa: E402
from torcwa_tpu.ops.eig_qr_real import hessenberg_real, schur_qr_real  # noqa: E402
from torcwa_tpu.ops.eig_qr_hbm import schur_qr_hbm  # noqa: E402
from torcwa_tpu.ops.hess_blocked import hessenberg_blocked as jax_hess_blocked  # noqa: E402
from torcwa_tpu.ops.vec_blocked import eig_tri_vectors_blocked  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import convert  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops import eig_qr as eq  # noqa: E402
from torcwa_tpu_torch.ops import hess_blocked as hb  # noqa: E402
from torcwa_tpu_torch.ops import schur_ms as sm  # noqa: E402
from torcwa_tpu_torch.ops import vec_blocked as vb  # noqa: E402
from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked  # noqa: E402

torch.set_num_threads(2)


def _rand(n, seed, scale=1., dtype=np.complex128):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return (scale * a).astype(dtype)


def _pair(z, rd=jnp.float32):
    return jnp.asarray(z.real, rd), jnp.asarray(z.imag, rd)


def _np(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _set_dist(w, w_ref):
    """Largest distance from an entry of w to its nearest in w_ref."""
    return np.abs(w[:, None] - w_ref[None, :]).min(axis=1).max()


def _schur_checks(H, T, Z, tol=1e-4):
    """T upper triangular, Z unitary, Z T Z^H the matrix H that Z's
    starting value reduced (the original A when Z started from Q)."""
    n = H.shape[-1]
    T, Z = T.numpy().astype(np.complex128), Z.numpy().astype(np.complex128)
    assert np.abs(np.tril(T, -1)).max() == 0
    assert np.linalg.norm(Z @ T @ Z.conj().T - H) <= tol * np.linalg.norm(H)
    assert np.abs(Z.conj().T @ Z - np.eye(n)).max() <= tol


# ---------------------------------------------------------------------------
# blocked Hessenberg
# ---------------------------------------------------------------------------

def test_hessenberg_blocked_matches_jax():
    # n = 70 is not a multiple of the panel (16); float64, same reflector
    # convention and panel algebra on both sides, so H and Q agree element
    # by element to 1e-10 max|A|; against the unblocked plain version the
    # comparison is gauge-free (reconstruction and unitarity)
    n = 70
    A = _rand(n, 0)
    with jax.default_matmul_precision('highest'):
        Hr, Hi, Qr, Qi = jax_hess_blocked(*_pair(A, jnp.float64), panel=16)
    H, Q = hessenberg_blocked(torch.as_tensor(A), panel=16)
    H, Q = H.numpy(), Q.numpy()
    amax, fro = np.abs(A).max(), np.linalg.norm(A)
    assert np.abs(H - _np(Hr, Hi)).max() <= 1e-10 * amax
    assert np.abs(Q - _np(Qr, Qi)).max() <= 1e-10
    assert np.abs(np.tril(H, -2)).max() == 0
    assert np.linalg.norm(Q @ H @ Q.conj().T - A) <= 1e-12 * fro
    Hp, Qp = ek.hessenberg_plain(torch.as_tensor(A)[None])
    Hp, Qp = Hp[0].numpy(), Qp[0].numpy()
    assert np.linalg.norm(Qp @ Hp @ Qp.conj().T - Q @ H @ Q.conj().T) \
        <= 1e-12 * fro
    assert np.abs(Q.conj().T @ Q - np.eye(n)).max() <= 1e-12


@pytest.mark.parametrize('n', [1, 2, 3, 17])
def test_hessenberg_blocked_small_orders(n):
    A = _rand(n, n)
    H, Q = hessenberg_blocked(torch.as_tensor(A), panel=4)
    H, Q = H.numpy(), Q.numpy()
    assert np.abs(np.tril(H, -2)).max() == 0
    assert np.linalg.norm(Q @ H @ Q.conj().T - A) <= 1e-12 * np.linalg.norm(A)


def _hess_checks(A, H, Q, tol=1e-12):
    """H Hessenberg, Q unitary and Q H Q^H = A, at float64."""
    n = A.shape[-1]
    assert np.abs(np.tril(H, -2)).max(initial=0) == 0
    assert np.linalg.norm(Q @ H @ Q.conj().T - A) <= tol * np.linalg.norm(A)
    assert np.abs(Q.conj().T @ Q - np.eye(n)).max() <= tol


def _jax_blocked(A, panel):
    with jax.default_matmul_precision('highest'):
        Hr, Hi, Qr, Qi = jax_hess_blocked(*_pair(A, jnp.float64), panel=panel)
    return _np(Hr, Hi), _np(Qr, Qi)


def _zero_columns(A):
    """A whose columns 0 and 5 reduce to x = 0 (beta = 0): column 0 zero
    below the diagonal, and A[6:, :6] = 0, which the reflectors of columns
    1-4 (rows 2-5) keep."""
    A = A.copy()
    A[1:, 0] = 0
    A[6:, :6] = 0
    return A


@pytest.mark.parametrize('panel', [4, 16, 128])
@pytest.mark.parametrize('n', [18, 64, 130, 257])
def test_hess_panel_plain_matches_the_column_loop_and_jax(n, panel,
                                                         monkeypatch):
    # float64: the model of the kernel's schedule (row-block partial sums,
    # the merged reduction for ||x||^2 and V^H x, T formed from V^H x)
    # against the plain column loop, panel by panel on the first panel with
    # the kernel's grid, 3 blocks and more blocks than rows; then whole
    # reductions through the model against the JAX package.  n = 257 in
    # panels of 128 ends in a short panel (127 columns), 64 in panels of 16
    # too (14); n = 64 has the two zero columns of _zero_columns
    A = _rand(n, 1000 + n)
    if n == 64:
        A = _zero_columns(A)
    p = min(panel, n - 2)
    At = torch.as_tensor(A)
    ref = hb._columns(At, p, p)
    for rows, blocks in ((None, None), (-(-n // 3), None), (1, n + 5)):
        got = hb.hess_panel_plain(At, p, p, rows=rows, blocks=blocks)
        for g, r in zip(got, ref):
            assert float((g - r).abs().max()) <= 1e-11 * float(r.abs().max())
    if n == 64:
        T = ref[2].numpy()
        assert T[0, 0] == 0 and T[1, 1] > 0 and (p <= 5 or T[5, 5] == 0)
    monkeypatch.setattr(hb, 'hess_panel', hb.hess_panel_plain)
    H, Q = (X.numpy() for X in hessenberg_blocked(At, panel=panel))
    Hj, Qj = _jax_blocked(A, panel)
    assert np.abs(H - Hj).max() <= 1e-10 * np.abs(A).max()
    assert np.abs(Q - Qj).max() <= 1e-10
    _hess_checks(A, H, Q)


def test_hess_panel_plain_with_empty_blocks_and_zero_columns(monkeypatch):
    # more blocks than rows of every panel's trailing block (empty blocks
    # add zero partials) through a whole reduction with the two zero
    # columns, against the plain loop's reduction
    n = 40
    A = _zero_columns(_rand(n, 7))
    At = torch.as_tensor(A)
    H0, Q0 = (X.numpy() for X in hessenberg_blocked(At, panel=8))
    monkeypatch.setattr(hb, 'hess_panel', lambda At, p, cols:
                        hb.hess_panel_plain(At, p, cols, rows=1,
                                            blocks=2 * n))
    H, Q = (X.numpy() for X in hessenberg_blocked(At, panel=8))
    assert np.abs(H - H0).max() <= 1e-12 * np.abs(A).max()
    assert np.abs(Q - Q0).max() <= 1e-12
    _hess_checks(A, H, Q)


@pytest.mark.parametrize('t,vy_smem,stage', [
    (12, True, True), (512, True, True), (882, True, True),
    (1922, True, True), (3362, True, True), (5202, False, True),
    (20000, False, False)])
def test_hess_panel_plan_picks_the_grid_by_size(t, vy_smem, stage):
    # at most one block a SM, at least MIN_ROWS rows a block, every row
    # owned and no block empty, within a block's shared memory; V and Y
    # rows leave shared memory from n ~ 3700 at p = 128, the staged v from
    # n ~ 11000
    g = hb.hess_panel_plan(t, 128)
    assert 1 <= g['blocks'] <= hb.SMS
    assert (g['blocks'] - 1) * g['rows'] < t <= g['blocks'] * g['rows']
    assert g['rows'] >= min(t, hb.MIN_ROWS)
    assert g['smem_bytes'] <= hb.SMEM_PER_BLOCK
    assert (g['vy_smem'], g['stage']) == (vy_smem, stage)
    assert hb.hess_panel_plan(t, 128, sms=8)['blocks'] <= 8


def test_hess_panel_wrapper_takes_the_loop_on_the_cpu_and_raises_elsewhere():
    A = torch.as_tensor(_rand(20, 3).astype(np.complex64))
    ek.reset_launch_counts()
    got = hb.hess_panel(A[4:, 4:], 8, 8)
    for g, r in zip(got, hb._columns(A[4:, 4:], 8, 8)):
        assert torch.equal(g, r)
    assert ek.LAUNCHES['hess_panel'] == 0               # CPU: no launch
    with pytest.raises(RuntimeError, match='no kernel'):
        hb.hess_panel(torch.empty(20, 20, dtype=torch.complex64,
                                  device='meta'), 8, 8)
    with pytest.raises(ValueError):
        hb.hess_panel(A, 8, 19)


def test_eig_hess_counts_the_panels_of_the_plain_loop():
    from torcwa_tpu_torch.utils import timing
    with timing.tracing() as tr:
        hessenberg_blocked(torch.as_tensor(_rand(30, 4)), panel=8)
        tr.collect()
    hess, = [s for s in tr.records if s.name == 'eig.hess']
    assert hess.counters == {'plain_panels': 4}


# ---------------------------------------------------------------------------
# blocked triangular eigenvectors
# ---------------------------------------------------------------------------

def test_tri_vectors_blocked_matches_jax_and_the_resident_version():
    # the same float32 T, Z into both: columns agree up to a phase (the
    # JAX side normalises V = Z Y); against the port's own resident plain
    # version Y agrees to 1e-4 relative (other summation order)
    n = 96
    A = _rand(n, 5, 0.3)
    with jax.default_matmul_precision('highest'):
        Hr, Hi, Qr, Qi = hessenberg_real(*_pair(A))
        Tr, Ti, Zr, Zi = schur_qr_real(Hr, Hi, Qr, Qi)
        Vr, Vi = eig_tri_vectors_blocked(Tr, Ti, Zr, Zi, block=32,
                                         interpret=True)
    T = torch.as_tensor(_np(Tr, Ti).astype(np.complex64))
    Z = _np(Zr, Zi)
    Y = vb.tri_vectors_blocked(T, block=32)
    assert ek.LAUNCHES['tri_vectors_blocked'] == 0      # CPU: no launch
    V = Z @ Y.numpy()
    V_ref = _np(Vr, Vi)
    num = np.abs(np.sum(np.conj(V) * V_ref, axis=0))
    den = np.linalg.norm(V, axis=0) * np.linalg.norm(V_ref, axis=0)
    assert np.min(num / den) >= 1 - 1e-3
    Yp = ek.tri_vectors_plain(T[None])[0]
    assert float((Y - Yp).abs().max()) <= 1e-4 * float(Yp.abs().max())
    assert float(torch.tril(Y, -1).abs().max()) == 0
    assert bool((torch.diagonal(Y) == 1).all())


# ---------------------------------------------------------------------------
# multishift AED Schur QR
# ---------------------------------------------------------------------------

def test_schur_ms_plain_matches_the_pallas_kernel():
    # the configuration of tests/test_eig_hbm.py::test_hbm_small_block_fast:
    # the AED window (24) is larger than the active block near the end, the
    # nibble rule skips chases, one chase window covers the matrix
    n = 48
    A = _rand(n, 0, 0.3)
    with jax.default_matmul_precision('highest'):
        Hr, Hi, Qr, Qi = hessenberg_real(*_pair(A))
        Tr, Ti, Zr, Zi, st_ref = schur_qr_hbm(
            Hr, Hi, Qr, Qi, m=4, wb=256, kw=24, defl_mult=4.0,
            interpret=True, return_stats=True)
    hi_ref, sweeps_ref, aed_ref, skipped_ref = (int(x) for x in st_ref[:4])
    H = _np(Hr, Hi).astype(np.complex64)
    T, Z, (hi, sweeps, aed_d, skipped, done, need) = sm.schur_ms(
        torch.as_tensor(H), torch.as_tensor(_np(Qr, Qi).astype(np.complex64)),
        m=4, wb=256, kw=24, return_stats=True)
    assert ek.LAUNCHES['schur_ms'] == 0                 # CPU: no launch
    assert hi == 0 and hi_ref == 0
    w = torch.diagonal(T).numpy().astype(np.complex128)
    w_ref = np.diagonal(_np(Tr, Ti))
    w_np = np.linalg.eigvals(A.astype(np.complex64).astype(np.complex128))
    assert _set_dist(w, w_ref) <= 1e-3 and _set_dist(w_ref, w) <= 1e-3
    assert _set_dist(w, w_np) <= 1e-3 and _set_dist(w_np, w) <= 1e-3
    _schur_checks(A.astype(np.complex64).astype(np.complex128), T, Z)
    assert aed_d > n // 2 and aed_ref > n // 2
    assert skipped > 0 and skipped_ref > 0
    assert 0 < need <= done          # the windowing only adds operations
    assert sweeps_ref / 2 <= sweeps <= 2 * sweeps_ref


def _ms_case(A, **kw):
    A = torch.as_tensor(A)
    H, Q = ek.hessenberg_plain(A[None])
    T, Z, st = sm.schur_ms_plain(H[0], Q[0], return_stats=True, **kw)
    return T, Z, st


def test_schur_ms_plain_zero_diagonal_endgame():
    # antisymmetric real matrix: zero diagonal in Hessenberg form, spectrum
    # +-i lambda; deflated or padding lanes must never lead the shifts
    # (the regression of tests/test_eig_hbm.py::test_hbm_zero_diagonal_endgame)
    n = 96
    rng = np.random.default_rng(1)
    M = rng.standard_normal((n, n)).astype(np.float32)
    A = ((M - M.T) / 2).astype(np.complex64)
    T, Z, st = _ms_case(A, m=8, kw=24, wb=256)
    assert st[0] == 0
    w = torch.diagonal(T).numpy()
    assert np.isfinite(w).all()
    w_ref = np.linalg.eigvals(A.astype(np.complex128))
    assert np.abs(w.real).max() < 1e-3
    assert np.max(np.abs(np.sort(w.imag) - np.sort(w_ref.imag))) < 1e-3
    _schur_checks(A.astype(np.complex128), T, Z)


@pytest.mark.parametrize('n,dtype,tol', [(160, np.complex64, 1e-4),
                                         (300, np.complex64, 1e-4),
                                         (130, np.complex128, 1e-12)])
def test_schur_ms_plain_overlapping_windows(n, dtype, tol):
    # wb = 128 with a window advance of 64: at least two chase windows
    # overlap, bulges rest in H between them, and the slab products of
    # every window reach H and Z
    A = _rand(n, 3, 0.3, dtype)
    T, Z, st = _ms_case(A, m=8, kw=24, wb=128)
    assert st[0] == 0
    w = torch.diagonal(T).numpy().astype(np.complex128)
    w_ref = np.linalg.eigvals(A.astype(np.complex128))
    rho = np.abs(w_ref).max()
    assert _set_dist(w, w_ref) <= 10 * tol * rho
    assert _set_dist(w_ref, w) <= 10 * tol * rho
    _schur_checks(A.astype(np.complex128), T, Z, tol)
    assert st[2] > n // 2


def test_schur_ms_budget_of_one_sweep_gives_nan():
    A = _rand(64, 2, 0.3, np.complex64)
    T, _, st = _ms_case(A, m=8, kw=24, wb=256, budget=1)
    assert st[0] > 0 and st[1] == 1
    assert bool(torch.isnan(torch.diagonal(T)).all())


def test_schur_ms_refuses_what_is_not_ported():
    H = torch.as_tensor(_rand(64, 0))
    with pytest.raises(ValueError):
        sm.schur_ms(H, H, m=64, wb=128)          # window too small
    with pytest.raises(ValueError):
        sm.schur_ms(H, H, m=32, kw=24)           # more shifts than window


def test_ms_slab_products_on_the_cpu_are_matmuls():
    # ms_apply_window on CPU tensors: a window at the top (only the rows
    # right of it), one at the bottom (only the columns above it and Z's)
    X, Z = torch.as_tensor(_rand(40, 8)), torch.as_tensor(_rand(40, 9))
    P = torch.as_tensor(_rand(7, 10))
    ref = X.clone()
    ref[:7, 7:] = P @ X[:7, 7:]
    got, _ = sm.ms_apply_window(X.clone(), Z[:0], 0, 7, P)
    assert torch.equal(got, ref)
    ref, ref_Z = X.clone(), Z.clone()
    ref[:33, 33:] = X[:33, 33:] @ P.mH
    ref_Z[:, 33:] = Z[:, 33:] @ P.mH
    got, got_Z = sm.ms_apply_window(X.clone(), Z.clone(), 33, 7, P)
    assert torch.equal(got, ref) and torch.equal(got_Z, ref_Z)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def test_eig_qr_large_route_solves_the_eigenproblem(monkeypatch):
    # LARGE_MIN_N patched down: a complex64 (2, 64, 64) batch runs lane by
    # lane through hessenberg_blocked, through one schur_ms call with its
    # lanes in lock step, lane by lane through tri_vectors_blocked, and the
    # refinement; eigenvalues within 1e-4 of the spectral radius of
    # complex128 LAPACK's, eigen-residual 1e-4 ||A||_2
    monkeypatch.setattr(eq, 'LARGE_MIN_N', 32)
    calls = []
    monkeypatch.setattr(eq, 'schur_ms', lambda *a, **k: (
        calls.append(1), sm.schur_ms(*a, **k))[1])
    rng = np.random.default_rng(7)
    a = rng.standard_normal((2, 64, 64)) + 1j * rng.standard_normal(
        (2, 64, 64))
    A = torch.as_tensor(a.astype(np.complex64))
    w, V = eq.eig_qr(A)
    assert len(calls) == 1
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    dist = (w.to(torch.complex128)[..., :, None]
            - w_ref[..., None, :]).abs().amin(-1).amax(-1)
    assert bool((dist <= 1e-4 * w_ref.abs().amax(-1)).all())
    res = (A @ V - V * w[..., None, :]).abs().amax((-2, -1))
    assert bool((res <= 1e-4 * torch.linalg.matrix_norm(A, ord=2)).all())
    nrm = torch.linalg.vector_norm(V, dim=-2)
    assert float((nrm - 1).abs().max()) <= 1e-5


def test_simulate_txx_through_the_large_route_matches_jax(monkeypatch):
    # the slice of tests/test_torch_slice.py (order (2, 2), grid 32, 2N =
    # 50) at 10 degrees, float32, forced through the large route, against
    # the JAX package in float64: |t_xx|^2 to 1e-4, raster-gradient cosine
    # >= 0.99
    monkeypatch.setattr(eq, 'LARGE_MIN_N', 32)
    order, L, grid, thick = (2, 2), (300., 300.), 32, 600.
    eps_hi, eps_sub, lam = 2.0709 ** 2, 1.46 ** 2, 450.
    inc = float(np.deg2rad(10.))
    g = tt.geometry(Lx=L[0], Ly=L[1], nx=grid, ny=grid, edge_sharpness=500.,
                    dtype=np.float64)
    occ = np.asarray(g.rectangle(160., 160., L[0] / 2, L[1] / 2))
    eps = occ * eps_hi + (1. - occ)
    spec = jf.StackSpec(order=order, L=L, n_layers=1, has_input=True)
    one = (jnp.asarray(1.), jnp.asarray(0.))
    sub = (jnp.asarray(eps_sub), jnp.asarray(0.))

    def loss_jax(er):
        S, intr = jf.solve_stack_pair(
            spec, jnp.asarray(1 / lam), jnp.asarray(inc), jnp.asarray(0.),
            (er[None], jnp.zeros_like(er)[None]), jnp.asarray([thick]),
            eps_in=sub)
        tr, ti = jf.sparam_xy_pair(S, intr['kx'], intr['ky'], sub, one,
                                   order, [0, 0], [0, 0], 'xx')
        return (tr ** 2 + ti ** 2)[0]

    T_ref, g_ref = jax.value_and_grad(loss_jax)(jnp.asarray(eps))
    g_ref = np.asarray(g_ref)

    e32 = eps.astype(np.float32)
    cv = convert.from_jax_pairs(eps_grids=(e32[None], np.zeros_like(e32)[None]),
                                spec=spec, device='cpu')
    er = cv['eps_grids'].real[0].clone().requires_grad_(True)
    T = tp.simulate_txx(cv['spec'], torch.as_tensor([1 / lam],
                                                    dtype=torch.float32),
                        er, thick, eps_sub, inc_ang=inc)
    T.sum().backward()
    got = er.grad.double().numpy()
    assert abs(float(T) - float(T_ref)) <= 1e-4
    assert np.isfinite(got).all()
    cos = (got * g_ref).sum() / (np.linalg.norm(got) * np.linalg.norm(g_ref))
    assert cos >= 0.99
