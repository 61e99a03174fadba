"""Port parity of the stand-alone Schur-QR stages: the v2 single-shift QR
(``schur_qr_v2``), the one-launch multishift QR (``schur_qr_ms``), their
shared shift choice (``trailing_shifts_plain``) and ``schur_ms(aed=False)``,
against the JAX package (Pallas kernels in interpret mode) and numpy, on the
CPU; and the device defaults of the port's entry points.

On CPU tensors the port's wrappers take their plain PyTorch versions, which
is what runs here; the CUDA kernels are held against the same plain versions
on the card (chip_smoke.py).  Inputs come from numpy ``default_rng(seed)``.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torcwa_tpu as tt  # noqa: E402
from torcwa_tpu import fmm as jf  # noqa: E402
from torcwa_tpu.ops.eig_qr_real import hessenberg_real  # noqa: E402
from torcwa_tpu.ops.eig_qr_hbm import schur_qr_hbm  # noqa: E402
from torcwa_tpu.ops.eig_qr_pallas import schur_qr_pallas_batched  # noqa: E402
from torcwa_tpu.ops.eig_qr_pallas_ms import schur_qr_pallas_ms  # noqa: E402
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import convert  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops import eig_qr as eq  # noqa: E402
from torcwa_tpu_torch.ops import schur_ms as sm  # noqa: E402
from torcwa_tpu_torch.ops import schur_qr_ms as sq  # noqa: E402

torch.set_num_threads(2)


def _rand(shape, seed, scale=1., dtype=np.complex64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return (scale * a).astype(dtype)


def _np(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _set_dist(w, w_ref):
    """Largest distance between the two eigenvalue sets, either way."""
    d = np.abs(w[:, None] - w_ref[None, :])
    return max(d.min(axis=1).max(), d.min(axis=0).max())


def _hess_jax(A):
    """Hessenberg form by the JAX package, as numpy complex64 (H, Q) and as
    the split-real float32 pairs its kernels take."""
    with jax.default_matmul_precision('highest'):
        pairs = hessenberg_real(jnp.asarray(A.real, jnp.float32),
                                jnp.asarray(A.imag, jnp.float32))
    H = _np(pairs[0], pairs[1]).astype(np.complex64)
    Q = _np(pairs[2], pairs[3]).astype(np.complex64)
    return H, Q, pairs


def _schur_checks(A, T, Z, tol=5e-5):
    """T upper triangular, Z T Z^H = A within tol ||A||, Z unitary."""
    T = T.numpy().astype(np.complex128)
    Z = Z.numpy().astype(np.complex128)
    A = A.astype(np.complex128)
    assert np.abs(np.tril(T, -1)).max() == 0
    assert np.linalg.norm(Z @ T @ Z.conj().T - A) <= tol * np.linalg.norm(A)
    assert np.abs(Z.conj().T @ Z - np.eye(A.shape[-1])).max() <= tol


# ---------------------------------------------------------------------------
# the shift choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('lo,hi,m', [(0, 39, 8), (30, 35, 8), (33, 35, 16)])
def test_trailing_shifts_plain_against_numpy(lo, hi, m):
    # a full m x m block, and blocks cut by the active window [lo, hi]: the
    # real candidates are the block's eigenvalues (1e-4 of its spectral
    # radius), the first is the one nearest H[hi, hi], distances do not
    # decrease, and the m - (hi - base + 1) padding lanes, value 0, are last
    n = 40
    H = np.triu(_rand((n, n), 11), -1)
    if lo > 0:
        H[lo, lo - 1] = 0
    base = max(hi - (m - 1), lo)
    L = hi - base + 1
    sh = sm.trailing_shifts_plain(torch.as_tensor(H), lo, hi, m).numpy()
    assert sh.shape == (m,)
    assert sq.trailing_shifts_plain is sm.trailing_shifts_plain
    w = np.linalg.eigvals(H[base:hi + 1, base:hi + 1].astype(np.complex128))
    rho = np.abs(w).max()
    assert _set_dist(sh[:L].astype(np.complex128), w) <= 1e-4 * rho
    assert np.all(sh[L:] == 0)
    dist = np.abs(sh[:L] - H[hi, hi])
    assert np.all(np.diff(dist) >= -1e-4 * rho)
    assert abs(dist[0] - np.abs(w - H[hi, hi]).min()) <= 1e-4 * rho


def test_trailing_shifts_plain_exceptional_sweep():
    # the perturbed trailing diagonal: d + 0.75 |sub| on the real part, the
    # subdiagonal being the one below the entry, nothing added at hi;
    # positions beyond hi repeat hi
    n, lo, hi, m = 24, 17, 20, 6
    H = np.triu(_rand((n, n), 5), -1)
    sh = sm.trailing_shifts_plain(torch.as_tensor(H), lo, hi, m, exc=True)
    pos = np.minimum(max(hi - (m - 1), lo) + np.arange(m), hi)
    sub = np.where(pos + 1 <= hi, np.abs(H[np.minimum(pos + 1, n - 1), pos]),
                   0.)
    want = H[pos, pos] + 0.75 * sub
    assert np.abs(sh.numpy() - want).max() <= 1e-6 * np.abs(H).max()


# ---------------------------------------------------------------------------
# the v2 single-shift QR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('B,n', [(1, 12), (3, 20)])
def test_schur_qr_v2_plain_matches_the_pallas_kernel(B, n):
    # the same float32 H, Q into both; float32 round-off over ~3 n sweeps:
    # eigenvalue sets within 1e-4 max|w|, Schur residual 5e-5 ||H||
    A = _rand((B, n, n), n)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A))
    with jax.default_matmul_precision('highest'):
        Tr, Ti, _, _ = schur_qr_pallas_batched(
            jnp.asarray(H.real.numpy()), jnp.asarray(H.imag.numpy()),
            jnp.asarray(Q.real.numpy()), jnp.asarray(Q.imag.numpy()),
            interpret=True)
    T, Z, (hi, sweeps, rot) = ek.schur_qr_v2(H, Q, return_stats=True)
    assert ek.LAUNCHES['schur_qr_v2'] == 0              # CPU: no launch
    assert bool((hi == 0).all()) and int(sweeps.max()) < 40 * n
    assert bool((rot >= sweeps).all()) and bool((rot < sweeps * n).all())
    for b in range(B):
        w = torch.diagonal(T[b]).numpy().astype(np.complex128)
        w_ref = np.diagonal(_np(Tr[b], Ti[b]))
        w_np = np.linalg.eigvals(A[b].astype(np.complex128))
        rho = np.abs(w_np).max()
        assert _set_dist(w, w_ref) <= 1e-4 * rho
        assert _set_dist(w, w_np) <= 1e-4 * rho
        _schur_checks(A[b], T[b], Z[b])


def test_schur_qr_v2_out_of_budget_is_not_poisoned():
    # the JAX entry hands a lane that ran out of budget back as it stands;
    # schur_qr, on the same input, poisons it
    A = _rand((2, 16, 16), 2)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A))
    T, Z, (hi, sweeps, _) = ek.schur_qr_v2(H, Q, max_iter_factor=1,
                                           return_stats=True)
    assert bool((hi > 0).all()) and bool((sweeps == 16).all())
    _, _, (_, sweeps5, _) = ek.schur_qr_v2(H, Q, max_iters=5,
                                           return_stats=True)
    assert bool((sweeps5 == 5).all())
    assert bool(torch.isfinite(torch.view_as_real(T)).all())
    assert float(torch.tril(T, -1).abs().max()) == 0
    Tq, _ = ek.schur_qr(H, Q, max_iter_factor=1)
    assert bool(torch.isnan(torch.diagonal(Tq, dim1=-2, dim2=-1)).all())
    with pytest.raises(ValueError):
        ek.schur_qr_v2(H[0], Q[0])                      # not (B, n, n)


# ---------------------------------------------------------------------------
# the one-launch multishift QR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n,m', [(16, 2), (32, 4)])
def test_schur_qr_ms_plain_matches_the_pallas_kernel(n, m):
    # the cases of tests/test_eig_multishift.py::test_random_spectra that
    # finish quickly in the interpreter; same H, Q into both
    rng = np.random.default_rng(n + m)
    A = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))).astype(np.complex64)
    H, Q, pairs = _hess_jax(A)
    with jax.default_matmul_precision('highest'):
        Tr, Ti, _, _, (hi_ref, sweeps_ref) = schur_qr_pallas_ms(
            *pairs, m=m, interpret=True, return_stats=True)
    T, Z, (hi, sweeps, rot) = sq.schur_qr_ms(
        torch.as_tensor(H), torch.as_tensor(Q), m=m, return_stats=True)
    assert ek.LAUNCHES['schur_qr_ms'] == 0              # CPU: no launch
    assert int(hi) == 0 and int(hi_ref) == 0
    assert int(sweeps) < 2 * n
    assert int(sweeps_ref) / 2 <= int(sweeps) <= 2 * int(sweeps_ref)
    assert int(rot) > 0
    w = torch.diagonal(T).numpy().astype(np.complex128)
    w_np = np.linalg.eigvals(A.astype(np.complex128))
    rho = np.abs(w_np).max()
    assert _set_dist(w, np.diagonal(_np(Tr, Ti))) <= 1e-4 * rho
    assert _set_dist(w, w_np) <= 1e-4 * rho
    _schur_checks(A, T, Z)


def test_schur_qr_ms_plain_zero_diagonal_endgame():
    # antisymmetric real matrix: zero diagonal in Hessenberg form, spectrum
    # +-i lambda; the padding lanes of a cut shift block must never lead
    # (the regression of tests/test_eig_hbm.py::test_ms_zero_diagonal_endgame,
    # through the plain version only)
    n = 64
    rng = np.random.default_rng(0)
    M = rng.standard_normal((n, n)).astype(np.float32)
    A = ((M - M.T) / 2).astype(np.complex64)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A)[None])
    T, Z, (hi, sweeps, _) = sq.schur_qr_ms_plain(H[0], Q[0], m=16,
                                                 return_stats=True)
    assert int(hi) == 0
    w = torch.diagonal(T).numpy()
    assert np.isfinite(w).all()
    w_ref = np.linalg.eigvals(A.astype(np.complex128))
    assert np.abs(w.real).max() < 1e-3
    assert np.max(np.abs(np.sort(w.imag) - np.sort(w_ref.imag))) < 1e-3
    _schur_checks(A, T, Z)


def test_schur_qr_ms_out_of_budget_gives_nan():
    # tests/test_eig_multishift.py::test_nonconvergence_nan_contract
    A = _rand((24, 24), 1)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A)[None])
    T, _, (hi, sweeps, _) = sq.schur_qr_ms(H[0], Q[0], m=4,
                                           max_iter_factor=-100,
                                           return_stats=True)
    assert int(hi) > 0 and int(sweeps) == 0
    assert bool(torch.isnan(torch.diagonal(T)).all())


def test_schur_qr_ms_plain_float64():
    n = 40
    A = _rand((n, n), 9, dtype=np.complex128)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A)[None])
    T, Z, (hi, _, _) = sq.schur_qr_ms(H[0], Q[0], m=6, return_stats=True)
    assert int(hi) == 0
    w = torch.diagonal(T).numpy()
    w_np = np.linalg.eigvals(A)
    assert _set_dist(w, w_np) <= 1e-10 * np.abs(w_np).max()
    _schur_checks(A, T, Z, 1e-10)


def test_schur_qr_ms_refuses_what_it_does_not_take():
    H = torch.as_tensor(_rand((8, 8), 0))
    with pytest.raises(ValueError):
        sq.schur_qr_ms(H, H, m=65)
    with pytest.raises(ValueError):
        sq.schur_qr_ms(H[None], H[None])                # one matrix only
    with pytest.raises(ValueError):
        sq.schur_qr_ms(H, H.to(torch.complex128))


# ---------------------------------------------------------------------------
# schur_ms without AED
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [48, 96])
def test_schur_ms_plain_without_aed_matches_the_pallas_kernel(n):
    # shifts from the trailing m x m block on both sides, same H, Q, same
    # deflation multiplier; the same matrix with AED needs at least 2x fewer
    # sweeps (the JAX test asks 3x at n = 300)
    A = _rand((n, n), 3, 0.3)
    H, Q, pairs = _hess_jax(A)
    with jax.default_matmul_precision('highest'):
        Tr, Ti, _, _, st_ref = schur_qr_hbm(
            *pairs, m=8, wb=256, defl_mult=1.0, aed=False, interpret=True,
            return_stats=True)
    H, Q = torch.as_tensor(H), torch.as_tensor(Q)
    T, Z, st = sm.schur_ms(H, Q, m=8, wb=256, defl_mult=1.0, aed=False,
                           return_stats=True)
    assert ek.LAUNCHES['schur_ms'] == 0                 # CPU: no launch
    assert st[0] == 0 and int(st_ref[0]) == 0
    assert st[2] == 0 and st[3] == 0        # no AED deflation, no skipped chase
    assert int(st_ref[1]) / 2 <= st[1] <= 2 * int(st_ref[1])
    w = torch.diagonal(T).numpy().astype(np.complex128)
    w_np = np.linalg.eigvals(A.astype(np.complex128))
    rho = np.abs(w_np).max()
    assert _set_dist(w, np.diagonal(_np(Tr, Ti))) <= 1e-4 * rho
    assert _set_dist(w, w_np) <= 1e-4 * rho
    _schur_checks(A, T, Z)
    _, _, st_aed = sm.schur_ms_plain(H, Q, m=8, wb=256, kw=24, defl_mult=1.0,
                                     return_stats=True)
    assert st_aed[0] == 0 and 2 * st_aed[1] <= st[1]


# ---------------------------------------------------------------------------
# the composed eig and the slice through each stage
# ---------------------------------------------------------------------------

def _stage(name):
    if name == 'schur_qr_v2':
        return ek.schur_qr_v2
    return eq.lane_by_lane(sq.schur_qr_ms, m=8)


@pytest.mark.parametrize('name', ['schur_qr_v2', 'schur_qr_ms'])
def test_composed_eig_through_each_stage(name):
    # Hessenberg -> the stage -> vectors -> V = Z Y -> unit columns ->
    # refinement at n = 50: A V = V diag(w) to 5e-4 max|w| (the bound of
    # tests/test_eig_multishift.py::test_full_eig_via_multishift_plus_vectors)
    A = torch.as_tensor(_rand((2, 50, 50), 4))
    w, V = eq.eig_small(A, _stage(name))
    w_np = np.linalg.eigvals(A.numpy().astype(np.complex128))
    for b in range(2):
        rho = np.abs(w_np[b]).max()
        assert _set_dist(w[b].numpy().astype(np.complex128), w_np[b]) \
            <= 1e-4 * rho
        res = (A[b] @ V[b] - V[b] * w[b][None, :]).abs().max()
        assert float(res) <= 5e-4 * rho
    nrm = torch.linalg.vector_norm(V, dim=-2)
    assert float((nrm - 1).abs().max()) <= 1e-5


def test_eig_qr_small_route_is_the_composition_with_schur_qr(monkeypatch):
    # the small route of eig_qr is eig_small with SMALL_SCHUR, read at call
    # time: same result as the explicit composition, and a swapped stage is
    # the one that runs
    A = torch.as_tensor(_rand((2, 24, 24), 6))
    w, V = eq.eig_qr(A)
    w2, V2 = eq.eig_small(A, ek.schur_qr)
    assert torch.equal(w, w2) and torch.equal(V, V2)
    calls = []
    monkeypatch.setattr(eq, 'SMALL_SCHUR', lambda H, Q: (
        calls.append(1), ek.schur_qr_v2(H, Q))[1])
    eq.eig_qr(A)
    assert calls == [1]


@pytest.mark.parametrize('name', ['schur_qr_ms', 'schur_qr_v2'])
def test_simulate_txx_through_each_stage_matches_jax(monkeypatch, name):
    # the slice of tests/test_torch_slice.py (order (2, 2), grid 32, 2N =
    # 50) at 10 degrees, float32, with the small route's Schur stage
    # swapped, against the JAX package in float64: |t_xx|^2 to 1e-4,
    # raster-gradient cosine >= 0.99
    monkeypatch.setattr(eq, 'SMALL_SCHUR', _stage(name))
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
    assert abs(float(T.detach()) - float(T_ref)) <= 1e-4
    assert np.isfinite(got).all()
    cos = (got * g_ref).sum() / (np.linalg.norm(got) * np.linalg.norm(g_ref))
    assert cos >= 0.99


# ---------------------------------------------------------------------------
# device defaults
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card():
    # rasters and converted inputs land on the CUDA card unless the caller
    # says device='cpu'; nothing is allocated here
    def default(fn):
        return inspect.signature(fn).parameters['device'].default

    assert default(tp.geometry.__init__) == 'cuda'
    assert default(convert.to_complex) == 'cuda'
    assert default(convert.from_jax_pairs) == 'cuda'
    assert tp.rcwa_geo.device == 'cuda'
    assert tp.geometry(device='cpu').device == torch.device('cpu')
