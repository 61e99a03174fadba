"""Port parity of the two batched Schur-QR stages that are on no route of
``eig_qr``: the multishift QR with in-launch AED (``schur_qr_baed``) and the
packed-layout single-shift QR (``schur_qr_packed``), against the JAX package
(``attic/eig_qr_pallas_baed.py`` and ``attic/eig_qr_pallas_packed.py``, Pallas
kernels in interpret mode) and numpy, on the CPU.

On CPU tensors the port's wrappers take their plain PyTorch versions, which
is what runs here; the CUDA kernels are held against the same plain versions
on the card (chip_smoke.py, tests/test_torch_cuda.py).  Inputs come from numpy
``default_rng(seed)`` and go through the JAX package's ``hessenberg_real``
into both sides.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torcwa_tpu as tt  # noqa: E402
from torcwa_tpu import fmm as jf  # noqa: E402
from torcwa_tpu.ops import eig_qr_real as eqr  # noqa: E402
from torcwa_tpu.ops.attic.eig_qr_pallas_baed import (  # noqa: E402
    schur_qr_pallas_baed)
from torcwa_tpu.ops.attic.eig_qr_pallas_packed import (  # noqa: E402
    schur_qr_pallas_packed)
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch import convert  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops import eig_qr as eq  # noqa: E402
from torcwa_tpu_torch.ops import schur_ms as sm  # noqa: E402
from torcwa_tpu_torch.ops import schur_qr_baed as sb  # noqa: E402
from torcwa_tpu_torch.ops import schur_qr_packed as sp  # noqa: E402

torch.set_num_threads(2)


def _np(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _set_dist(w, w_ref):
    """Largest distance between the two eigenvalue sets, either way."""
    d = np.abs(w[:, None] - w_ref[None, :])
    return max(d.min(axis=1).max(), d.min(axis=0).max())


def _rand_c(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _cases(name):
    """The seeded input batches, (B, n, n) complex64, named after the JAX
    package's own test cases."""
    if name.startswith('random'):
        n, b = {'random16': (16, 3), 'random48': (48, 2)}[name]
        return _rand_c((b, n, n), n + b)
    if name == 'real_antisym64':
        # tests/test_eig_baed.py::test_real_and_antisymmetric_lanes: an
        # exactly real lane beside an antisymmetric one (purely imaginary
        # spectrum), whose windows sit at different rows in one batch
        rng = np.random.default_rng(3)
        A0 = rng.standard_normal((64, 64)).astype(np.float32)
        B = rng.standard_normal((64, 64)).astype(np.float32)
        return np.stack([A0, B - B.T]).astype(np.complex64)
    # tests/test_eig_packed.py::test_packed_real_spectrum_and_repeated: a
    # symmetric lane (real spectrum) and a lane with two clusters
    rng = np.random.default_rng(7)
    n = 32
    S = rng.standard_normal((n, n)).astype(np.float32)
    d = np.concatenate([np.full(n // 2, 2.0), np.full(n - n // 2, -1.0)])
    X = rng.standard_normal((n, n)).astype(np.float64)
    A1 = (X @ np.diag(d) @ np.linalg.inv(X)).astype(np.float32)
    return np.stack([(S + S.T) / 2, A1]).astype(np.complex64)


def _hess_jax(A):
    """Hessenberg form of a batch by the JAX package: the split-real pairs
    its kernels take, and the same numbers as torch complex64 (H, Q)."""
    with jax.default_matmul_precision('highest'):
        pairs = jax.vmap(jax.jit(eqr.hessenberg_real))(
            jnp.asarray(A.real, jnp.float32), jnp.asarray(A.imag, jnp.float32))
    H = torch.as_tensor(_np(pairs[0], pairs[1]).astype(np.complex64))
    Q = torch.as_tensor(_np(pairs[2], pairs[3]).astype(np.complex64))
    return pairs, H, Q


def _schur_checks(A, T, Z, res_tol=5e-5, orth_tol=5e-4):
    """The JAX tests' own bounds: T upper triangular, ||Z^H A Z - T|| <=
    5e-5 ||A||, ||Z^H Z - I|| <= 5e-4."""
    T = T.numpy().astype(np.complex128)
    Z = Z.numpy().astype(np.complex128)
    A = A.astype(np.complex128)
    assert np.abs(np.tril(T, -1)).max() == 0
    assert np.linalg.norm(Z.conj().T @ A @ Z - T) <= res_tol * np.linalg.norm(A)
    assert np.linalg.norm(Z.conj().T @ Z - np.eye(A.shape[-1])) <= orth_tol


def _against_jax(A, T, Z, T_ref, tol=1e-4):
    """Every lane: eigenvalue sets within ``tol`` of the spectral radius of
    each other and of numpy complex128, and the Schur checks."""
    for b in range(A.shape[0]):
        w = torch.diagonal(T[b]).numpy().astype(np.complex128)
        w_np = np.linalg.eigvals(A[b].astype(np.complex128))
        rho = np.abs(w_np).max()
        assert _set_dist(w, np.diagonal(T_ref[b])) <= tol * rho
        assert _set_dist(w, w_np) <= tol * rho
        _schur_checks(A[b], T[b], Z[b])


# ---------------------------------------------------------------------------
# the batched AED multishift QR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case,m,kw', [('random48', 4, 32),
                                       ('real_antisym64', 4, 32)])
def test_schur_qr_baed_plain_matches_the_pallas_kernel(case, m, kw):
    # the same float32 H, Q into both.  n = 48 and 64 with kw = 32: from the
    # second sweep on the active block is shorter than the window (the
    # endgame, where the JAX kernel's window runs past hi and the port's is
    # cut to the block).  Sweeps: the JAX count is the batch's loop count,
    # the port counts per lane, so the maxima are compared, within 2x
    A = _cases(case)
    n = A.shape[-1]
    pairs, H, Q = _hess_jax(A)
    with jax.default_matmul_precision('highest'):
        Tr, Ti, _, _, (hi_ref, sw_ref) = schur_qr_pallas_baed(
            *pairs, m=m, kw=kw, interpret=True, return_stats=True)
    T, Z, (hi, sweeps, rot, deflated, cmacs) = sb.schur_qr_baed(
        H, Q, m=m, kw=kw, return_stats=True)
    assert ek.LAUNCHES['schur_qr_baed'] == 0            # CPU: no launch
    assert bool((hi == 0).all()) and np.all(np.asarray(hi_ref) == 0)
    ref = int(np.max(np.asarray(sw_ref)))
    assert ref / 2 <= int(sweeps.max()) <= 2 * ref
    assert int(sweeps.max()) < n            # far fewer than a single-shift QR
    # AED, not the chase, retires most eigenvalues; its transforms are counted
    assert bool((deflated > n // 2).all()) and bool((deflated < n).all())
    assert bool((cmacs > 0).all()) and bool((rot > 0).all())
    _against_jax(A, T, Z, _np(Tr, Ti))


def test_schur_qr_baed_out_of_budget_gives_nan():
    # tests/test_eig_baed.py::test_nonconvergence_nan_contract: a negative
    # budget means no sweep at all
    A = _rand_c((2, 48, 48), 1)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A))
    T, _, st = sb.schur_qr_baed(H, Q, m=4, kw=32, max_iter_factor=-100,
                                return_stats=True)
    assert bool((st[0] > 0).all()) and bool((st[1] == 0).all())
    assert bool(torch.isnan(torch.diagonal(T, dim1=-2, dim2=-1)).all())
    # a budget of sweeps given directly: both lanes stop after it
    T2, _, st2 = sb.schur_qr_baed(H, Q, m=4, kw=32, max_iters=2,
                                  return_stats=True)
    assert bool((st2[1] == 2).all()) and bool((st2[0] > 0).all())
    assert bool(torch.isnan(torch.diagonal(T2, dim1=-2, dim2=-1)).all())
    assert float(torch.tril(T2, -1).abs().max()) == 0


def test_schur_qr_baed_counts_sweeps_per_lane():
    # an already triangular lane beside a full one: the first ends with the
    # pass that finds its block closed, the second runs its own sweeps
    A = _rand_c((2, 48, 48), 5)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A))
    H[0] = torch.triu(H[0])
    T, Z, (hi, sweeps, rot, deflated, _) = sb.schur_qr_baed(
        H, Q, m=4, kw=32, return_stats=True)
    assert bool((hi == 0).all())
    assert int(sweeps[0]) == 1 and int(rot[0]) == 0 and int(deflated[0]) == 0
    assert int(sweeps[1]) > 5
    assert torch.equal(T[0], H[0]) and torch.equal(Z[0], Q[0])


@pytest.mark.parametrize('bad', ['small_n', 'm_above_kw', 'kw_above_64',
                                 'one_matrix', 'real', 'mixed_types'])
def test_schur_qr_baed_refuses_what_it_does_not_take(bad):
    H = torch.as_tensor(_rand_c((1, 48, 48), 0))
    Q = H.clone()
    kw = dict(m=4, kw=32)
    exc = ValueError
    if bad == 'small_n':                    # n < kw + 10, as the JAX entry
        kw = dict(m=8, kw=64)
        with pytest.raises(ValueError):
            schur_qr_pallas_baed(*([jnp.zeros((1, 32, 32))] * 4), kw=64)
    elif bad == 'm_above_kw':
        kw = dict(m=33, kw=32)
    elif bad == 'kw_above_64':
        H = Q = torch.as_tensor(_rand_c((1, 90, 90), 0))
        kw = dict(m=8, kw=72)
    elif bad == 'one_matrix':
        H, Q = H[0], Q[0]
    elif bad == 'real':
        H, Q, exc = H.real, Q.real, TypeError
    else:
        Q = Q.to(torch.complex128)
    for fn in (sb.schur_qr_baed, sb.schur_qr_baed_plain):
        with pytest.raises(exc):
            fn(H, Q, **kw)


@pytest.mark.parametrize('uncut', [False, True])
def test_aed_plain_keeps_a_hessenberg_similarity(uncut):
    # one AED pass on an active block shorter than the window: with the slab
    # products applied H stays a unitary similarity of its input in
    # Hessenberg form, the deflated rows hold eigenvalues, the window is cut
    # to the block, and the shifts are eigenvalues of the window
    n, m, kw, lo = 60, 4, 32, 40
    A = np.triu(_rand_c((n, n), 8), -1)
    A[lo, lo - 1] = 0
    H0 = torch.as_tensor(A)
    H, Z = H0.clone(), torch.eye(n, dtype=H0.dtype)
    s, kwe, hi_new, shifts, P = sm.aed_plain(H, lo, n - 1, m, kw, 1.0, False,
                                             uncut_scale=uncut)
    assert (s, kwe) == (lo + 1, n - 1 - lo) and P.shape == (kwe, kwe)
    assert hi_new <= n - 1 and shifts.shape == (m,)
    e = s + kwe
    if hi_new < n - 1:
        H[s:e, e:] = P @ H[s:e, e:]
        H[:s, s:e] = H[:s, s:e] @ P.mH
        Z[:, s:e] = Z[:, s:e] @ P.mH
        assert float(torch.tril(H, -2).abs().max()) == 0
        assert float((Z.mH @ Z - torch.eye(n)).abs().max()) <= 1e-5
        res = torch.linalg.matrix_norm(Z @ H @ Z.mH - H0)
        assert float(res) <= 1e-5 * float(torch.linalg.matrix_norm(H0))
        assert float(torch.diagonal(H, -1)[hi_new:].abs().max()) == 0
    w_win = np.linalg.eigvals(A[s:, s:].astype(np.complex128))
    rho = np.abs(w_win).max()
    d = np.abs(shifts.numpy()[:, None] - w_win[None, :]).min(axis=1)
    assert d.max() <= 1e-4 * rho


# ---------------------------------------------------------------------------
# the packed-layout single-shift QR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['random16', 'random48', 'real_clustered32'])
def test_schur_qr_packed_plain_matches_the_pallas_kernel(case):
    # the same float32 H, Q into both; both count sweeps alike (four windows,
    # multiplier 1, stall gate 30).  Sweeps within 2x either way, not closer:
    # a run that passes a subdiagonal of a few eps (|d| + |d'|) loses its
    # shift to round-off and its bottom stops converging until that
    # subdiagonal falls under the threshold, and multiplier 1 waits longer
    # for that than schur_qr's 4.  Where it happens depends on the order of
    # summation: the JAX kernel takes 43 / 129 / 139 sweeps on these three
    # batches, the plain version 73 / 195 / 170 (one lane each), with the
    # same eigenvalues.  The clustered lane's eigenvalues are defective to
    # float32 (two 16-fold clusters), so that case is held to the JAX test's
    # own 5e-4
    A = _cases(case)
    pairs, H, Q = _hess_jax(A)
    with jax.default_matmul_precision('highest'):
        Tr, Ti, _, _, (hi_ref, sw_ref) = schur_qr_pallas_packed(
            *pairs, interpret=True, return_stats=True)
    T, Z, (hi, sweeps, rot) = sp.schur_qr_packed(H, Q, return_stats=True)
    assert ek.LAUNCHES['schur_qr_packed'] == 0          # CPU: no launch
    assert bool((hi == 0).all()) and np.all(np.asarray(hi_ref) == 0)
    ref = int(np.max(np.asarray(sw_ref)))
    assert ref / 2 <= int(sweeps.max()) <= 2 * ref
    assert bool((rot >= sweeps).all())
    tol = 5e-4 if case == 'real_clustered32' else 1e-4
    T_ref = _np(Tr, Ti)
    for b in range(A.shape[0]):
        w = torch.diagonal(T[b]).numpy().astype(np.complex128)
        w_np = np.linalg.eigvals(A[b].astype(np.complex128))
        rho = np.abs(w_np).max()
        assert _set_dist(w, np.diagonal(T_ref[b])) <= tol * rho
        assert _set_dist(w, w_np) <= tol * rho
        _schur_checks(A[b], T[b], Z[b])


def test_schur_qr_packed_rules_differ_from_schur_qr_in_the_multiplier_only():
    # the same sweeps function, windows and stall gate; with the multiplier
    # set back to schur_qr's the two are one function
    assert sp.PACKED_RULES == dict(nruns=ek.NRUNS, defl_mult=1.,
                                   cplx_stall=ek.CPLX_STALL)
    A = _rand_c((2, 24, 24), 6)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A))
    T, Z, (hi, sw_p, _) = sp.schur_qr_packed(H, Q, return_stats=True)
    assert bool((hi == 0).all()) and int(sw_p.max()) < 40 * 24
    rules = dict(sp.PACKED_RULES, defl_mult=ek.DEFL_MULT)
    Tq, Zq, hq, sw_q = ek.schur_qr_plain(H, Q)
    T4, Z4, h4, sw_4, _ = ek._single_shift_sweeps(H, Q, 40 * 24, **rules)
    assert torch.equal(T4, Tq) and torch.equal(Z4, Zq)
    assert torch.equal(sw_4, sw_q)


def test_schur_qr_packed_out_of_budget_gives_nan():
    A = _rand_c((2, 16, 16), 2)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A))
    T, _, (hi, sweeps, _) = sp.schur_qr_packed(H, Q, max_iter_factor=1,
                                               return_stats=True)
    assert bool((hi > 0).all()) and bool((sweeps == 16).all())
    assert bool(torch.isnan(torch.diagonal(T, dim1=-2, dim2=-1)).all())
    _, _, (_, sweeps5, _) = sp.schur_qr_packed(H, Q, max_iters=5,
                                               return_stats=True)
    assert bool((sweeps5 == 5).all())


@pytest.mark.parametrize('bad', ['one_matrix', 'real', 'mixed_types',
                                 'shapes'])
def test_schur_qr_packed_refuses_what_it_does_not_take(bad):
    H = torch.as_tensor(_rand_c((1, 12, 12), 0))
    Q = H.clone()
    exc = ValueError
    if bad == 'one_matrix':
        H, Q = H[0], Q[0]
    elif bad == 'real':
        H, Q, exc = H.real, Q.real, TypeError
    elif bad == 'mixed_types':
        Q = Q.to(torch.complex128)
    else:
        Q = Q[:, :8, :8]
    for fn in (sp.schur_qr_packed, sp.schur_qr_packed_plain):
        with pytest.raises(exc):
            fn(H, Q)


@pytest.mark.parametrize('n', [5, 32, 50])
def test_planar_packing_round_trip_and_layout(n):
    # rows [re(0..n) 0.. | im(0..n) 0..] of 2 npad floats, npad = n rounded up
    # to a 128-byte line, the padding zero; Z goes in transposed
    X = torch.as_tensor(_rand_c((2, n, n), n))
    Xp = sp.pack_planar(X)
    npad = sp.padded(n)
    assert npad % 32 == 0 and n <= npad < n + 32
    assert Xp.shape == (2, n, 2 * npad) and Xp.dtype == torch.float32
    assert Xp.is_contiguous()
    assert torch.equal(Xp[..., :n], X.real)
    assert torch.equal(Xp[..., npad:npad + n], X.imag)
    assert float(Xp[..., n:npad].abs().sum()) == 0
    assert float(Xp[..., npad + n:].abs().sum()) == 0
    assert torch.equal(sp.unpack_planar(Xp, n), X)
    Zt = sp.unpack_planar(sp.pack_planar(X.mT), n)
    assert torch.equal(Zt.mT, X)


# ---------------------------------------------------------------------------
# float64, the composed eig and the slice through each stage
# ---------------------------------------------------------------------------

def _stage(name):
    if name == 'schur_qr_baed':
        # n = 50 at order (2, 2): the default kw = 64 needs n >= 74
        return functools.partial(sb.schur_qr_baed, m=4, kw=32)
    return sp.schur_qr_packed


STAGES = ['schur_qr_baed', 'schur_qr_packed']


@pytest.mark.parametrize('name', STAGES)
def test_plain_versions_run_in_float64(name):
    n = 44
    A = _rand_c((2, n, n), 9, dtype=np.complex128)
    H, Q = ek.hessenberg_plain(torch.as_tensor(A))
    T, Z, st = _stage(name)(H, Q, return_stats=True)
    assert T.dtype == torch.complex128 and bool((st[0] == 0).all())
    for b in range(2):
        w_np = np.linalg.eigvals(A[b])
        w = torch.diagonal(T[b]).numpy()
        assert _set_dist(w, w_np) <= 1e-10 * np.abs(w_np).max()
        _schur_checks(A[b], T[b], Z[b], 1e-10, 1e-10)


@pytest.mark.parametrize('name', STAGES)
def test_composed_eig_through_each_stage(name):
    # Hessenberg -> the stage -> vectors -> V = Z Y -> unit columns ->
    # refinement at n = 50: A V = V diag(w) to 5e-4 max|w| (the bound of
    # tests/test_eig_baed.py::test_full_eig_with_vectors)
    A = torch.as_tensor(_rand_c((2, 50, 50), 4))
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


ORDER, CELL, GRID, THICK = (2, 2), (300., 300.), 32, 600.
EPS_HI, EPS_SUB, LAM = 2.0709 ** 2, 1.46 ** 2, 450.
INC = float(np.deg2rad(10.))


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """|t_xx|^2 and its raster gradient by the JAX package in float64, for
    the slice of tests/test_torch_slice.py (order (2, 2), grid 32, 2N = 50)
    at 10 degrees: (eps, spec, T, gradient)."""
    g = tt.geometry(Lx=CELL[0], Ly=CELL[1], nx=GRID, ny=GRID,
                    edge_sharpness=500., dtype=np.float64)
    occ = np.asarray(g.rectangle(160., 160., CELL[0] / 2, CELL[1] / 2))
    eps = occ * EPS_HI + (1. - occ)
    spec = jf.StackSpec(order=ORDER, L=CELL, n_layers=1, has_input=True)
    one = (jnp.asarray(1.), jnp.asarray(0.))
    sub = (jnp.asarray(EPS_SUB), jnp.asarray(0.))

    def loss_jax(er):
        S, intr = jf.solve_stack_pair(
            spec, jnp.asarray(1 / LAM), jnp.asarray(INC), jnp.asarray(0.),
            (er[None], jnp.zeros_like(er)[None]), jnp.asarray([THICK]),
            eps_in=sub)
        tr, ti = jf.sparam_xy_pair(S, intr['kx'], intr['ky'], sub, one,
                                   ORDER, [0, 0], [0, 0], 'xx')
        return (tr ** 2 + ti ** 2)[0]

    T_ref, g_ref = jax.value_and_grad(loss_jax)(jnp.asarray(eps))
    return eps, spec, float(T_ref), np.asarray(g_ref)


@pytest.mark.parametrize('name', STAGES)
def test_simulate_txx_through_each_stage_matches_jax(monkeypatch, name):
    # float32 with the small route's Schur stage swapped, against the JAX
    # package in float64: |t_xx|^2 to 1e-4, raster-gradient cosine >= 0.99
    calls = []
    stage = _stage(name)
    monkeypatch.setattr(eq, 'SMALL_SCHUR',
                        lambda H, Q: (calls.append(1), stage(H, Q))[1])
    eps, spec, T_ref, g_ref = _jax_reference()
    e32 = eps.astype(np.float32)
    cv = convert.from_jax_pairs(eps_grids=(e32[None], np.zeros_like(e32)[None]),
                                spec=spec, device='cpu')
    er = cv['eps_grids'].real[0].clone().requires_grad_(True)
    T = tp.simulate_txx(cv['spec'], torch.as_tensor([1 / LAM],
                                                    dtype=torch.float32),
                        er, THICK, EPS_SUB, inc_ang=INC)
    T.sum().backward()
    got = er.grad.double().numpy()
    assert calls == [1]
    assert abs(float(T.detach()) - T_ref) <= 1e-4
    assert np.isfinite(got).all()
    cos = (got * g_ref).sum() / (np.linalg.norm(got) * np.linalg.norm(g_ref))
    assert cos >= 0.99


def test_eig_qr_routing_is_unchanged():
    assert eq.LARGE_MIN_N == 512 and eq.SMALL_SCHUR is ek.schur_qr
    assert set(ek.LAUNCHES) >= {'schur_qr_baed', 'schur_qr_packed'}


@pytest.mark.parametrize('kw', [64, 32])
def test_schur_qr_baed_cluster_choice(kw):
    # the mirror of csrc/schur_qr_baed.cu's choice: a cluster of 8 while a
    # CTA's columns of H and the AED arrays fit its shared memory, then 16,
    # then the one-block kernel (0); n alone decides at a given kw, and the
    # last n of each size fills the room that the next n overflows
    room = sb.SMEM_PER_BLOCK - sb.STATIC_RESERVE
    ps = [sb.schur_qr_baed_cluster(n, kw) for n in range(kw + 10, 800)]
    assert ps[0] == 8 and ps[-1] == 0
    assert ps == sorted(ps, key=lambda p: {8: 0, 16: 1, 0: 2}[p])
    for p in (8, 16):
        last = kw + 10 + max(i for i, q in enumerate(ps) if q == p)
        assert sb.cluster_smem_bytes(last, p, kw) <= room
        assert sb.cluster_smem_bytes(last + 1, p, kw) > room
    if kw == 64:
        # the reach the kernel's source states, and phase 14's sizes
        assert [sb.schur_qr_baed_cluster(n) for n in
                (338, 392, 393, 450, 553, 554, 578)] == [8, 8, 16, 16, 16, 0,
                                                         0]
        # the AED arrays of csrc/aed_warp.cuh: 68,632 bytes at kw = 64
        assert sb.cluster_smem_bytes(1, 8, 64) - 16 == 68632 + 8
