"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The host with
the card has no JAX, which ``tests/conftest.py`` imports, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Inputs are random complex64 matrices made with numpy from a seed, small
enough (n = 40) for the plain versions to be quick on the card.
"""

import os
import sys

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


def _rand(dev, seed=0, n=N, lanes=B):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((lanes, n, n)) \
        + 1j * rng.standard_normal((lanes, n, n))
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


# float32 forward error of the reduction on random matrices grows with n:
# at n = 338 and 450 the plain float32 version sits 2.6e-4 to 8.3e-4
# ||A||_2 from the float64 one, per lane (CPU runs of hessenberg_plain),
# above the 1e-4 ||A||_2 that n = 40 is held to.  There the kernel is held,
# element by element, to HESS_ROOM times the plain float32 version's own
# distance from the float64 reduction of the same matrices (the cluster's
# rank-ordered sums of u, modelled by hessenberg_plain(A, cluster=16), sat
# 2.9x the plain version's distance on one lane at n = 450 in a CPU run)
HESS_ROOM = 8


@pytest.mark.parametrize('n,path', [
    (338, 'cluster 8'),
    (450, 'cluster 8'),
    (578, 'cluster 16'),
    (ek.CLUSTER_MAX_N + 1, 'one block')])
def test_hessenberg_kernel_paths_match_plain(dev, n, path):
    B8 = 8 if n <= 450 else 2
    rng = np.random.default_rng(n)
    a = rng.standard_normal((B8, n, n)) + 1j * rng.standard_normal((B8, n, n))
    A = torch.as_tensor(a.astype(np.complex64), device=dev)
    p = ek.hessenberg_cluster(n)
    assert path == (f'cluster {p}' if p else 'one block')
    info = ek.hessenberg_cluster_info(n)
    if p:
        assert info['cluster'] == p and info['active_clusters'] >= 1
        assert info['smem_bytes'] == ek.cluster_smem_bytes(n, p)
    else:
        assert info is None
    H, Q = _launch('hessenberg', ek.hessenberg, A)
    Hp, Qp = ek.hessenberg_plain(A)
    H64, Q64 = ek.hessenberg_plain(A.to(torch.complex128))
    a2 = torch.linalg.matrix_norm(A.to(torch.complex128), ord=2)

    def dist(X, Y):
        return (X.to(torch.complex128) - Y).abs().amax((-2, -1))

    assert float((dist(H, H64) / a2).max()) \
        <= HESS_ROOM * float((dist(Hp, H64) / a2).max())
    assert float(dist(Q, Q64).max()) <= HESS_ROOM * float(dist(Qp, Q64).max())
    assert bool((torch.tril(H, -2) == 0).all())
    res = torch.linalg.matrix_norm(Q @ H @ Q.mH - A) / torch.linalg.matrix_norm(A)
    assert float(res.max()) <= 1e-5
    eye = torch.eye(n, dtype=A.dtype, device=dev)
    assert float((Q.mH @ Q - eye).abs().max()) <= 1e-5


def test_schur_qr_kernel_matches_plain(dev):
    # eigenvalue sets within 1e-4 of the spectral radius (the kernel and
    # the plain version chase round-off in another order), Schur residual
    # 1e-5, sweep counts within 30%
    A = _rand(dev, 1)
    H, Q = ek.hessenberg_plain(A)
    T, Z, (hi, sw, _) = _launch('schur_qr', ek.schur_qr, H, Q,
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
    T, _, (hi, _, _) = _launch('schur_qr', ek.schur_qr, H, Q,
                               max_iter_factor=1, return_stats=True)
    assert bool((hi > 0).all())
    assert bool(torch.isnan(torch.diagonal(T, dim1=-2, dim2=-1)).all())


def _window_case(dev, case):
    """n below the chase window's 32 rows; n = 33 (two windows); three
    lanes, one of them upper triangular, converged before its first
    sweep."""
    if case == 'n < w':
        return _rand(dev, 7, 20)
    if case == 'n = w + 1':
        return _rand(dev, 8, ek.WINDOW + 1)
    rng = np.random.default_rng(9)
    a = rng.standard_normal((3, N, N)) + 1j * rng.standard_normal((3, N, N))
    a[2] = np.triu(a[2])
    return torch.as_tensor(a.astype(np.complex64), device=dev)


@pytest.mark.parametrize('entry', ['schur_qr', 'schur_qr_v2'])
@pytest.mark.parametrize('case', ['n < w', 'n = w + 1', 'a lane converged'])
def test_schur_qr_windows_match_the_schedule_model(dev, case, entry):
    # two sweeps, where nothing deflates on a random matrix yet: the kernel
    # against the plain model of its schedule element by element (T's strict
    # upper part, whose diagonal is NaN-poisoned through schur_qr, within
    # 1e-4 ||A||_2; Z within 1e-4: float32, the Givens rotations formed under
    # other contractions), the stats equal; then the whole Schur form
    A = _window_case(dev, case)
    H, Q = ek.hessenberg_plain(A)
    fn = getattr(ek, entry)
    rules = ek.ACC_RULES if entry == 'schur_qr' else ek.V2_RULES
    T, Z, st = _launch(entry, fn, H, Q, max_iters=2, return_stats=True)
    Tp, Zp, *stp = ek._single_shift_sweeps(H, Q, 2, **rules,
                                           window=ek.WINDOW)
    for a, b in zip(st, stp):
        assert a.tolist() == b.tolist()
    a2 = float(torch.linalg.matrix_norm(A, ord=2).min())
    assert float((torch.triu(T, 1) - torch.triu(Tp, 1)).abs().max()) \
        <= 1e-4 * a2
    assert float((Z - Zp).abs().max()) <= 1e-4
    if case == 'a lane converged':
        assert st[1][2] == 1 and st[2][2] == 0
        assert torch.equal(T[2], torch.triu(H[2])) and torch.equal(Z[2], Q[2])
    T, Z, (hi, sw, rot) = _launch(entry, fn, H, Q, return_stats=True)
    assert bool((hi == 0).all())
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    for b in range(A.shape[0]):
        assert _sets_agree(torch.diagonal(T[b]).to(torch.complex128),
                           w_ref[b])
    res = torch.linalg.matrix_norm(Z @ T @ Z.mH - A) / torch.linalg.matrix_norm(A)
    assert float(res.max()) <= 1e-5


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


# ---------------------------------------------------------------------------
# the large-n route: csrc/schur_ms.cu and csrc/tri_vectors_blocked.cu
# ---------------------------------------------------------------------------

from torcwa_tpu_torch.ops import schur_ms as sm  # noqa: E402
from torcwa_tpu_torch.ops import vec_blocked as vb  # noqa: E402
from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked  # noqa: E402
from torcwa_tpu_torch.utils import timing  # noqa: E402

# (n, m, kw, wb): one window at n = 96, overlapping windows at 300
LARGE = [(96, 8, 24, 128), (300, 8, 24, 128)]


def _rand1(dev, n, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return torch.as_tensor((scale * a).astype(np.complex64), device=dev)


@pytest.mark.parametrize('side', ['left', 'right'])
def test_ms_slab_products_match_matmul(dev, side):
    # one slab kind a launch of ms_apply_window, the other ranges empty: the
    # rows of a window at the top of H times an AED-sized transform, the
    # route's chase window and the widest window the kernel takes (left),
    # or the columns of a window at the bottom of H, the rows above it and
    # all of Z (right); ragged edges; the FFMA tiles sum in another order
    # than cuBLAS, 1e-5 relative
    X, n = _rand1(dev, 700, 10), 700
    for w in (61, 128, 256):
        P, a = _rand1(dev, w, 11), 0 if side == 'left' else n - w
        Z = _rand1(dev, n, 12)[:611 if side == 'right' else 0]
        ref_X, ref_Z = X.clone(), Z.clone()
        if side == 'left':
            ref_X[:w, w:] = P @ X[:w, w:]
        else:
            ref_X[:a, a:] = X[:a, a:] @ P.mH
            ref_Z[:, a:] = Z[:, a:] @ P.mH
        got_X, got_Z = X.clone(), Z.clone()
        before = ek.LAUNCHES['schur_ms']
        sm.ms_apply_window(got_X, got_Z, a, w, P)
        torch.cuda.synchronize()
        assert ek.LAUNCHES['schur_ms'] == before + 1
        for got, ref in ((got_X, ref_X), (got_Z, ref_Z))[:1 + (a > 0)]:
            assert float((got - ref).abs().max()) \
                <= 1e-5 * float(ref.abs().max())


def test_ms_apply_window_matches_matmul(dev):
    # one launch for the three products of an applied transform: an AED
    # transform (61), the route's chase window (128), the widest window
    # (256), a window at the top (nothing above it) and one at the bottom
    # (nothing right of it), n = 700 with ragged strips; 1e-5 relative
    H, Z = _rand1(dev, 700, 12), _rand1(dev, 700, 13)
    for w, a in ((61, 301), (128, 192), (256, 128), (128, 0), (64, 636)):
        P, e = _rand1(dev, w, 14), a + w
        ref_H, ref_Z = H.clone(), Z.clone()
        ref_H[a:e, e:] = P @ H[a:e, e:]
        ref_H[:a, a:e] = H[:a, a:e] @ P.mH
        ref_Z[:, a:e] = Z[:, a:e] @ P.mH
        got_H, got_Z = H.clone(), Z.clone()
        before = ek.LAUNCHES['schur_ms']
        sm.ms_apply_window(got_H, got_Z, a, w, P)
        torch.cuda.synchronize()
        assert ek.LAUNCHES['schur_ms'] == before + 1
        for got, ref in ((got_H, ref_H), (got_Z, ref_Z)):
            assert float((got - ref).abs().max()) \
                <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize('n,m,kw,wb', LARGE)
def test_schur_ms_kernels_match_plain(dev, n, m, kw, wb):
    # eigenvalue sets within 1e-4 of the spectral radius, Schur residual and
    # unitarity at float32 level (1e-5), the same sweep logic on both sides:
    # sweep counts within a factor of 2
    A = _rand1(dev, n, n)
    H, Q = hessenberg_blocked(A, panel=32)
    before = ek.LAUNCHES['schur_ms']
    T, Z, st = sm.schur_ms(H, Q, m=m, kw=kw, wb=wb, return_stats=True)
    torch.cuda.synchronize()
    assert ek.LAUNCHES['schur_ms'] > before
    Tp, Zp, stp = sm.schur_ms_plain(H, Q, m=m, kw=kw, wb=wb,
                                    return_stats=True)
    assert st[0] == 0 and stp[0] == 0
    w, wp = torch.diagonal(T), torch.diagonal(Tp)
    dist = (w[:, None] - wp[None, :]).abs().amin(-1).amax()
    assert float(dist) <= 1e-4 * float(wp.abs().max())
    assert bool((torch.tril(T, -1) == 0).all())
    fro = torch.linalg.matrix_norm(A)
    assert float(torch.linalg.matrix_norm(Z @ T @ Z.mH - A) / fro) <= 1e-5
    eye = torch.eye(n, dtype=A.dtype, device=dev)
    assert float((Z.mH @ Z - eye).abs().max()) <= 1e-5
    assert st[2] > n // 2 and stp[2] > n // 2          # AED carries it
    assert 0.5 * stp[1] <= st[1] <= 2 * stp[1]


@pytest.mark.parametrize('n,m,kw,wb', LARGE)
def test_schur_ms_lanes_in_lock_step_match_each_lane_alone(dev, n, m, kw, wb):
    # a batch of three through one lock-step loop: every lane's T, Z, stats
    # and AED rotations those of the lane alone, bit for bit; a nearly
    # triangular lane beside two random ones, so that lanes leave the loop
    # many sweeps apart; the loop's sweeps are the slowest lane's
    lanes = [hessenberg_blocked(_rand1(dev, n, 60 + l), panel=32)
             for l in range(2)]
    tri = torch.triu(_rand1(dev, n, 62)) + torch.diag(
        1e-3 * _rand1(dev, n, 63).diagonal(-1).real.to(torch.complex64), -1)
    lanes.insert(1, (tri, torch.eye(n, dtype=tri.dtype, device=dev)))
    H = torch.stack([h for h, _ in lanes])
    Q = torch.stack([q for _, q in lanes])
    cfg = dict(m=m, kw=kw, wb=wb)
    with timing.tracing() as tr:
        T, Z, st = sm.schur_ms(H, Q, return_stats=True, **cfg)
        alone = [sm.schur_ms(H[l], Q[l], return_stats=True, **cfg)
                 for l in range(3)]
        torch.cuda.synchronize()
        spans = tr.collect()
    for l, (Tl, Zl, stl) in enumerate(alone):
        assert torch.equal(torch.view_as_real(T[l]), torch.view_as_real(Tl))
        assert torch.equal(torch.view_as_real(Z[l]), torch.view_as_real(Zl))
        assert tuple(st[l]) == tuple(stl) and stl[0] == 0
    batch, *lone = [s.counters for s in spans if s.name == 'eig.schur']
    assert int(batch['aed_rotations']) == sum(int(c['aed_rotations'])
                                              for c in lone)
    assert batch['lockstep_sweeps'] == max(s[1] for s in st)
    assert batch['sweeps'] == sum(s[1] for s in st)
    assert max(s[1] for s in st) >= 2 * st[1][1]


def test_schur_ms_launch_count_is_the_profilers(dev, monkeypatch):
    # a batch of two whose lanes' chase windows take other register tiles
    # in one call (n = 280: a last window of 88 rows; lane 1 split at row
    # 100, so its windows start 64 rows lower): LAUNCHES['schur_ms'] counts
    # each kernel the profiler sees, more than the calls into C
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n, cfg = 280, dict(m=8, kw=24, wb=128)
    lanes = [hessenberg_blocked(_rand1(dev, n, 70 + l), panel=32)
             for l in range(2)]
    lanes[1][0][100, 99] = 0
    H = torch.stack([h for h, _ in lanes])
    Q = torch.stack([q for _, q in lanes])
    sm.schur_ms(H, Q, **cfg)                    # built, shared memory set
    calls, launch = [], sm._launch
    monkeypatch.setattr(sm, '_launch', lambda *a: (calls.append(a[0]),
                                                   launch(*a))[1])
    torch.cuda.synchronize()
    before = ek.LAUNCHES['schur_ms']
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sm.schur_ms(H, Q, **cfg)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and '::ms_' in e.key)
    assert ek.LAUNCHES['schur_ms'] - before == kernels > len(calls)


# (kw, rows of the window): uncut at kw = 64 and 24, and cut by lo to 39
# and 20 rows, so that a lane's second slot runs (kwe > 32) and does not
AED_PASSES = [(64, 64), (64, 39), (64, 20), (24, 24)]


def _aed_pass(dev, kw, rows, exc, small_spike):
    """One AED pass of the route (the band scan, then ms_aed) on H after
    three sweeps of the kernels, and aed_plain on the same H: what the test
    holds, with the distances.  small_spike: the window's H[s, s-1], the
    spike's scale, set to 1e-6 max|H| (still alive for the band scan), so
    that the bottom of the window deflates and ms_aed writes its block."""
    n, m, mult = 140, 8, 4.0
    H, Z = hessenberg_blocked(_rand1(dev, n, 21 + kw), panel=32)
    sm.run_sweeps(H, Z, 3, m=m, kw=kw, wb=128, defl_mult=mult)
    lo, hi = sm.band_scan_plain(H, n - 1, mult)
    if rows < kw:
        lo = hi - rows
        H[lo, lo - 1] = 0
    if small_spike:
        s = max(hi - kw + 1, lo + 1)
        H[s, s - 1] *= 1e-6 * H.abs().max() / H[s, s - 1].abs()
    ops = sm._CudaOps(H.clone()[None], Z.clone()[None], m, kw, 128, mult)
    got = tuple(ops.scan([0], [n - 1], [exc], True)[0])
    torch.cuda.synchronize()
    s, kwe, hi_new, shifts, _ = sm.aed_plain(H.cpu(), lo, hi, m, kw, mult,
                                             exc)
    e = s + kwe
    _, _, hi_m, its, rot = sm._mini_schur(H[s:e, s:e].cpu(), 3 * kw + 40)
    Lp = ops.Lp[0, :kwe * kwe].view(kwe, kwe)
    # the block ms_aed writes where it deflates: [beta e1 | W] taken
    # through Lp (the deflated lanes' spike entries and the known zeros
    # set to 0 there); elsewhere H as it was
    want = H.clone()
    if hi_new < hi:
        want[s:e, s - 1] = H[s, s - 1] * Lp[:, 0]
        want[s:e, s:e] = Lp @ H[s:e, s:e] @ Lp.mH
    scale = float(H.abs().max())
    eye = torch.eye(kwe, dtype=Lp.dtype, device=dev)
    return dict(
        got=got, want=(lo, hi, s, kwe, hi_new), rows=rows,
        qr=ops.info[0, 6:8].tolist() + [int(ops.aed_rotations)],
        qr_plain=[hi_m, its, rot], deflated=hi - hi_new,
        shifts=float((ops.shifts.cpu() - shifts).abs().max()) / scale,
        unitarity=float((Lp.mH @ Lp - eye).abs().max()),
        block=float((ops.H[0] - want).abs().max()) / scale)


@pytest.mark.parametrize('small_spike', [False, True])
@pytest.mark.parametrize('exc', [False, True])
@pytest.mark.parametrize('kw,rows', AED_PASSES)
def test_ms_aed_pass_matches_aed_plain(dev, kw, rows, exc, small_spike):
    # the window, its new bottom, its QR's final bottom, iterations and
    # rotations (the eig.schur counter aed_rotations) exactly as the plain
    # version's; the shifts in order at float32 level (1e-4 of max|H|).
    # The window's Schur vectors, and so Lp and the block written back, are
    # the plain version's to float32 level only where the window's
    # eigenvalues lie well apart (2.96e-2 apart in Lp at kw = 64 here,
    # where the whole route's stats are those of the one-warp AED bit for
    # bit); what holds on every input: Lp is unitary, the block ms_aed
    # wrote is the window taken through Lp, and nothing else of H moved.
    # With a small spike the window deflates, so the block is written
    r = _aed_pass(dev, kw, rows, exc, small_spike)
    assert r['deflated'] > 0 or not small_spike
    assert r['got'] == r['want'] and r['want'][3] == rows
    assert r['qr'] == r['qr_plain'] and r['qr'][2] > 0
    assert r['shifts'] <= 1e-4
    assert r['unitarity'] <= 1e-5
    assert r['block'] <= 1e-4


def test_schur_ms_kernels_poison_on_a_starved_budget(dev):
    A = _rand1(dev, 96, 3)
    H, Q = hessenberg_blocked(A, panel=32)
    T, _, st = sm.schur_ms(H, Q, m=8, kw=24, budget=1, return_stats=True)
    assert st[0] > 0 and st[1] == 1
    assert bool(torch.isnan(torch.diagonal(T)).all())


@pytest.mark.parametrize('m,wb', [(24, 128), (32, 192)])
def test_ms_chase_forms_the_window_unitary_after_the_chase(dev, m, wb):
    # the route's window at order 20 (m = 24, 128 rows, staged in shared
    # memory) and at order 25 (m = 32, 192 rows, worked in device memory),
    # one sweep at n = 640 through chip_smoke.py's check: the kernel against
    # the plain float32 chase within a multiple of the plain float32
    # chase's own distance from float64, from one state over the first
    # steps of every window and the last steps of the sweep, and over the
    # sweep; U W U^H = W' and U unitary in every window; H Hessenberg after
    # the sweep
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import chase_sweep_check
    H, _ = hessenberg_blocked(_rand1(dev, 640, 40 + m))
    before = ek.LAUNCHES['schur_ms']
    rows, ok = chase_sweep_check(torch, sm, H, m, wb)
    torch.cuda.synchronize()
    assert ek.LAUNCHES['schur_ms'] > before
    assert ok, [r for r in rows if r[1] > r[3]]


@pytest.mark.parametrize('n', [96, 300])
def test_tri_vectors_blocked_kernel_matches_plain(dev, n):
    # same T into the kernel, its plain version and the batched kernel of
    # the small route; distinct random eigenvalues, 1e-4 relative
    A = _rand1(dev, n, 20 + n)
    H, Q = hessenberg_blocked(A, panel=32)
    T, _ = sm.schur_ms(H, Q, m=8, kw=24)
    before = ek.LAUNCHES['tri_vectors_blocked']
    Y = vb.tri_vectors_blocked(T, block=64)
    torch.cuda.synchronize()
    assert ek.LAUNCHES['tri_vectors_blocked'] == before + -(-n // 64)
    dmin = vb.pivot_floor(T)
    Yp = torch.eye(n, dtype=T.dtype, device=dev)
    for r1 in range(n, 0, -64):
        r0 = max(r1 - 64, 0)
        vb.tri_vectors_block_plain(T, T[r0:r1, r1:] @ Yp[r1:], dmin, Yp,
                                   r0, r1)
    Y1 = ek.tri_vectors(T[None].contiguous())[0]
    scale = float(Yp.abs().max())
    assert float((Y - Yp).abs().max()) <= 1e-4 * scale
    assert float((Y - Y1).abs().max()) <= 1e-4 * scale


def test_tri_vectors_blocked_kernel_at_the_route_block(dev):
    # n = 640, block 128: more columns than one CTA's 32 warps, a CTA's
    # warps looping over columns, columns inside and right of each block;
    # against the plain version in both orders (the kernel's is
    # by_columns) and the batched kernel, 1e-4 relative on separated
    # columns
    from torcwa_tpu_torch.ops import eig_qr as eq
    n = 640
    H, Q = hessenberg_blocked(_rand1(dev, n, 640))
    T, _ = sm.schur_ms(H, Q, m=eq.large_shifts(n),
                       defl_mult=eq.LARGE_DEFL_MULT)
    before = ek.LAUNCHES['tri_vectors_blocked']
    Y = vb.tri_vectors_blocked(T)
    torch.cuda.synchronize()
    assert ek.LAUNCHES['tri_vectors_blocked'] == before + -(-n // vb.MAX_BLOCK)
    dmin = vb.pivot_floor(T)
    w = torch.diagonal(T)
    gap = (w[:, None] - w[None, :]).abs() + torch.eye(n, device=dev) * 1e30
    sep = gap.amin(-1) > 1e-3 * w.abs().max()
    assert int(sep.sum()) > n // 2
    Y1 = ek.tri_vectors(T[None].contiguous())[0]
    for by_columns in (False, True):
        Yp = torch.eye(n, dtype=T.dtype, device=dev)
        for r1 in range(n, 0, -vb.MAX_BLOCK):
            r0 = max(r1 - vb.MAX_BLOCK, 0)
            vb.tri_vectors_block_plain(T, T[r0:r1, r1:] @ Yp[r1:], dmin, Yp,
                                       r0, r1, by_columns=by_columns)
        scale = float(Yp.abs().max())
        assert float(((Y - Yp).abs().amax(0) * sep).max()) <= 1e-4 * scale
    assert float(((Y - Y1).abs().amax(0) * sep).max()) <= 1e-4 * scale
    assert bool((torch.diagonal(Y) == 1).all())
    assert float(torch.tril(Y, -1).abs().max()) == 0


# ---------------------------------------------------------------------------
# csrc/hess_panel.cu: a panel's column loop of hessenberg_blocked
# ---------------------------------------------------------------------------

def _c128(*xs):
    return [x.to(torch.complex128) for x in xs]


@pytest.mark.parametrize('n,panel', [(512, 128), (882, 128), (1922, 128),
                                     (3362, 128), (300, 32)])
def test_hess_panel_kernel_matches_the_plain_loop(dev, n, panel,
                                                  monkeypatch):
    # the kernel's reduction and the plain loop's on the card, on the same
    # random A: each element by element within HESS_ROOM times the plain
    # float32 loop's own distance from the float64 one (as hessenberg is
    # held), Q H Q^H = A and Q unitary at float32 level, the eigenvalues
    # after schur_ms against complex128 at phase 18's tolerances; one
    # launch and one counted panel per panel, the grid as the mirror picks
    import chip_smoke as cs
    from torcwa_tpu_torch.ops import eig_qr as eq, hess_blocked as hb
    from torcwa_tpu_torch.utils import timing
    A = _rand1(dev, n, 18000 + n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert hb.hess_panel_info(n, panel) == hb.hess_panel_plan(n, panel, sms)
    panels = len(range(0, n - 2, panel))
    before = ek.LAUNCHES['hess_panel']
    with timing.tracing() as tr:
        H, Q = hessenberg_blocked(A, panel=panel)
        torch.cuda.synchronize()
        tr.collect()
    assert ek.LAUNCHES['hess_panel'] == before + panels
    hess, = [s for s in tr.records if s.name == 'eig.hess']
    assert hess.counters == {'panels': panels}
    with monkeypatch.context() as m:
        m.setattr(hb, 'hess_panel', hb._columns)
        Hp, Qp = hessenberg_blocked(A, panel=panel)
        H64, Q64 = hessenberg_blocked(A.to(torch.complex128), panel=panel)
    assert ek.LAUNCHES['hess_panel'] == before + panels
    A64, = _c128(A)
    a2 = float(torch.linalg.matrix_norm(A64, ord=2))

    def dist(X, Y):
        return float((X.to(torch.complex128) - Y).abs().max())

    assert dist(H, H64) / a2 <= HESS_ROOM * dist(Hp, H64) / a2
    assert dist(Q, Q64) <= HESS_ROOM * dist(Qp, Q64)
    assert bool((torch.tril(H, -2) == 0).all())
    fro = float(torch.linalg.matrix_norm(A64))
    rec, rec_p = (float(torch.linalg.matrix_norm(Y @ X @ Y.mH - A64)) / fro
                  for X, Y in (_c128(H, Q), _c128(Hp, Qp)))
    eye = torch.eye(n, dtype=torch.complex128, device=dev)
    orth = float((_c128(Q)[0].mH @ _c128(Q)[0] - eye).abs().max())
    print(f'n={n} p={panel}: QHQ^H - A {rec:.2e} ||A||_F (plain loop '
          f'{rec_p:.2e}), Q^H Q - I {orth:.2e}')
    assert rec <= 1e-5 and rec <= 2 * rec_p and orth <= 1e-5
    T, Z, st = sm.schur_ms(H, Q, m=eq.large_shifts(n),
                           defl_mult=eq.LARGE_DEFL_MULT, return_stats=True)
    w_ref = torch.linalg.eigvals(A64)
    d = cs.set_dist(torch.diagonal(T).to(torch.complex128), w_ref)
    res, orth_z, tri = cs.schur_quality(torch, A, T, Z)
    assert st[0] == 0 and tri and d <= 1e-4 * float(w_ref.abs().max())
    assert res <= 1e-4 and orth_z <= 1e-4


def test_hess_panel_refuses_what_the_kernel_does_not_take(dev):
    from torcwa_tpu_torch.ops import hess_blocked as hb
    A = _rand1(dev, 64, 5)
    with pytest.raises(TypeError):
        hb.hess_panel(A.to(torch.complex128), 32, 32)
    with pytest.raises(ValueError):
        hb.hess_panel(A.t(), 32, 32)
    with pytest.raises(ValueError):
        hb.hess_panel(A, hb.MAX_PANEL + 1, 32)


def test_large_route_on_the_card_solves_the_eigenproblem(dev, monkeypatch):
    # eig_qr through hessenberg_blocked -> schur_ms -> tri_vectors_blocked
    from torcwa_tpu_torch.ops import eig_qr as eq
    monkeypatch.setattr(eq, 'LARGE_MIN_N', 64)
    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 200, 200)) + 1j * rng.standard_normal(
        (2, 200, 200))
    A = torch.as_tensor(a.astype(np.complex64), device=dev)
    ek.reset_launch_counts()
    w, V = eq.eig_qr(A)
    assert ek.LAUNCHES['hess_panel'] == 2 * len(range(0, 198, 128))
    assert ek.LAUNCHES['schur_ms'] > 0
    assert ek.LAUNCHES['tri_vectors_blocked'] > 0
    assert ek.LAUNCHES['schur_qr'] == 0
    res = (A @ V - V * w[..., None, :]).abs().amax((-2, -1))
    assert bool((res <= 1e-4 * torch.linalg.matrix_norm(A, ord=2)).all())
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    dist = (w.to(torch.complex128)[..., :, None]
            - w_ref[..., None, :]).abs().amin(-1).amax(-1)
    assert bool((dist <= 1e-4 * w_ref.abs().amax(-1)).all())


# ---------------------------------------------------------------------------
# the stand-alone Schur stages and schur_ms without AED
# ---------------------------------------------------------------------------

def _sets_agree(w, wp, tol=1e-4):
    d = (w[:, None] - wp[None, :]).abs()
    return float(max(d.amin(1).max(), d.amin(0).max())) \
        <= tol * float(wp.abs().max())


def test_schur_qr_v2_kernel_matches_plain_and_does_not_poison(dev):
    A = _rand(dev, 5)
    H, Q = ek.hessenberg_plain(A)
    T, Z, (hi, sw, rot) = _launch('schur_qr_v2', ek.schur_qr_v2, H, Q,
                                  return_stats=True)
    Tp, _, hip, swp, rotp = ek.schur_qr_v2_plain(H, Q)
    assert bool((hi == 0).all()) and bool((hip == 0).all())
    for b in range(B):
        assert _sets_agree(torch.diagonal(T[b]), torch.diagonal(Tp[b]))
    res = torch.linalg.matrix_norm(Z @ T @ Z.mH - A) / torch.linalg.matrix_norm(A)
    assert float(res.max()) <= 1e-5
    # at multiplier 1 a lane can hover above the deflation threshold until
    # an exceptional shift frees it (the plain version took 201 and 126
    # sweeps here, the kernel 106 and 107), so the counts are held to a
    # factor 2 of the plain version's range, not lane by lane
    assert int(swp.min()) / 2 <= int(sw.min())
    assert int(sw.max()) <= 2 * int(swp.max())
    T1, _, (hi1, _, _) = _launch('schur_qr_v2', ek.schur_qr_v2, H, Q,
                                 max_iter_factor=1, return_stats=True)
    assert bool((hi1 > 0).all())
    assert bool(torch.isfinite(torch.view_as_real(T1)).all())
    with pytest.raises(TypeError):
        ek.schur_qr_v2(H.to(torch.complex128), Q.to(torch.complex128))


@pytest.mark.parametrize('n,m', [(40, 4), (70, 16), (5, 8)])
def test_schur_qr_ms_kernel_matches_plain(dev, n, m):
    # n = 70 with m = 16: windows shorter than 2 m rows near the end, where
    # only some bulges are alive and the shift block is cut; n = 5 < m
    from torcwa_tpu_torch.ops import schur_qr_ms as sq
    A = _rand(dev, 6, n)[0]
    H, Q = ek.hessenberg_plain(A[None])
    T, Z, st = _launch('schur_qr_ms', sq.schur_qr_ms, H[0], Q[0], m=m,
                       return_stats=True)
    Tp, _, stp = sq.schur_qr_ms_plain(H[0], Q[0], m=m, return_stats=True)
    assert int(st[0]) == 0 and int(stp[0]) == 0
    assert _sets_agree(torch.diagonal(T), torch.diagonal(Tp))
    assert bool((torch.tril(T, -1) == 0).all())
    res = torch.linalg.matrix_norm(Z @ T @ Z.mH - A) / torch.linalg.matrix_norm(A)
    assert float(res) <= 1e-5
    assert int(stp[1]) / 2 <= int(st[1]) <= 2 * int(stp[1])
    # -1000 leaves no sweep in the budget (-1000 n) // m + 8 m + 40 even at
    # n = 5, m = 8
    T1, _, st1 = _launch('schur_qr_ms', sq.schur_qr_ms, H[0], Q[0], m=m,
                         max_iter_factor=-1000, return_stats=True)
    assert int(st1[0]) > 0 and bool(torch.isnan(torch.diagonal(T1)).all())
    with pytest.raises(TypeError):
        sq.schur_qr_ms(H[0].to(torch.complex128), Q[0].to(torch.complex128))


def test_schur_ms_without_aed_matches_plain(dev):
    from torcwa_tpu_torch.ops import schur_ms as sm
    A = _rand(dev, 7, 96)[0]
    H, Q = ek.hessenberg_plain(A[None])
    cfg = dict(m=8, wb=128, aed=False)
    before = ek.LAUNCHES['schur_ms']
    T, Z, st = sm.schur_ms(H[0], Q[0], return_stats=True, **cfg)
    torch.cuda.synchronize()
    assert ek.LAUNCHES['schur_ms'] > before
    Tp, _, stp = sm.schur_ms_plain(H[0], Q[0], return_stats=True, **cfg)
    assert st[0] == 0 and stp[0] == 0 and st[2] == 0 and st[3] == 0
    assert _sets_agree(torch.diagonal(T), torch.diagonal(Tp))
    res = torch.linalg.matrix_norm(Z @ T @ Z.mH - A) / torch.linalg.matrix_norm(A)
    assert float(res) <= 1e-5
    assert stp[1] / 2 <= st[1] <= 2 * stp[1]


def _batch_checks(A, T, Z):
    assert bool((torch.tril(T, -1) == 0).all())
    res = torch.linalg.matrix_norm(Z @ T @ Z.mH - A) / torch.linalg.matrix_norm(A)
    assert float(res.max()) <= 1e-5
    eye = torch.eye(A.shape[-1], device=A.device)
    assert float((Z.mH @ Z - eye).abs().max()) <= 1e-5


@pytest.mark.parametrize('n,m,kw,lanes,budget', [
    (48, 4, 32, B, None), (80, 8, 64, B, None), (74, 8, 64, B, None),
    (392, 8, 64, B, 1), (393, 8, 64, 1, 1), (450, 16, 64, 8, 1),
    (553, 8, 64, B, 1), (554, 8, 64, B, 1)])
def test_schur_qr_baed_kernel_matches_plain(dev, n, m, kw, lanes, budget):
    # n = 48 with kw = 32: the active block is shorter than the AED window
    # from the second sweep on; n = 80 with kw = 64: the default window;
    # n = 74 = kw + 10, the smallest n the wrapper takes.  One launch for the
    # batch, each matrix with its own sweep count.  With a budget: each side
    # of every switch of the C entry point at kw = 64 (clusters of 8 to
    # n = 392, of 16 to 553, the one-block kernel above), one lane at
    # n = 393, and eight at 450, more than the 7 clusters of 16 the card
    # runs at once, which take the one-block kernel; the kernel in full
    # against complex128 eigenvalues, and
    # against the plain version after `budget` sweeps on the first lane
    from torcwa_tpu_torch.ops import schur_qr_baed as sb
    if budget is not None:
        _baed_budgeted(dev, sb, n, m, kw, lanes, budget)
        return
    A = _rand(dev, 8, n)
    H, Q = ek.hessenberg_plain(A)
    T, Z, st = _launch('schur_qr_baed', sb.schur_qr_baed, H, Q, m=m, kw=kw,
                       return_stats=True)
    Tp, _, stp = sb.schur_qr_baed_plain(H, Q, m=m, kw=kw, return_stats=True)
    assert bool((st[0] == 0).all()) and bool((stp[0] == 0).all())
    for b in range(B):
        assert _sets_agree(torch.diagonal(T[b]), torch.diagonal(Tp[b]))
    _batch_checks(A, T, Z)
    assert int(stp[1].max()) / 2 <= int(st[1].max()) <= 2 * int(stp[1].max())
    assert bool((st[3] > n // 2).all())         # AED deflates most rows
    T1, _, st1 = _launch('schur_qr_baed', sb.schur_qr_baed, H, Q, m=m, kw=kw,
                         max_iter_factor=-100, return_stats=True)
    assert bool((st1[0] > 0).all()) and bool((st1[1] == 0).all())
    assert bool(torch.isnan(torch.diagonal(T1, dim1=-2, dim2=-1)).all())
    with pytest.raises(ValueError):
        sb.schur_qr_baed(H, Q, m=m, kw=64 if n < 74 else 72)
    with pytest.raises(TypeError):
        sb.schur_qr_baed(H.to(torch.complex128), Q.to(torch.complex128), m=m,
                         kw=kw)
    with pytest.raises(ValueError):
        sb.schur_qr_baed(H.mT, Q, m=m, kw=kw)           # not contiguous


def _baed_budgeted(dev, sb, n, m, kw, lanes, budget):
    A = _rand(dev, 8, n, lanes)
    H, Q = ek.hessenberg(A)
    info = sb.schur_qr_baed_cluster_info(n, m, kw)
    assert info['cluster'] == sb.schur_qr_baed_cluster(n, kw)
    assert info['cluster'] == 0 or info['clusters_at_once'] >= 1
    T, Z, st = _launch('schur_qr_baed', sb.schur_qr_baed, H, Q, m=m, kw=kw,
                       return_stats=True)
    assert bool((st[0] == 0).all()) and bool((st[3] > n // 2).all())
    _batch_checks(A, T, Z)
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    for b in range(lanes):
        assert _sets_agree(torch.diagonal(T[b]).to(torch.complex128),
                           w_ref[b])
    # after the budget the diagonal is NaN by contract: the strict upper
    # part of T, and Z; m = 8 bulges a sweep, as chip_smoke.py phase 14
    # holds one sweep element by element (float32 round-off grows with the
    # rotations a sweep applies)
    T1, Z1, st1 = sb.schur_qr_baed(H[:1], Q[:1], kw=kw, max_iters=budget,
                                   return_stats=True)
    T1p, Z1p, st1p = sb.schur_qr_baed_plain(H[:1], Q[:1], kw=kw,
                                            max_iters=budget,
                                            return_stats=True)
    a2 = float(torch.linalg.matrix_norm(A[0], ord=2))
    assert float((torch.triu(T1, 1) - torch.triu(T1p, 1)).abs().max()) \
        <= 1e-4 * a2
    assert float((Z1 - Z1p).abs().max()) <= 1e-4
    assert int(st1[1][0]) == budget == int(st1p[1][0])


@pytest.mark.parametrize('n', [40, 33, 65])
def test_schur_qr_packed_kernel_matches_plain(dev, n):
    # n = 40 and 33: the padding of a packed half is 24 and 31 floats wide;
    # n = 65: the 32-row chase window's edge, a window of one row left;
    # one sweep is forward-stable on a random batch, so kernel and plain agree
    # element-wise there (1e-4 ||A||_2), and in full as eigenvalue sets
    from torcwa_tpu_torch.ops import schur_qr_packed as sp
    A = _rand(dev, 9, n)
    H, Q = ek.hessenberg_plain(A)
    T, Z, st = _launch('schur_qr_packed', sp.schur_qr_packed, H, Q,
                       return_stats=True)
    Tp, _, stp = sp.schur_qr_packed_plain(H, Q, return_stats=True)
    assert bool((st[0] == 0).all()) and bool((stp[0] == 0).all())
    for b in range(B):
        assert _sets_agree(torch.diagonal(T[b]), torch.diagonal(Tp[b]))
    _batch_checks(A, T, Z)
    assert int(stp[1].max()) / 2 <= int(st[1].max()) <= 2 * int(stp[1].max())
    # (after one sweep the diagonal is NaN by contract: the strict upper part)
    H1, Z1 = sp.schur_qr_packed(H, Q, max_iters=1)
    H1p, Z1p = sp.schur_qr_packed_plain(H, Q, max_iters=1)
    a2 = float(torch.linalg.matrix_norm(A, ord=2).min())
    dH = torch.triu(H1, 1) - torch.triu(H1p, 1)
    assert float(dH.abs().max()) <= 1e-4 * a2
    assert float((Z1 - Z1p).abs().max()) <= 1e-4
    T1, _, st1 = _launch('schur_qr_packed', sp.schur_qr_packed, H, Q,
                         max_iter_factor=1, return_stats=True)
    assert bool((st1[0] > 0).all()) and bool((st1[1] == n).all())
    assert bool(torch.isnan(torch.diagonal(T1, dim1=-2, dim2=-1)).all())
    with pytest.raises(TypeError):
        sp.schur_qr_packed(H.to(torch.complex128), Q.to(torch.complex128))
    with pytest.raises(ValueError):
        sp.schur_qr_packed(H.mT, Q)                     # not contiguous


def test_eig_small_through_the_batched_stages_on_the_card(dev):
    # the composed eig, Hessenberg -> stage -> vectors -> refinement, through
    # each of the two stages at n = 80: one launch of the stage, none of
    # schur_qr; A V = V diag(w) to 1e-4 max|A|
    from functools import partial
    from torcwa_tpu_torch.ops import eig_qr as eq
    from torcwa_tpu_torch.ops import schur_qr_baed as sb, schur_qr_packed as sp
    A = _rand(dev, 10, 80)
    for name, stage in (('schur_qr_baed', partial(sb.schur_qr_baed, m=8)),
                        ('schur_qr_packed', sp.schur_qr_packed)):
        ek.reset_launch_counts()
        w, V = eq.eig_small(A, stage)
        torch.cuda.synchronize()
        assert ek.LAUNCHES[name] == 1 and ek.LAUNCHES['schur_qr'] == 0
        assert bool(torch.isfinite(torch.view_as_real(w)).all())
        res = (A @ V - V * w[..., None, :]).abs().amax((-2, -1))
        assert bool((res <= 1e-4 * A.abs().amax((-2, -1))).all())


# ---------------------------------------------------------------------------
# two faults of the multishift stages, held where they showed
# ---------------------------------------------------------------------------

def _wave(dev, order, n_lam):
    """chip_smoke.py's wave matrices at 10 deg: the first n_lam of its
    wavelengths, or its one wavelength of the order-20 solve (500 nm)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import math
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    lams = cs.LAMS[:n_lam] if n_lam else cs.LAM_L
    _, A = cs.wave_matrices(torch, tp, (order, order), lams,
                            math.radians(cs.WELL_POSED_DEG), torch.float32,
                            dev)
    return cs, A.contiguous()


def test_schur_qr_ms_rotations_from_tiny_carries_stay_unitary(dev):
    # the order-6 wave matrix (500 nm, 10 deg) in Hessenberg form by the
    # float64 reduction rounded to complex64: a chase carry there had
    # |x|^2 + |y|^2 below float32's normal range, and the unscaled Givens of
    # csrc/common.cuh left Z unitary to 1.5e-2 only; scaled first, Z is
    # unitary to float32 round-off (chip_smoke.py phase 10's 1e-5)
    from torcwa_tpu_torch.ops import schur_qr_ms as sq
    cs, A = _wave(dev, 6, 0)
    H, Q = ek.hessenberg_plain(A.to(torch.complex128))
    H, Q = H.to(A.dtype), Q.to(A.dtype)
    T, Z, st = sq.schur_qr_ms(H[0], Q[0], m=cs.MS_M, return_stats=True)
    res, orth, tri = cs.schur_quality(torch, A[0], T, Z)
    assert int(st[0]) == 0 and tri
    assert res <= 1e-5 and orth <= 1e-5


def test_schur_qr_baed_aed_rotations_keep_z_unitary(dev):
    # the order-7 wave matrices (B = 8, n = 450, 10 deg) through the routed
    # Hessenberg reduction: with the AED window's rotations formed in
    # float32, Z came out unitary to 1.1e-5 - 1.2e-5 on some lane for the
    # Hessenberg forms of the cluster kernel, the plain float32 reduction and
    # the float64 one rounded; its plain version forms them in float64 and
    # rounds them (schur_ms._givens_scalar), as csrc/aed_warp.cuh does,
    # and every lane holds chip_smoke.py phase 13's 1e-5
    from torcwa_tpu_torch.ops import schur_qr_baed as sb
    cs, A = _wave(dev, 7, 8)
    H, Q = ek.hessenberg(A)
    T, Z, st = sb.schur_qr_baed(H, Q, return_stats=True)
    assert bool((st[0] == 0).all())
    for b in range(A.shape[0]):
        res, orth, tri = cs.schur_quality(torch, A[b], T[b], Z[b])
        assert tri and res <= 1e-5 and orth <= 1e-5


# ---------------------------------------------------------------------------
# schur_qr_ms on a thread-block cluster, tri_vectors a warp per column
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [64, 200, 338, 450, 578])
def test_schur_qr_ms_cluster_kernel_matches_plain(dev, n):
    # random matrices at m = 16: P = 8 at n = 64 and 200, 16 above; Z^T in
    # shared memory to n = 450, in device memory at 578.  Round-off soon
    # decides which subdiagonal deflates first, so kernel and plain are
    # held as chip_smoke.py phase 9 holds them: eigenvalue sets within
    # 1e-4 of the spectral radius, both converged, T triangular, sweeps
    # within 2x and rotations within 20%; residual and unitarity within
    # 1e-5, or where the plain float32 version's own exceed half that (its
    # rotations' round-off in Z grows with their number), within twice its.
    # Readings at n = 450 (seed 510; `qr_compare.py --stage gates`, NVIDIA
    # H100 80GB HBM3, 700.00 W): kernel residual 6.64e-6, unitarity
    # 1.127e-5, stats (0, 552, 348356); plain float32 residual 6.60e-6,
    # unitarity 9.78e-6, stats (0, 551, 328718): the kernel sits 1.15x
    # from the plain version's own unitarity, which alone nearly meets 1e-5
    from torcwa_tpu_torch.ops import schur_qr_ms as sq
    m = 16
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    P, zs = sq.schur_qr_ms_cluster(n, m)
    assert P == (8 if n <= 256 else 16) and zs == (n <= 450)
    A = _rand1(dev, n, 60 + n)
    H, Q = ek.hessenberg_plain(A[None])
    T, Z, st = _launch('schur_qr_ms', sq.schur_qr_ms, H[0], Q[0], m=m,
                       return_stats=True)
    Tp, Zp, stp = sq.schur_qr_ms_plain(H[0], Q[0], m=m, return_stats=True)
    st, stp = [int(x) for x in st], [int(x) for x in stp]
    assert st[0] == 0 and stp[0] == 0
    assert _sets_agree(torch.diagonal(T), torch.diagonal(Tp))
    res, orth, tri = cs.schur_quality(torch, A, T, Z)
    res_p, orth_p, _ = cs.schur_quality(torch, A, Tp, Zp)
    assert tri and res <= max(1e-5, 2 * res_p) \
        and orth <= max(1e-5, 2 * orth_p), (res, res_p, orth, orth_p)
    assert stp[1] / 2 <= st[1] <= 2 * stp[1]
    assert abs(st[2] - stp[2]) <= 0.2 * stp[2]


def test_schur_qr_ms_one_block_kernel_above_the_cluster(dev):
    # n = 700: H's columns do not fit the cluster's shared memory, so the
    # entry point launches the one-block kernel (its plain version takes
    # minutes here): eigenvalues against complex128 LAPACK within 1e-4 of
    # the spectral radius, residual and unitarity 2e-5, as chip_smoke.py
    # phase 9 holds schur_ms(aed=False) at n = 640 (float32 round-off in Z
    # grows with the sweeps of a QR without AED).  Readings (`qr_compare.py
    # --stage gates`, NVIDIA H100 80GB HBM3, 700.00 W): kernel residual
    # 8.21e-6, unitarity 1.216e-5, stats (0, 881, 841744); the plain float32
    # version on the same H, Q residual 8.92e-6, unitarity 1.001e-5, stats
    # (0, 874, 842146): 1.21x its unitarity, and itself at the 1e-5 that
    # the kernel failed once
    from torcwa_tpu_torch.ops import schur_qr_ms as sq
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    n, m = 700, 16
    assert sq.schur_qr_ms_cluster(n, m) == (0, False)
    assert sq.schur_qr_ms_cluster_info(n, m)['cluster'] == 0
    A = _rand1(dev, n, 7)
    H, Q = ek.hessenberg(A[None].contiguous())
    T, Z, st = _launch('schur_qr_ms', sq.schur_qr_ms, H[0], Q[0], m=m,
                       return_stats=True)
    assert int(st[0]) == 0
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    d = cs.set_dist(torch.diagonal(T).to(torch.complex128), w_ref)
    assert d <= 1e-4 * float(w_ref.abs().max())
    res, orth, tri = cs.schur_quality(torch, A, T, Z)
    assert tri and res <= 2e-5 and orth <= 2e-5, (res, orth)


def test_kernel_choices_by_n_on_the_card(dev):
    # what the C entry points launch, read back through them, against the
    # Python mirrors: schur_qr_ms's cluster size (from n alone) and Z's
    # placement, tri_vectors's register slots
    from torcwa_tpu_torch.ops import _build, schur_qr_ms as sq
    for m in (4, 16, 64):
        for n in (1, 2, 5, 64, 200, 256, 257, 338, 450, 470, 480, 578, 640,
                  672, 700, 1000):
            info = sq.schur_qr_ms_cluster_info(n, m)
            P, zs = sq.schur_qr_ms_cluster(n, m)
            assert (info['cluster'], info['z_shared']) == (P, zs), (n, m)
            if P:
                assert info['smem_bytes'] == sq.cluster_smem_bytes(n, P, m,
                                                                   zs)
    lib = _build.load()
    for n in (1, 32, 33, 128, 129, 338, 450, 578, 640, 641, 882):
        assert lib.torcwa_tri_vectors_slots(n) == ek.tri_vectors_slots(n)


def _schur_batch(dev, B, n, seed):
    import scipy.linalg as sl
    rng = np.random.default_rng(seed)
    T = [sl.schur(rng.standard_normal((n, n))
                  + 1j * rng.standard_normal((n, n)), output='complex')[0]
         for _ in range(B)]
    return torch.as_tensor(np.ascontiguousarray(np.stack(T), np.complex64),
                           device=dev)


def _vec_err(Y, Yp):
    """max|Y - Yp| / max|Yp| per lane, the worst lane."""
    return float(((Y - Yp).abs().amax((-2, -1))
                  / Yp.abs().amax((-2, -1))).max())


@pytest.mark.parametrize('B', [1, 8])
@pytest.mark.parametrize('n', [64, 200, 338, 450, 578, 700])
def test_tri_vectors_kernels_match_plain(dev, n, B):
    # Schur factors of random matrices: the warp per column (n <= 640) sums
    # each row in descending l, the plain version in its einsum's order;
    # float32, the two within 1e-5 of max|Y| per lane (the two orders of
    # the plain version sat 5e-7 - 6e-7 apart at n = 338 and 578 in a CPU
    # run); n = 700 takes the one-block kernel
    T = _schur_batch(dev, B, n, 70 + n + B)
    Y = _launch('tri_vectors', ek.tri_vectors, T)
    Yp = ek.tri_vectors_plain(T)
    assert _vec_err(Y, Yp) <= 1e-5
    assert bool((torch.tril(Y, -1) == 0).all())
    assert bool((torch.diagonal(Y, dim1=-2, dim2=-1) == 1).all())


def test_tri_vectors_warp_kernel_floors_the_pivots(dev):
    # an exactly repeated eigenvalue (the pivot 0 becomes dmin) and a
    # near-repeated one (1e-6 apart, under dmin ~ 4e-6: scaled to dmin) in
    # each lane, n = 200: those columns grow by ~1/dmin; every column
    # within 1e-5 of its own largest entry of the plain version's
    T = _schur_batch(dev, 2, 200, 5)
    for b in range(2):
        T[b, 40, 40] = T[b, 7, 7]
        T[b, 91, 91] = T[b, 90, 90] + 1e-6
    Y = _launch('tri_vectors', ek.tri_vectors, T)
    Yp = ek.tri_vectors_plain(T)
    err = ((Y - Yp).abs().amax(-2) / Yp.abs().amax(-2)).max()
    assert float(err) <= 1e-5
    assert float(Yp[:, :, 40].abs().max()) > 1e4


# ---------------------------------------------------------------------------
# The class API (torcwa_tpu_torch.rcwa) on the card
# ---------------------------------------------------------------------------

def _class_stack(device, dtype=torch.complex64, backend='auto'):
    # substrate, a patterned layer, a homogeneous spacer, air; order (3, 3)
    # (2N = 98, the small route), 10 deg
    import torcwa_tpu_torch as tp
    g = tp.geometry(Lx=300., Ly=300., nx=64, ny=64, edge_sharpness=500.,
                    dtype=torch.float32, device=device)
    occ = g.rectangle(160., 100., 150., 150.)
    sim = tp.rcwa(freq=1 / 532., order=[3, 3], L=[300., 300.], dtype=dtype,
                  device=device, eig_backend=backend)
    sim.add_input_layer(eps=1.46 ** 2)
    sim.add_output_layer(eps=1.)
    sim.set_incident_angle(np.radians(10.), 0.)
    sim.add_layer(thickness=300., eps=occ * (12. + 0.5j) + (1. - occ))
    sim.add_layer(thickness=200., eps=1.6 ** 2)
    sim.solve_global_smatrix()
    return sim


def test_class_on_the_card_matches_the_cpu(dev):
    # the same class, complex64, 'auto': the eig kernels on the card, their
    # plain versions on the CPU; |S|^2 within 1e-4 at four orders
    ek.reset_launch_counts()
    sg = _class_stack(dev)
    assert all(ek.LAUNCHES[k] > 0 for k in ('hessenberg', 'schur_qr',
                                            'tri_vectors'))
    assert sg.S[0].device.type == 'cuda'
    sc = _class_stack('cpu')
    orders = [[0, 0], [1, 0], [0, 1], [-1, -1]]
    for pol in ('xx', 'yy', 'pp', 'ss'):
        for port in ('transmission', 'reflection'):
            a = sg.S_parameters(orders, port=port, polarization=pol).cpu()
            b = sc.S_parameters(orders, port=port, polarization=pol)
            assert float((a.abs() ** 2 - b.abs() ** 2).abs().max()) <= 1e-4


def test_class_complex128_on_the_card_needs_the_torch_backend(dev):
    import torcwa_tpu_torch as tp
    for backend in ('auto', 'kernels', 'qr'):
        with pytest.raises(TypeError, match="eig_backend='torch'"):
            tp.rcwa(freq=1 / 532., order=[3, 3], L=[300., 300.],
                    dtype=torch.complex128, device=dev, eig_backend=backend)
    sim = _class_stack(dev, torch.complex128, 'torch')
    assert sim.S[0].dtype == torch.complex128


def test_class_device_none_solves_on_the_card(dev):
    import torcwa_tpu_torch as tp
    for kw in ({}, {'device': None}):
        sim = tp.rcwa(freq=1 / 532., order=[2, 2], L=[300., 300.], **kw)
        sim.add_input_layer(eps=1.46 ** 2)
        sim.set_incident_angle(0.1, 0.)
        sim.add_layer(thickness=100., eps=torch.full((32, 32), 4.))
        sim.solve_global_smatrix()
        assert sim.S[0].device.type == 'cuda'
        assert sim.S_parameters([0, 0]).device.type == 'cuda'


def test_functional_mixed_stack_on_the_card_matches_the_cpu(dev):
    # patterned, homogeneous, patterned at order (3, 3), complex64, 10 deg,
    # modes carried: the eig kernels on the card against their plain
    # versions on the CPU; |S|^2 at four orders within 1e-4 (as the class
    # is held), the S-blocks within 1e-3 of their largest entry (evanescent
    # orders' entries reach past 1), the tensors on the card
    import torcwa_tpu_torch as tp
    rng = np.random.default_rng(12)
    eps = 1.5 + 2 * rng.random((2, 48, 48)).astype(np.float32)
    spec = tp.StackSpec(order=(3, 3), L=(300., 300.), n_layers=3,
                        has_input=True, has_output=True,
                        homogeneous=(False, True, False))

    def solve(device):
        return tp.solve_stack_pair(
            spec, 1 / 532., np.radians(10.), 0.,
            torch.as_tensor(eps, device=device), [200., 100., 150.],
            eps_in=1.46 ** 2, eps_out=1., eps_scalars=[2.56],
            with_modes=True)

    ek.reset_launch_counts()
    Sg, ig = solve(dev)
    assert ek.LAUNCHES['schur_qr'] > 0
    assert Sg[0].device.type == 'cuda' and ig['C'][0][0].device.type == 'cuda'
    Sc, ic = solve('cpu')
    for a, b in zip(Sg, Sc):
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * float(b.abs().max())
    orders = [[0, 0], [1, 0], [0, 1], [-1, -1]]
    for pol in ('xx', 'yy'):
        for port in ('transmission', 'reflection'):
            t = [tp.sparam_xy_pair(S, i['kx'], i['ky'], 1.46 ** 2, 1., (3, 3),
                                   orders, [0, 0], pol, port=port).cpu()
                 for S, i in ((Sg, ig), (Sc, ic))]
            assert float((t[0].abs() ** 2 - t[1].abs() ** 2).abs().max()) \
                <= 1e-4


def test_homogeneous_stack_of_python_scalars_solves_on_the_card(dev):
    # a thin-film stack given only as Python numbers: no device asked, the
    # solve runs on the card; its S-blocks within 1e-5 of the CPU's
    import torcwa_tpu_torch as tp
    spec = tp.StackSpec(order=(2, 2), L=(300., 300.), n_layers=2,
                        has_input=True, has_output=True,
                        homogeneous=(True, True))
    kw = dict(eps_in=1.46 ** 2, eps_out=1., eps_scalars=[2.25, 3.1 + 0.1j])
    Sg, ig = tp.solve_stack_pair(spec, 1 / 532., 0.1, 0., None,
                                 [120., 75.], **kw)
    assert Sg[0].device.type == 'cuda' and ig['kx'].device.type == 'cuda'
    Sc, _ = tp.solve_stack_pair(spec, 1 / 532., 0.1, 0., None, [120., 75.],
                                device='cpu', **kw)
    for a, b in zip(Sg, Sc):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(
            b.abs().max())


def test_maximize_adam_on_the_card_matches_the_cpu(dev):
    # two ADAM steps on |t_xx|^2 + |t_yy|^2 of a raster at order (3, 3),
    # float32, 10 deg: the card through the kernels against the CPU through
    # their plain versions; the FoMs within 1e-4 and the gradient norms
    # within 1e-3 of theirs at both steps, every tensor of the state on the
    # card.  (A first ADAM step moves each pixel by ~lr sign(g), so the
    # parameters themselves are not compared.)
    import torcwa_tpu_torch as tp
    spec = tp.StackSpec(order=(3, 3), L=(300., 300.), n_layers=1)

    def fom(e):
        S, i = tp.solve_stack_pair(spec, 1 / 530., np.radians(10.), 0.,
                                   e[None], [250.], eps_in=1.46 ** 2)
        return sum(tp.sparam_xy_pair(S, i['kx'], i['ky'], 1.46 ** 2, 1.,
                                     (3, 3), [0, 0], [0, 0], pol)[0].abs() ** 2
                   for pol in ('xx', 'yy'))

    eps0 = 1.5 + 2 * np.random.default_rng(13).random((40, 40))
    runs = {}
    for device in (dev, 'cpu'):
        e = torch.as_tensor(eps0.astype(np.float32), device=device)
        runs[str(device)] = tp.optim.maximize_adam(fom, e, 2, lr=0.05,
                                                   lower=1., upper=4.)
    (pg, (mg, _, sg), hg), (pc, _, hc) = runs[str(dev)], runs['cpu']
    assert sg == 2 and pg.device.type == mg.device.type == 'cuda'
    hg, hc = np.array(hg), np.array(hc)
    assert np.abs(hg[:, 0] - hc[:, 0]).max() <= 1e-4
    assert np.all(np.abs(hg[:, 1] - hc[:, 1]) <= 1e-3 * hc[:, 1])
    assert pc.device.type == 'cpu'


def test_load_state_defaults_to_the_card(dev, tmp_path):
    from torcwa_tpu_torch.utils import load_state, save_state
    path = str(tmp_path / 'state.npz')
    save_state(path, {'rho': torch.rand(4, 3, device=dev), 'step': 7,
                      'm': [torch.zeros(2)]})
    for kw in ({}, {'device': None}, {'device': dev}):
        st = load_state(path, **kw)
        assert st['rho'].device.type == 'cuda' and int(st['step']) == 7
        assert st['m'][0].device.type == 'cuda'
    assert load_state(path, device='cpu')['rho'].device.type == 'cpu'


def test_batched_rasters_through_the_kernels_match_a_loop(dev):
    # one raster a lane, [B, 1, nx, ny], through the eig kernels (small
    # route, B = 3 at n = 50) against each lane solved alone on the card,
    # float32, |S| within 1e-4 of max|S|
    import torcwa_tpu_torch as tp
    rng = np.random.default_rng(5)
    eps = torch.as_tensor((1. + 3. * rng.random((3, 1, 32, 32)))
                          .astype(np.float32), device=dev)
    spec = tp.StackSpec(order=(2, 2), L=(300., 300.), n_layers=1,
                        has_input=True)
    freq = torch.tensor([1 / 480., 1 / 560., 1 / 640.], device=dev)
    ek.reset_launch_counts()
    S, _ = tp.solve_stack_pair(spec, freq, 0.1, 0., eps, [250.],
                               eps_in=1.46 ** 2)
    assert ek.LAUNCHES['schur_qr'] == 1
    for b in range(3):
        Sb, _ = tp.solve_stack_pair(spec, freq[b], 0.1, 0., eps[b], [250.],
                                    eps_in=1.46 ** 2)
        for x, y in zip(S, Sb):
            assert float((x[b] - y).abs().max()) <= 1e-4 * float(
                y.abs().max())


def test_shard_sweep_on_the_card_twice(dev):
    # five points on a mesh of the card twice: the padding path on one
    # card, equal to the direct batched call
    from torcwa_tpu_torch.parallel import shard_sweep, sweep_mesh
    mesh = sweep_mesh(['cuda:0'] * 2)
    assert sweep_mesh().devices[0] == dev
    xs = torch.linspace(0.3, 2.1, 5, device=dev)
    got = shard_sweep(lambda x: {'t': torch.sin(3. * x) * x}, mesh)(xs)
    assert got['t'].device == dev and got['t'].shape == (5,)
    torch.testing.assert_close(got['t'], torch.sin(3. * xs) * xs, rtol=1e-6,
                               atol=0.)

