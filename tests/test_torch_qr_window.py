"""The windowed chase of ``csrc/schur_qr.cu``, modelled on the CPU.

On the card the single-shift QR chases each bulge through windows of w
rows in shared memory and applies the window's rotations to the rest of H
and Z afterwards, as chains in ascending k.  ``_single_shift_sweeps(...,
window=w)`` is that schedule in PyTorch, lane by lane.  Here it is held to
the plain versions that apply every rotation at once (``schur_qr_plain``,
``schur_qr_v2_plain``), whose arithmetic it shares operation by operation:
the same stats, T and Z, in float64, at windows of 8 and 16 rows, on random
matrices, the wave matrices of the bench layer at orders (2, 2) and (3, 3),
and a batch whose lanes converge at different sweeps.  Then the model
against the Pallas kernel it replaces (``_kernel_acc`` in the interpreter)
on eigenvalue sets, with the window events it has to get right counted;
and a chain applied in the wrong order, which the check must catch.
Inputs are made with numpy from a seed.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from torcwa_tpu.ops.eig_qr_pallas import (  # noqa: E402
    hessenberg_pallas, schur_qr_pallas_acc)
import torcwa_tpu_torch as tp  # noqa: E402
from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops.fourier import material_conv  # noqa: E402

torch.set_num_threads(2)

RULES = {'acc': ek.ACC_RULES, 'v2': ek.V2_RULES}


def _rand(B, n, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((B, n, n))
                           + 1j * rng.standard_normal((B, n, n)))


def _wave(order, inc_deg, lams=(450., 620.)):
    """A = P Q of a 160 nm pillar (eps 2.07^2) in a 300 nm cell, grid 32,
    float64: exactly real at normal incidence."""
    g = tp.geometry(Lx=300., Ly=300., nx=32, ny=32, edge_sharpness=500.,
                    dtype=torch.float64, device='cpu')
    eps = g.rectangle(160., 160., 150., 150.) * (2.0709 ** 2 - 1.) + 1.
    freq = 1. / torch.tensor(lams, dtype=torch.float64)
    kx, ky = tp.kvectors_real(freq, math.radians(inc_deg), 0., 1.46, order,
                              (300., 300.), torch.float64)
    P, Q = tp.pq_pair(material_conv(eps, order), kx, ky)
    return P @ Q


def _mixed():
    """Three lanes of n = 40: two random ones of another scale, and one
    upper triangular, converged before its first sweep."""
    A = _rand(3, 40, 7)
    A[1] *= 1e3
    A[2] = torch.triu(A[2])
    return A


CASES = {
    'random n=24': (lambda: _rand(2, 24, 24), None),
    'random n=40': (lambda: _rand(2, 40, 40), None),
    'random n=96': (lambda: _rand(1, 96, 96), 40),
    'random n=130': (lambda: _rand(1, 130, 130), 25),
    'wave (2, 2) 0 deg': (lambda: _wave((2, 2), 0.), None),
    'wave (2, 2) 10 deg': (lambda: _wave((2, 2), 10.), None),
    'wave (3, 3) 0 deg': (lambda: _wave((3, 3), 0.)[:1], 40),
    'wave (3, 3) 10 deg': (lambda: _wave((3, 3), 10.)[:1], 40),
    'lanes converging apart': (_mixed, None),
}
# (case, window): each size at one or both windows; n = 24, 40, 96, 130
# and the wave matrices' 50 are no multiple of either window's step (6 or
# 14), 98 is one of 14
PAIRS = [('random n=24', 8), ('random n=24', 16), ('random n=40', 8),
         ('random n=40', 16), ('random n=96', 16), ('random n=130', 8),
         ('wave (2, 2) 0 deg', 8), ('wave (2, 2) 10 deg', 16),
         ('wave (3, 3) 0 deg', 16), ('wave (3, 3) 10 deg', 8),
         ('lanes converging apart', 8)]

_direct = {}


def _inputs(case):
    make, budget = CASES[case]
    A = make()
    H, Q = ek.hessenberg_plain(A)
    return A, H, Q, budget or 40 * A.shape[-1]


def _direct_run(case, rules):
    """The plain version (every rotation at once) on a case, kept for the
    windows that follow: (A, H, Q, budget, result)."""
    if (case, rules) not in _direct:
        A, H, Q, budget = _inputs(case)
        plain = ek.schur_qr_plain if rules == 'acc' else ek.schur_qr_v2_plain
        out = _single_shift(H, Q, budget, rules)
        if rules == 'acc':
            T, Z, hi, sweeps = plain(H, Q, max_iters=budget)
        else:
            T, Z, hi, sweeps, _ = plain(H, Q, max_iters=budget)
        assert torch.equal(T, out[0]) and torch.equal(hi, out[2])
        _direct[case, rules] = (A, H, Q, budget, out)
    return _direct[case, rules]


def _single_shift(H, Q, budget, rules, window=None):
    return ek._single_shift_sweeps(H, Q, budget, **RULES[rules],
                                   window=window)


def _agrees(A, direct, windowed):
    """The windowed run is the direct one: stats equal, T and Z within
    1e-12 of max|H| (max|Z| = 1), and Z T Z^H = A within 1e-12 of ||A||_F
    per lane.  Returns the failures, empty when it agrees."""
    T, Z, hi, sweeps, rot = direct
    Tw, Zw, hiw, sweepsw, rotw = windowed
    fails = []
    for name, a, b in (('hi', hi, hiw), ('sweeps', sweeps, sweepsw),
                       ('rotations', rot, rotw)):
        if not torch.equal(a, b):
            fails.append(f'{name} {a.tolist()} != {b.tolist()}')
    scale = float(A.abs().max())
    dT = float((T - Tw).abs().max())
    dZ = float((Z - Zw).abs().max())
    if not dT <= 1e-12 * scale:
        fails.append(f'T off by {dT / scale:.2e} of max|A|')
    if not dZ <= 1e-12:
        fails.append(f'Z off by {dZ:.2e}')
    # an unfinished lane's T is the sweeps' Hessenberg state with its lower
    # triangle cleared: the similarity is read where it holds
    res = torch.linalg.matrix_norm(Zw @ Tw @ Zw.mH - A)
    done = hiw == 0
    if bool(done.any()) and not bool(
            (res[done] <= 1e-12 * torch.linalg.matrix_norm(A)[done]).all()):
        fails.append(f'Z T Z^H != A: {res.tolist()}')
    return fails


@pytest.mark.parametrize('rules', ['acc', 'v2'])
@pytest.mark.parametrize('case,window', PAIRS)
def test_window_schedule_is_the_direct_one(case, window, rules):
    A, H, Q, budget, direct = _direct_run(case, rules)
    windowed = _single_shift(H, Q, budget, rules, window)
    assert _agrees(A, direct, windowed) == []
    # T and Z are the same bits: each entry takes the same operations in
    # the same order, in element-wise arithmetic that rounds alike
    assert torch.equal(direct[0], windowed[0])
    assert torch.equal(direct[1], windowed[1])
    if CASES[case][1] is None:
        assert bool((direct[2] == 0).all())


def test_lanes_converge_at_different_sweeps():
    A, H, Q, budget, (T, Z, hi, sweeps, rot) = _direct_run(
        'lanes converging apart', 'acc')
    assert bool((hi == 0).all())
    assert len(set(sweeps.tolist())) == 3 and int(rot[2]) == 0


def _reversed_above(cs, right, above, zcols):
    """The deferred chains with the slab above the window taking its
    rotations in descending k: the kernel's order reversed."""
    for t, (c, s) in enumerate(cs):
        ek._rotate_rows(c, s, right, t)
        ek._rotate_cols(c, s, zcols, t)
    for t, (c, s) in reversed(list(enumerate(cs))):
        ek._rotate_cols(c, s, above, t)


def test_the_check_catches_the_slab_above_in_descending_k(monkeypatch):
    # rotations k and k + 1 share column k + 1, so their order matters;
    # with the chain above the window reversed the check must fail
    A, H, Q, budget, direct = _direct_run('random n=40', 'acc')
    monkeypatch.setattr(ek, '_window_chains', _reversed_above)
    fails = _agrees(A, direct, _single_shift(H, Q, budget, 'acc', 8))
    assert fails and any(f.startswith(('T off', 'Z off', 'sweeps'))
                         for f in fails)


# ---------------------------------------------------------------------------
# the model against the Pallas kernel, and the window events it covers
# ---------------------------------------------------------------------------

def _pair(z):
    return (jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))


def _np(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _windows(lo, hr, n, window):
    """The kernel's windows of one run: (a, re, k1) each."""
    a = lo
    while True:
        re = min(a + window, n)
        k1 = hr - 1 if re == n else min(hr - 1, a + window - 3)
        yield a, re, k1
        if k1 == hr - 1:
            return
        a = k1 + 1


def _events(sweeps, n, window):
    """What the windows of the recorded sweeps (each a list of one lane's
    runs (lo, hr), top-most first, the bottom run ending at the lane's
    window bottom hi) cover: a run shorter than a window; a run starting in
    the rows of the previous run's last window; the bulge leaving at hi
    inside a window (the window reaches below hi); the most runs a sweep;
    and whether n is a multiple of the window's step."""
    ev = dict(short=False, starts_in_window=False, leaves_at_hi=False,
              most_runs=max(map(len, sweeps)), n_off_step=n % (window - 2))
    for runs in sweeps:
        prev = None
        for lo, hr in runs:
            wins = list(_windows(lo, hr, n, window))
            ev['short'] |= hr - lo + 1 < window
            ev['starts_in_window'] |= prev is not None and lo < prev
            prev = wins[-1][1]
        ev['leaves_at_hi'] |= wins[-1][1] - 1 > runs[-1][1]
    return ev


@pytest.mark.parametrize('window', [8, 16])
def test_window_model_matches_pallas(monkeypatch, window):
    # a random n = 50 Hessenberg matrix (no multiple of either window's
    # step) with subdiagonals 10, 20, 30 set to zero, so that sweeps start
    # with four runs, the upper ones shorter than a window and starting in
    # the rows of the last window of the run above; float32 like the Pallas
    # kernel (f32 only), one lane so the recorded runs fall into sweeps.
    # Eigenvalue sets within 1e-4 of the spectral radius and sweeps within
    # 30%, as tests/test_torch_eig_kernels.py holds the plain version to the
    # same kernel
    n = 50
    rng = np.random.default_rng(50)
    A = (rng.standard_normal((1, n, n))
         + 1j * rng.standard_normal((1, n, n))).astype(np.complex64)
    Hr, Hi, Qr, Qi = hessenberg_pallas(*_pair(A), interpret=True)
    Hn = _np((Hr, Hi)).astype(np.complex64)
    for k in (10, 20, 30):
        Hn[0, k + 1, k] = 0
    Qn = _np((Qr, Qi))
    A = Qn @ Hn @ Qn.conj().transpose(0, 2, 1)
    Tr, Ti, _, _, (hi_ref, sw_ref) = schur_qr_pallas_acc(
        *_pair(Hn), Qr, Qi, interpret=True, return_stats=True)
    sweeps_seen = []
    run = ek._window_run

    def recorded(H, Z, lo, hr, shift, hi, w):
        # the runs of a sweep come top-most first, each below the last
        # one's bottom; the next sweep's first run starts above it
        if not sweeps_seen or lo <= sweeps_seen[-1][-1][1]:
            sweeps_seen.append([])
        sweeps_seen[-1].append((lo, hr))
        return run(H, Z, lo, hr, shift, hi, w)

    monkeypatch.setattr(ek, '_window_run', recorded)
    H = torch.as_tensor(Hn)
    Q = torch.as_tensor(Qn.astype(np.complex64))
    T, Z, hi, sweeps, rot = _single_shift(H, Q, 40 * n, 'acc', window)
    assert int(hi[0]) == 0 and int(np.asarray(hi_ref)[0]) == 0
    assert abs(int(sweeps[0]) - int(sw_ref[0])) <= 0.3 * int(sw_ref[0])
    w = np.diag(T[0].numpy())
    w_ref = np.diag(_np((Tr, Ti))[0])
    dist = np.abs(w[:, None] - w_ref[None, :]).min(axis=1).max()
    assert dist <= 1e-4 * np.abs(w_ref).max()
    res = np.linalg.norm(Z[0].numpy() @ T[0].numpy().astype(np.complex128)
                         @ Z[0].numpy().conj().T - A[0])
    assert res <= 1e-5 * np.linalg.norm(A[0])
    # every sweep is recorded but the last, which finds every subdiagonal
    # dead and chases nothing
    assert len(sweeps_seen) == int(sweeps[0]) - 1
    ev = _events(sweeps_seen, n, window)
    assert ev == dict(short=True, starts_in_window=True, leaves_at_hi=True,
                      most_runs=ek.NRUNS, n_off_step=n % (window - 2)) \
        and ev['n_off_step']
