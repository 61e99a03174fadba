"""The lanes of a batch through ``schur_ms`` in lock step, on the CPU.

``schur_ms`` and ``schur_ms_plain`` take a batch (B, n, n) and run every
lane through each sweep together (``schur_ms._sweeps``); each lane keeps its
own active block, stall count, budget and decisions.  On CPU tensors the
steps are the plain versions, lane by lane inside each sweep, so a lane's
T, Z and stats must equal, bit for bit, those of the lane alone: what these
tests hold is the lock-step schedule.  The CUDA kernels are held to the
same equality on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 20).  Inputs come from numpy ``default_rng(seed)``.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from torcwa_tpu_torch.ops import eig_kernels as ek  # noqa: E402
from torcwa_tpu_torch.ops import eig_qr as eq  # noqa: E402
from torcwa_tpu_torch.ops import schur_ms as sm  # noqa: E402
from torcwa_tpu_torch.utils import timing  # noqa: E402

torch.set_num_threads(2)

# small shifts, AED window and chase window, so that n = 96..160 sweeps
# many times through two or three overlapping windows
CFG = dict(m=8, kw=24, wb=128)


def _random(n, seed):
    """A random complex64 matrix reduced to Hessenberg form, with its Q."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H, Q = ek.hessenberg_plain(torch.as_tensor((0.3 * a).astype(
        np.complex64))[None])
    return H[0], Q[0]


def _nearly_triangular(n, seed):
    """Upper triangular but for a subdiagonal of 1e-3, Q = I: it converges
    in a few sweeps where a random lane takes tens."""
    rng = np.random.default_rng(seed)
    h = np.triu(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    h += np.diag(1e-3 * rng.standard_normal(n - 1), -1)
    return (torch.as_tensor(h.astype(np.complex64)),
            torch.eye(n, dtype=torch.complex64))


def _batch(kinds, n, seed):
    lanes = [(_random if k == 'random' else _nearly_triangular)(n, seed + i)
             for i, k in enumerate(kinds)]
    return (torch.stack([h for h, _ in lanes]),
            torch.stack([q for _, q in lanes]))


def _bits(x):
    """x's bits, so that NaNs compare too."""
    return torch.view_as_real(x.contiguous()).view(torch.int32)


def _equal(T, Z, Tl, Zl):
    return (torch.equal(_bits(T), _bits(Tl))
            and torch.equal(_bits(Z), _bits(Zl)))


def _each_lane_alone(H, Q, **kw):
    for l in range(H.shape[0]):
        yield sm.schur_ms_plain(H[l], Q[l], return_stats=True, **kw)


def _assert_lanes_alone(H, Q, **kw):
    """The batch's T, Z and stats against each lane's alone, bit for bit;
    returns the batch's stats."""
    T, Z, stats = sm.schur_ms_plain(H, Q, return_stats=True, **kw)
    assert T.shape == Z.shape == H.shape and len(stats) == H.shape[0]
    for l, (Tl, Zl, st) in enumerate(_each_lane_alone(H, Q, **kw)):
        assert _equal(T[l], Z[l], Tl, Zl)
        assert tuple(stats[l]) == tuple(st)
    return stats


@pytest.mark.parametrize('kinds,n,aed', [
    (('random',), 96, True),
    (('nearly triangular', 'random'), 128, True),
    (('nearly triangular', 'random', 'nearly triangular'), 96, True),
    (('random', 'nearly triangular'), 96, False),
])
def test_lanes_in_lock_step_match_each_lane_alone(kinds, n, aed):
    # a nearly triangular lane beside random ones: lanes that converge many
    # sweeps apart; aed=False takes the shifts from the trailing block
    H, Q = _batch(kinds, n, 40 + n)
    stats = _assert_lanes_alone(H, Q, aed=aed, **CFG)
    assert all(st[0] == 0 for st in stats)          # every lane converged
    sweeps = [st[1] for st in stats]
    if len(kinds) > 1 and aed:
        assert max(sweeps) >= 2 * min(sweeps)


def test_a_budget_that_runs_out_in_one_lane_poisons_that_lane_only():
    # 10 sweeps: the nearly triangular lane converges, the random one not
    H, Q = _batch(('random', 'nearly triangular'), 96, 7)
    stats = _assert_lanes_alone(H, Q, budget=10, **CFG)
    assert stats[0][0] > 0 and stats[0][1] == 10 and stats[1][0] == 0
    T, _ = sm.schur_ms_plain(H, Q, budget=10, **CFG)
    assert bool(torch.isnan(torch.diagonal(T[0])).all())
    assert bool(torch.isfinite(torch.diagonal(T[1])).all())


@pytest.mark.parametrize('kinds', [('random',),
                                   ('nearly triangular', 'random')])
def test_eig_schur_counts_lanes_their_sweeps_and_the_loops(kinds):
    # schur_ms itself (not the _plain entry) on a batch: each lane as alone;
    # matrices = B, sweeps = the lanes' sweeps added together,
    # lockstep_sweeps = the loop's (the slowest lane's): one host read each
    H, Q = _batch(kinds, 64, 5)
    with timing.tracing() as tr:
        T, Z, stats = sm.schur_ms(H, Q, return_stats=True, **CFG)
        tr.collect()
    assert ek.LAUNCHES['schur_ms'] == 0                 # CPU: no launch
    for l, (Tl, Zl, st) in enumerate(_each_lane_alone(H, Q, **CFG)):
        assert _equal(T[l], Z[l], Tl, Zl)
        assert tuple(stats[l]) == tuple(st)
    span, = tr.records
    sweeps = [st[1] for st in stats]
    assert span.counters == {'sweeps': sum(sweeps), 'matrices': len(kinds),
                             'lockstep_sweeps': max(sweeps)}


def test_large_route_on_a_batch_equals_each_matrix_alone(monkeypatch):
    # LARGE_MIN_N patched down: one schur_ms call on the batch of 2, whose
    # lanes' w and V equal those of two B = 1 calls
    monkeypatch.setattr(eq, 'LARGE_MIN_N', 32)
    shapes = []
    monkeypatch.setattr(eq, 'schur_ms', lambda H, *a, **k: (
        shapes.append(tuple(H.shape)), sm.schur_ms(H, *a, **k))[1])
    rng = np.random.default_rng(9)
    a = rng.standard_normal((2, 48, 48)) + 1j * rng.standard_normal(
        (2, 48, 48))
    A = torch.as_tensor(a.astype(np.complex64))
    w, V = eq.eig_qr(A)
    assert shapes == [(2, 48, 48)]
    for l in range(2):
        wl, Vl = eq.eig_qr(A[l])
        assert torch.equal(w[l], wl) and torch.equal(V[l], Vl)
    assert shapes[1:] == [(1, 48, 48)] * 2


class _StandIn:
    """The C entry points of csrc/schur_ms.cu as the host calls them, each
    lane table entry worked by the plain steps on its lane: what the
    kernels would do, on CPU tensors found by their data pointers.  It
    holds the tables' layout, the lanes' strides and info records and the
    one read a sweep to the kernels' contract."""

    def __init__(self, *tensors):
        self.at = {t.data_ptr(): t for t in tensors}
        self.calls = []
        self.launched = 0

    def _rows(self, rec, count, width):
        return [tuple(rec[e * width:(e + 1) * width]) for e in range(count)]

    def _made(self, launches, keys):
        """Report the launches the kernels make for lane table entries of
        these template keys: one a key and 32 lanes."""
        launches[0] = sum(-(-keys.count(k) // 32) for k in set(keys))
        self.launched += launches[0]
        return 0

    def torcwa_ms_band_scan_c64(self, H, n, rec, count, mult, info,
                                launches, stream):
        self.calls.append('band_scan')
        Hb, info = self.at[H], self.at[info]
        for lane, hi_top in self._rows(rec, count, 2):
            info[lane, :2] = torch.tensor(sm.band_scan_plain(Hb[lane], hi_top,
                                                             mult))
        return self._made(launches, [0] * count)

    def torcwa_ms_aed_c64(self, H, n, info, rec, count, m, kw, mult, Lp,
                          shifts, launches, stream):
        self.calls.append('aed')
        Hb, info, Lp, sh = (self.at[p] for p in (H, info, Lp, shifts))
        for lane, exc in self._rows(rec, count, 2):
            lo, hi = info[lane, :2].tolist()
            if hi <= 0:
                info[lane, 2:5] = 0
                continue
            s, kwe, hi_new, sh[lane], L = sm.aed_plain(Hb[lane], lo, hi, m, kw,
                                                       mult, bool(exc))
            Lp[lane, :kwe * kwe] = L.reshape(-1)
            info[lane, 2:5] = torch.tensor([s, kwe, hi_new])
        return self._made(launches, [0] * count)

    def torcwa_ms_trailing_shifts_c64(self, H, n, info, rec, count, m,
                                      shifts, launches, stream):
        self.calls.append('aed')
        Hb, info, sh = (self.at[p] for p in (H, info, shifts))
        for lane, exc in self._rows(rec, count, 2):
            lo, hi = info[lane, :2].tolist()
            info[lane, 2:5] = torch.tensor([0, 0, hi])
            if hi > 0:
                sh[lane] = sm.trailing_shifts_plain(Hb[lane], lo, hi, m,
                                                    bool(exc))
        return self._made(launches, [0] * count)

    def torcwa_ms_chase_c64(self, H, n, U, us, rec, count, m, shifts, xy,
                            launches, stream):
        self.calls.append('chase')
        Hb, U, sh, xy = (self.at[p] for p in (H, U, shifts, xy))
        for lane, a, wbe, tcur, t_end, lo, hi in self._rows(rec, count, 7):
            xs, ys, Uw = sm._chase_window_plain(
                Hb[lane], sh[lane], xy[lane, :m].clone(),
                xy[lane, m:].clone(), a, wbe, tcur, t_end, lo, hi)
            U.view(-1)[lane * us:lane * us + wbe * wbe] = Uw.reshape(-1)
            xy[lane] = torch.cat([xs, ys])
        return self._made(launches, [0] * count)

    def torcwa_ms_apply_slabs_c64(self, H, ldh, Z, ldz, n, nz, P, ps, rec,
                                  count, launches, stream):
        self.calls.append('slabs')
        Hb, Zb, P = self.at[H], self.at[Z], self.at[P].view(-1)
        rows = self._rows(rec, count, 4)
        for lane, a, w, ldp in rows:
            Pm = P[lane * ps:lane * ps + w * ldp].view(w, ldp)[:, :w]
            sm.ms_apply_window_plain(Hb[lane], Zb[lane], a, w, Pm)
        # one launch a register tile of 32 rows
        return self._made(launches, [-(-w // 32) for _, _, w, _ in rows])


@pytest.mark.parametrize('aed', [True, False])
def test_the_kernels_lane_tables_on_a_stand_in_library(monkeypatch, aed):
    # _CudaOps, the path CUDA tensors take, through a stand-in library:
    # the lane tables, strides and info records it hands the C entry points
    # carry each lane's steps, so every lane ends as the plain loop leaves
    # it alone, with the same stats; one band scan, one AED (or trailing
    # shifts) launch and one read a sweep of the loop, whatever the lanes
    H, Q = _batch(('random', 'nearly triangular'), 48, 11)
    H3, Z3 = H.clone(), Q.clone()
    ops = sm._CudaOps(H3, Z3, CFG['m'], CFG['kw'], CFG['wb'], 4.0)
    lib = _StandIn(H3, Z3, ops.info, ops.Lp, ops.U, ops.shifts, ops.xy)
    monkeypatch.setattr(sm, '_build', type('B', (), {'load': lambda: lib}))
    monkeypatch.setattr(sm, '_stream', lambda: 0)
    before = ek.LAUNCHES['schur_ms']
    stats, steps = sm._sweeps(ops, 48, CFG['m'], CFG['kw'], CFG['wb'],
                              sm.max_sweeps(48, CFG['m']), sm.NIBBLE, aed)
    T = torch.triu(H3)
    for l, (Tl, Zl, st) in enumerate(_each_lane_alone(H, Q, aed=aed,
                                                      **CFG)):
        assert _equal(T[l], Z3[l], Tl, Zl)
        assert tuple(stats[l]) == tuple(st)
    assert steps == max(st[1] for st in stats) > stats[1][1]
    assert lib.calls.count('band_scan') == lib.calls.count('aed') == steps
    # LAUNCHES counts the launches the entry points report: one call on
    # two lanes whose windows take other register tiles makes two
    assert ek.LAUNCHES['schur_ms'] - before == lib.launched
    before = ek.LAUNCHES['schur_ms']
    ops.apply_window([(0, 0, 40), (1, 8, 20)])
    assert ek.LAUNCHES['schur_ms'] - before == 2 and lib.calls[-1] == 'slabs'
