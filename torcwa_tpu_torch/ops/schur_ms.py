"""Windowed multishift Schur QR with aggressive early deflation for a large
Hessenberg matrix, or a batch of them, each on its own: H = Z T Z^H.

Counterpart of ``torcwa_tpu/ops/eig_qr_hbm.py`` (``schur_qr_hbm``).  The
sweep loop runs here on the host, once for both versions, over the lanes
of a batch (its matrices) in lock step: each lane keeps its own active
block, stall count, budget and decisions, and each step of a sweep is one
launch over the lanes that take it (:func:`_sweeps`).  A lane's steps:

* the band scan gives the active block [lo, hi];
* AED on the trailing window of at most ``kw`` rows deflates what it can
  and yields the sweep's ``m`` shifts; its transform is applied to the
  off-diagonal slabs of H and to Z only when it deflated something;
  with ``aed=False`` the shifts are the eigenvalues of the trailing m x m
  block instead (:func:`trailing_shifts_plain`, ``ms_trailing_shifts`` on
  the card; ``schur_qr_ms.py`` takes its shifts by the same function),
  nothing deflates beyond the band scan and no chase is skipped;
* the nibble rule skips the chase when AED alone deflated more than
  ``nibble`` percent of its window and the sweep is not exceptional;
* otherwise ``m`` spacing-2 bulges are chased through overlapping windows
  of ``wb`` rows (:func:`chase_windows`); the chase rotates the window of H
  and records its rotations, from which the window's unitary U is formed
  after the last step (:func:`window_unitary_plain`, in the same launch on
  the card), U then being applied to the slabs right of and above the
  window and to Z;
* 13 sweeps without progress make the next sweep exceptional.

:class:`_CudaOps` launches the functions of ``csrc/schur_ms.cu``, one block
(or one lane's slab strips) a lane, and reads five integers a lane back per
sweep, in one read for the batch (the AED window QR's rotations stay on
the card, summed, for the ``eig.schur`` span's ``aed_rotations`` counter);
:class:`_PlainOps` is the plain PyTorch version of the same steps,
rotation by rotation, in the input's precision, lane by lane.  Convention
in both: plain Q and plain Z (no conjugated accumulators, no transposed
storage); a rotation G = [[c, s], [-conj(s), c]] acts on rows k, k+1 from
the left and G^H on columns k, k+1 from the right.
"""

import ctypes

import torch

from ..utils import timing
from . import _build
from .eig_kernels import (LAUNCHES, _consts, _givens, _raise_on, _stream,
                          _wilkinson)

__all__ = ['schur_ms', 'schur_ms_plain', 'run_sweeps', 'window',
           'chase_windows', 'ms_chase', 'ms_apply_window',
           'ms_apply_window_plain', 'trailing_shifts_plain',
           'band_scan_plain', 'chase_plain', 'window_unitary_plain',
           'aed_plain', 'AED_KW', 'NIBBLE', 'EXC_STALL']

AED_KW = 64          # AED window (eig_qr_hbm._AED_KW)
NIBBLE = 14          # percent of the window (eig_qr_hbm._NIBBLE)
EXC_STALL = 13       # sweeps without progress before an exceptional sweep
MAX_ITER_FACTOR = 40
ALIGN = 64           # window starts and the window advance are multiples of it
# limits compiled into csrc/schur_ms.cu
_MAX_M, _MAX_KW, _MAX_WB = 64, 64, 256
# its info record: I_ROT, the AED window QR's rotations summed over the
# launches, and I_COUNT, the record's length
_I_ROT, _I_COUNT = 8, 9


def _overlap(m):
    """Rows two successive windows share: the trailing bulge of a resumed
    chase (row tcur - 2(m-1)) and the column left of it lie inside the next
    window."""
    return -(-(2 * m + 1) // ALIGN) * ALIGN


def window(m):
    """Default chase window for m shifts: the narrowest that advances by
    ``ALIGN`` rows (128 for m = 24, 192 for m = 32).  The JAX package takes
    wb = 256 advancing by 128; on an H100 the narrower window halves both
    the rotated row length of the chase and the slab products' operations
    and fits in shared memory (PERF.md)."""
    return _overlap(m) + ALIGN


def max_sweeps(n, m, max_iter_factor=MAX_ITER_FACTOR):
    return (max_iter_factor * n) // m + 8 * m + 40


def chase_windows(n, lo, hi, m, wb):
    """The chase windows of one sweep on the active block [lo, hi], in
    order: (a, wbe, tcur, t_end), the window's first row and its rows, the
    first and last step chased in it.  Windows start at multiples of
    ``ALIGN`` and advance by wb less the overlap m bulges need; the last
    one reaches row n - 1 and ends the chase."""
    t_final = hi - 1 + 2 * (m - 1)
    a = (max(lo - 2 * (m - 1), 0) // ALIGN) * ALIGN
    tcur = lo
    while tcur <= t_final:
        last = a + wb >= n
        wbe = n - a if last else wb
        t_end = t_final if last else min(a + wb - 3, t_final)
        yield a, wbe, tcur, t_end
        a += wb - _overlap(m)
        tcur = t_end + 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _givens_scalar(x, y):
    """eig_kernels._givens on two Python complex numbers: the 2 x 2
    rotation G = [[c, s], [-conj(s), c]] with G [x; y] = [r; 0]."""
    ax2, ay2 = abs(x) ** 2, abs(y) ** 2
    dn, ax = (ax2 + ay2) ** 0.5, ax2 ** 0.5
    if ax2 == 0 and ay2 > 0:
        c, s = 0., 1. + 0j
    elif ax > 0 and dn > 0:
        c, s = ax / dn, x * y.conjugate() / (ax * dn)
    else:
        c, s = 1., 0j
    return [[c, s], [-s.conjugate(), c]]


def _mini_schur(W, budget, vectors=True):
    """Single-shift Schur form of a small Hessenberg W with accumulated
    Qm, T = Qm W Qm^H (eig_qr_hbm._mini_schur; without ``vectors``
    eig_qr_pallas_ms._mini_eigvals, Qm staying the identity).  Returns (T,
    Qm, hi_m, iterations, rotations); lanes >= hi_m of T are converged
    eigenvalues."""
    W = W.clone()
    kw = W.shape[-1]
    eps, smlnum = _consts(W.dtype)
    Qm = torch.eye(kw, dtype=W.dtype)
    hi, it, rot = kw - 1, 0, 0
    true = torch.ones((), dtype=torch.bool)
    while True:
        d = torch.diagonal(W).abs()
        sub = torch.diagonal(W, -1)
        th = torch.clamp(eps * (d[:-1] + d[1:]), min=smlnum)
        alive = ((sub.real ** 2 + sub.imag ** 2) > th * th).tolist()
        while hi > 0 and not alive[hi - 1]:
            hi -= 1
        if hi <= 0 or it >= budget:
            break
        lo = hi
        while lo > 0 and alive[lo - 1]:
            lo -= 1
        a, b, c_, d_ = W[hi - 1, hi - 1], W[hi - 1, hi], W[hi, hi - 1], W[hi, hi]
        sh = _wilkinson(a, b, c_, d_, true)
        if it % 13 == 12:
            sh = torch.complex(d_.real + 0.75 * c_.abs(), d_.imag)
        x, y = complex(W[lo, lo] - sh), complex(W[lo + 1, lo])
        for k in range(lo, hi):
            G = torch.tensor(_givens_scalar(x, y), dtype=W.dtype)
            j0, i1 = max(k - 1, 0), min(k + 2, hi) + 1
            W[k:k + 2, j0:] = G @ W[k:k + 2, j0:]
            if k > lo:
                W[k + 1, k - 1] = 0
            if vectors:
                Qm[k:k + 2] = G @ Qm[k:k + 2]
            W[:i1, k:k + 2] = W[:i1, k:k + 2] @ G.mH
            x = complex(W[k + 1, k])
            y = complex(W[k + 2, k]) if k + 2 <= hi else 0j
        it += 1
        rot += hi - lo
    return W, Qm, hi, it, rot


def band_scan_plain(H, hi_top, mult):
    """The active block (lo, hi) at or above row ``hi_top``: the bottom-most
    run of subdiagonals with |h| > max(mult eps (|d| + |d'|), smlnum);
    (0, 0) when none is left."""
    eps, smlnum = _consts(H.dtype)
    dg = torch.diagonal(H).abs()
    sub = torch.diagonal(H, -1)
    th = torch.clamp(mult * eps * (dg[:-1] + dg[1:]), min=smlnum)
    alive = ((sub.real ** 2 + sub.imag ** 2) > th * th).tolist()
    hi = hi_top
    while hi > 0 and not alive[hi - 1]:
        hi -= 1
    if hi <= 0:
        return 0, 0
    lo = hi
    while lo > 0 and alive[lo - 1]:
        lo -= 1
    return lo, hi


def chase_plain(H, shifts, xs, ys, a, wbe, tcur, t_end, lo, hi, U=None,
                Z=None, rotations=None):
    """Steps tcur..t_end of the chase of m = len(shifts) spacing-2 bulges on
    the active block [lo, hi], inside the diagonal window of ``wbe`` rows at
    ``a`` (the whole matrix: a = 0, wbe = n), in place on H.  Bulge i sits at
    row k = t - 2 i at step t and enters at k = lo with (H[lo,lo] -
    shifts[i], H[lo+1,lo]); (xs, ys) carry each bulge's next rotation source
    and are returned.  The left factors go to the rows of ``U`` (window
    coordinates) when given, the right factors to the columns of ``Z``
    when given; ``rotations``, a list, gets each step's active (k, c, s)
    appended, from which :func:`window_unitary_plain` forms the same U.
    All row rotations of a step, then all column rotations; a row rotation
    covers columns >= max(k - 1, lo) only."""
    m = shifts.shape[0]
    dev = H.device
    Hw = H[:, a:a + wbe]                 # the window's columns, all rows
    ii = torch.arange(m, device=dev)
    valid = lo + 2 * ii + 1 <= hi
    idx = torch.arange(a, a + wbe, device=dev)[None, :]
    for t in range(tcur, t_end + 1):
        ks = t - 2 * ii
        act = valid & (ks >= lo) & (ks < hi)
        if not bool(act.any()):
            continue
        intro = act & (ks == lo)
        xs = torch.where(intro, H[lo, lo] - shifts, xs)
        ys = torch.where(intro, H[lo + 1, lo], ys)
        k = ks[act]
        c, s = _givens(xs[act], ys[act])
        c, s = c[:, None], s[:, None]
        if rotations is not None:
            rotations.append((k, c, s))
        # rows k, k+1: columns >= max(k-1, lo) of the window, and U
        hk, h1 = Hw[k], Hw[k + 1]
        on = idx >= torch.clamp(k - 1, min=lo)[:, None]
        zap = (idx == (k - 1)[:, None]) & (k > lo)[:, None]
        Hw[k] = torch.where(on, c * hk + s * h1, hk)
        n1 = torch.where(on, c * h1 - s.conj() * hk, h1)
        Hw[k + 1] = torch.where(zap, torch.zeros_like(n1), n1)
        if U is not None:
            _rotate_rows(U, k - a, c, s)
        # columns k, k+1: the window's rows up to min(k+2, hi)
        cl, cr = H[a:a + wbe, k].T, H[a:a + wbe, k + 1].T
        on = idx <= torch.clamp(k + 2, max=hi)[:, None]
        H[a:a + wbe, k] = torch.where(on, c * cl + s.conj() * cr, cl).T
        H[a:a + wbe, k + 1] = torch.where(on, c * cr - s * cl, cr).T
        if Z is not None:
            zl, zr = Z[:, k].T, Z[:, k + 1].T
            Z[:, k] = (c * zl + s.conj() * zr).T
            Z[:, k + 1] = (c * zr - s * zl).T
        xs[act] = H[k + 1, k]          # xs, ys are this step's own copies
        k2 = torch.clamp(k + 2, max=hi)
        ys[act] = torch.where(k + 2 <= hi, H[k2, k],
                              torch.zeros_like(xs[act]))
    return xs, ys


def _rotate_rows(U, r, c, s):
    uk, u1 = U[r], U[r + 1]
    U[r] = c * uk + s * u1
    U[r + 1] = c * u1 - s.conj() * uk


def window_unitary_plain(rotations, a, wbe, dtype, device):
    """The window's accumulated unitary (wbe x wbe, window coordinates)
    from the rotations :func:`chase_plain` recorded in a window at row
    ``a``: the identity with each step's row rotations applied in order,
    the same operations the chase applies when it carries U."""
    U = torch.eye(wbe, dtype=dtype, device=device)
    for k, c, s in rotations:
        _rotate_rows(U, k - a, c, s)
    return U


def _chase_window_plain(H, shifts, xs, ys, a, wbe, tcur, t_end, lo, hi):
    """The plain version of the ms_chase kernel: :func:`chase_plain` on H
    recording its rotations, then U from them.  Returns (xs, ys, U)."""
    rotations = []
    xs, ys = chase_plain(H, shifts, xs, ys, a, wbe, tcur, t_end, lo, hi,
                         rotations=rotations)
    return xs, ys, window_unitary_plain(rotations, a, wbe, H.dtype, H.device)


def trailing_shifts_plain(H, lo, hi, m, exc=False):
    """The m shifts of a sweep on the active block [lo, hi] of H
    (eig_qr_pallas_ms._kernel_ms's shift choice, csrc/ms_shifts.cuh on the
    card): the eigenvalues of the trailing block from base = max(hi - (m -
    1), lo) to hi by a single-shift QR of at most 6 m iterations, ordered by
    distance to H[hi, hi] (ties in index order), the m - (hi - base + 1)
    padding lanes, value 0, last.  On an exceptional sweep shift i is the
    diagonal entry at pos = min(base + i, hi) with 0.75 |H[pos + 1, pos]|
    added to its real part (nothing at pos = hi).  The block is worked on
    the CPU in H's precision; the shifts come back on H's device."""
    base = max(hi - (m - 1), lo)
    L = hi - base + 1
    blk = H[base:hi + 1, base:hi + 1].cpu()
    if exc:
        pos = torch.clamp(torch.arange(m), max=L - 1)
        d = torch.diagonal(blk)[pos]
        sub = torch.cat([torch.diagonal(blk, -1).abs(),
                         torch.zeros(1, dtype=d.real.dtype)])[pos]
        return torch.complex(d.real + 0.75 * sub, d.imag).to(H.device)
    ev = torch.diagonal(_mini_schur(blk, 6 * m, vectors=False)[0])
    dist = (ev - blk[-1, -1]).abs() ** 2
    order = torch.sort(dist, stable=True).indices
    sh = torch.cat([ev[order], torch.zeros(m - L, dtype=H.dtype)])
    return sh.to(H.device)


def aed_plain(H, lo, hi, m, kw, mult, exc, uncut_scale=False):
    """Aggressive early deflation on the trailing window of the active block
    [lo, hi] (hi > 0) of H, in place: the plain version of
    ``aed_window_warp`` in ``csrc/aed_warp.cuh``.  The window of kwe <= kw
    rows from s = max(hi - kw + 1, lo + 1) is worked on the CPU in H's
    precision: its single-shift Schur form, the spike, the bottom run of
    converged lanes with |spike_i| <= mult eps max(|T_ii|, max|W|)
    deflated (max|W| over the kw rows and columns from s when
    ``uncut_scale``, as the batched kernel's uncut window sees it, else over
    the cut window), the m shifts, the Householder reduction back to
    Hessenberg form.  Where it deflates, the window's own block and spike
    column of H are overwritten with the known zeros exact; the off-window
    slabs are the caller's.  Returns (s, kwe, hi_new, shifts (m,), P (kwe,
    kwe)), shifts and P on H's device."""
    eps, smlnum = _consts(H.dtype)
    s = max(hi - kw + 1, lo + 1)
    kwe = hi - s + 1
    W = H[s:s + kwe, s:s + kwe].cpu()
    beta = H[s, s - 1].cpu()
    scale = H[s:s + kw, s:s + kw] if uncut_scale else W
    smax = max(float(scale.abs().max()), smlnum)
    T, Qm, hi_m, _, _ = _mini_schur(W, 3 * kw + 40)
    spike = beta * Qm[:, 0]
    td = torch.diagonal(T)
    lane = torch.arange(kwe)
    defl = ((spike.abs() <= mult * eps * torch.clamp(td.abs(), min=smax))
            & (lane >= hi_m))
    keep = (~defl).nonzero()
    ku = int(keep[-1]) + 1 if keep.numel() else 0
    hi_new = s + ku - 1
    kum1 = max(ku - 1, 0)
    if exc:
        pos = torch.clamp(ku - m + torch.arange(m), 0, kum1)
        sh = torch.complex(td[pos].real + 0.75 * spike[pos].abs(),
                           td[pos].imag)
    else:
        # undeflated lanes by distance to the new corner (ties in index
        # order), then the deflated lanes in index order
        dist = (td - td[kum1]).abs() ** 2
        dist = torch.where(lane < ku, dist,
                           torch.full_like(dist, float('inf')))
        order = torch.sort(dist, stable=True).indices[:m]
        sh = td[order]
        if kwe < m:
            sh = torch.cat([sh, sh[-1:].expand(m - kwe)])
    # bordered matrix [[0, 0], [spike, T]] and L = diag(1, Qm)
    K1 = kwe + 1
    Ap = torch.zeros(K1, K1, dtype=H.dtype)
    Ap[1:, 1:] = T
    Ap[1:, 0] = torch.where(defl, torch.zeros_like(spike), spike)
    L = torch.eye(K1, dtype=H.dtype)
    L[1:, 1:] = Qm
    tiny = 1e-30 if H.dtype == torch.complex64 else 1e-290
    for j in range(ku - 1):
        col = Ap[:, j]
        x1 = col[j + 1]
        sigma = float((col[j + 2:ku + 1].abs() ** 2).sum())
        if not sigma > 0:
            continue
        xn1 = float(x1.abs())
        ph = x1 / xn1 if xn1 > 0 else torch.ones_like(x1)
        normx = (sigma + xn1 * xn1) ** 0.5
        v = torch.zeros(K1, dtype=H.dtype)
        v[j + 2:ku + 1] = col[j + 2:ku + 1]
        v[j + 1] = x1 + ph * normx
        tau = 2. / max(2. * (sigma + xn1 * xn1 + normx * xn1), tiny)
        Ap -= tau * torch.outer(v, v.conj() @ Ap)
        Ap -= tau * torch.outer(Ap @ v, v.conj())
        L -= tau * torch.outer(v, v.conj() @ L)
    if hi_new < hi:
        r = torch.arange(K1)[:, None]
        c = torch.arange(K1)[None, :]
        dead = (c + 2 <= r) | ((c + 1 == r) & (r >= ku + 1))
        Ap = Ap.masked_fill(dead, 0)
        H[s:s + kwe, s - 1:s + kwe] = Ap[1:].to(H.device)
    return s, kwe, hi_new, sh.to(H.device), \
        L[1:, 1:].contiguous().to(H.device)


class _PlainOps:
    """The steps of a sweep in plain PyTorch, in place on the lanes of H
    and Z (B, n, n), one lane after another.  The AED window (at most kw x
    kw) is worked on the CPU, the chase and the slab products where H
    lives."""

    def __init__(self, H, Z, m, kw, wb, defl_mult):
        self.H, self.Z = H, Z
        self.lanes, self.n = H.shape[0], H.shape[-1]
        self.m, self.kw, self.wb, self.defl_mult = m, kw, wb, defl_mult
        self.shifts = [None] * self.lanes
        self.Lp = [None] * self.lanes
        self.U = [None] * self.lanes
        self.xs = self.ys = None

    def scan(self, lanes, hi_tops, excs, aed):
        """Each lane's band scan at or above its hi_top, then its AED (or
        its shifts from the trailing block without ``aed``): (lo, hi, s,
        kwe, hi_new) a lane."""
        one = self._scan_and_aed if aed else self._scan_and_shifts
        return [one(l, hi_top, exc)
                for l, hi_top, exc in zip(lanes, hi_tops, excs)]

    def _scan_and_aed(self, l, hi_top, exc):
        lo, hi = band_scan_plain(self.H[l], hi_top, self.defl_mult)
        if hi <= 0:
            return 0, 0, 0, 0, 0
        s, kwe, hi_new, self.shifts[l], self.Lp[l] = aed_plain(
            self.H[l], lo, hi, self.m, self.kw, self.defl_mult, exc)
        return lo, hi, s, kwe, hi_new

    def _scan_and_shifts(self, l, hi_top, exc):
        lo, hi = band_scan_plain(self.H[l], hi_top, self.defl_mult)
        if hi > 0:
            self.shifts[l] = trailing_shifts_plain(self.H[l], lo, hi, self.m,
                                                   exc)
        return lo, hi, 0, 0, hi

    def apply_aed(self, items):
        for l, s, kwe in items:
            ms_apply_window_plain(self.H[l], self.Z[l], s, kwe, self.Lp[l])

    def start_chase(self):
        self.xs, self.ys = ([torch.zeros(self.m, dtype=self.H.dtype,
                                         device=self.H.device)
                             for _ in range(self.lanes)] for _ in range(2))

    def chase(self, items):
        for l, a, wbe, tcur, t_end, lo, hi in items:
            self.xs[l], self.ys[l], self.U[l] = _chase_window_plain(
                self.H[l], self.shifts[l], self.xs[l], self.ys[l], a, wbe,
                tcur, t_end, lo, hi)

    def apply_window(self, items):
        for l, a, wbe in items:
            ms_apply_window_plain(self.H[l], self.Z[l], a, wbe, self.U[l])


# ---------------------------------------------------------------------------
# CUDA version
# ---------------------------------------------------------------------------

def _launch(name, *args):
    """One call of a C entry point of csrc/schur_ms.cu; LAUNCHES counts the
    kernels it reports, one or, for lanes that need other templates or
    more than 32 lanes, several."""
    made = ctypes.c_int(0)
    err = getattr(_build.load(), name)(*args, ctypes.pointer(made),
                                       _stream())
    _raise_on(name, err)
    LAUNCHES['schur_ms'] += made.value


def _table(rows, buf=None):
    """A launch's lane table for the C entry points: the rows' ints in a
    host array (``buf``, a ctypes int array large enough, when given; the
    C entry point copies the table before it returns), and the number of
    rows."""
    rows = list(rows)
    flat = [v for row in rows for v in row]
    if buf is None:
        buf = (ctypes.c_int * len(flat))()
    buf[:len(flat)] = flat
    return buf, len(rows)


def _chase_call(H, U, us, rows, shifts, xy, buf=None):
    """The chase kernel on H (., n, n): rows of (lane, a, wbe, tcur, t_end,
    lo, hi); a lane's U (wbe x wbe) lies us elements after the one before,
    its shifts (m) and carries xy (2m) in the rows of shifts and xy."""
    _launch('torcwa_ms_chase_c64', H.data_ptr(), H.shape[-1], U.data_ptr(),
            us, *_table(rows, buf), shifts.shape[-1], shifts.data_ptr(),
            xy.data_ptr())


def _slab_call(H, Z, n, P, ps, rows, buf=None):
    """The slab kernel: rows of (lane, a, w, ldp), each the products of
    its lane's transform P (w x w, leading dimension ldp, ps elements after
    the lane before) on H (., n, n) and Z (., nz, n), both row-major with
    their own leading dimension."""
    _launch('torcwa_ms_apply_slabs_c64', H.data_ptr(), H.stride(-2),
            Z.data_ptr(), Z.stride(-2), n, Z.shape[-2], P.data_ptr(), ps,
            *_table(rows, buf))


def ms_chase(H, shifts, xy, a, wbe, tcur, t_end, lo, hi, U):
    """Steps tcur..t_end of the chase of m = len(shifts) bulges inside the
    window of ``wbe`` rows at ``a``, in place on H; xy (2m,) holds the
    bulges' carries (x then y) in and out, U (wbe, wbe) receives the
    window's unitary.  A CUDA tensor goes through the kernel (one lane),
    which forms U after the last step from the rotations it recorded; a CPU
    tensor through :func:`chase_plain` and :func:`window_unitary_plain`."""
    m = shifts.shape[0]
    if H.device.type == 'cpu':
        xs, ys, Uw = _chase_window_plain(H, shifts, xy[:m].clone(),
                                         xy[m:].clone(), a, wbe, tcur, t_end,
                                         lo, hi)
        U.copy_(Uw)
        xy[:m], xy[m:] = xs, ys
        return H
    if H.device.type != 'cuda':
        raise RuntimeError(f'ms_chase: no kernel for device {H.device.type!r}')
    if any(x.dtype != torch.complex64 for x in (H, shifts, xy, U)):
        raise TypeError('ms_chase: the CUDA kernel takes complex64 only')
    if not all(x.is_contiguous() and x.device == H.device
               for x in (H, shifts, xy, U)) or U.shape != (wbe, wbe) \
            or xy.shape != (2 * m,):
        raise ValueError('ms_chase: expected contiguous H, shifts (m,), xy '
                         '(2m,) and U (wbe, wbe) on one device')
    _chase_call(H, U, 0, [(0, a, wbe, tcur, t_end, lo, hi)], shifts, xy)
    return H


def _check_slab(X, P):
    name = 'ms_apply_window'
    if X.device.type != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {X.device.type!r}')
    if X.dtype != torch.complex64 or P.dtype != torch.complex64:
        raise TypeError(f'{name}: the CUDA kernel takes complex64 only')
    if X.dim() != 2 or P.dim() != 2 or P.shape[0] != P.shape[1] \
            or X.stride(1) != 1 or P.stride(1) != 1 or P.device != X.device:
        raise ValueError(f'{name}: expected row-major 2-D tensors on one '
                         'device')
    if P.shape[0] > _MAX_WB:
        raise ValueError(f'{name}: transform order {P.shape[0]} > {_MAX_WB}')


def ms_apply_window_plain(H, Z, a, w, P):
    """The three slab products of a window's (or an AED window's) unitary P
    (w x w) at row a, in place: P H[a:a+w, a+w:], H[:a, a:a+w] P^H and
    Z[:, a:a+w] P^H, in that order."""
    e = a + w
    H[a:e, e:] = P @ H[a:e, e:]
    H[:a, a:e] = H[:a, a:e] @ P.mH
    Z[:, a:e] = Z[:, a:e] @ P.mH
    return H, Z


def ms_apply_window(H, Z, a, w, P):
    """:func:`ms_apply_window_plain` as one launch of the register-tiled
    slab kernel for CUDA tensors (the three products touch disjoint parts
    of H and Z); the plain version on the CPU."""
    if P.shape != (w, w):
        raise ValueError(f'ms_apply_window: P must be {w} x {w}')
    if H.device.type == 'cpu':
        return ms_apply_window_plain(H, Z, a, w, P)
    n = H.shape[-1]
    for X in (H, Z):
        _check_slab(X, P)
    if H.shape != (n, n) or Z.shape[1] != n or Z.device != H.device \
            or not 0 <= a <= n - w:
        raise ValueError('ms_apply_window: expected H (n, n), Z (., n) and '
                         'a window inside H')
    if a + w < n or a > 0 or Z.shape[0] > 0:
        _slab_call(H, Z, n, P, 0, [(0, a, w, P.stride(0))])
    return H, Z


class _CudaOps:
    """The steps of a sweep through csrc/schur_ms.cu, in place on the lanes
    of H and Z (B, n, n), one launch a step over the lanes that take it.
    Each lane's scratch (the AED transform, the window unitary, shifts,
    bulge carries, the info record) is allocated here once; nothing is
    allocated in C."""

    def __init__(self, H, Z, m, kw, wb, defl_mult):
        if m > _MAX_M or kw > _MAX_KW or wb > _MAX_WB:
            raise ValueError(f'schur_ms: the CUDA kernels take m <= {_MAX_M},'
                             f' kw <= {_MAX_KW}, wb <= {_MAX_WB}')
        self.H, self.Z = H, Z
        self.lanes, self.n = H.shape[0], H.shape[-1]
        self.m, self.kw, self.wb, self.defl_mult = m, kw, wb, defl_mult
        dev, B = H.device, self.lanes
        self.info = torch.zeros(B, _I_COUNT, dtype=torch.int32, device=dev)
        self.Lp = torch.zeros(B, kw * kw, dtype=H.dtype, device=dev)
        self.U = torch.zeros(B, wb * wb, dtype=H.dtype, device=dev)
        self.shifts = torch.zeros(B, m, dtype=H.dtype, device=dev)
        self.xy = torch.zeros(B, 2 * m, dtype=H.dtype, device=dev)
        self.buf = (ctypes.c_int * (7 * B))()      # the launches' lane tables

    def scan(self, lanes, hi_tops, excs, aed):
        """One band scan launch and one AED (or, without ``aed``, trailing
        shifts) launch over the lanes, then one read of their info records:
        (lo, hi, s, kwe, hi_new) a lane."""
        H, n = self.H, self.n
        _launch('torcwa_ms_band_scan_c64', H.data_ptr(), n,
                *_table(zip(lanes, hi_tops), self.buf), self.defl_mult,
                self.info.data_ptr())
        excs = _table(zip(lanes, excs), self.buf)
        if aed:
            _launch('torcwa_ms_aed_c64', H.data_ptr(), n,
                    self.info.data_ptr(), *excs, self.m, self.kw,
                    self.defl_mult, self.Lp.data_ptr(),
                    self.shifts.data_ptr())
        else:
            _launch('torcwa_ms_trailing_shifts_c64', H.data_ptr(), n,
                    self.info.data_ptr(), *excs, self.m,
                    self.shifts.data_ptr())
        rows = self.info.tolist()        # whole: one copy, no gather kernel
        return [rows[l][:5] for l in lanes]

    @property
    def aed_rotations(self):
        """The AED window QR's rotations so far, summed over the lanes, a
        0-d tensor on the card."""
        return self.info[:, _I_ROT].sum()

    def apply_aed(self, items):
        self._slabs(self.Lp, self.kw * self.kw,
                    [(l, s, kwe, kwe) for l, s, kwe in items])

    def start_chase(self):
        self.xy.zero_()

    def chase(self, items):
        _chase_call(self.H, self.U, self.wb * self.wb, items, self.shifts,
                    self.xy, self.buf)

    def apply_window(self, items):
        self._slabs(self.U, self.wb * self.wb,
                    [(l, a, wbe, wbe) for l, a, wbe in items])

    def _slabs(self, P, ps, rows):
        """The slab products of each lane's transform in P (lane stride
        ps): rows of (lane, a, w, ldp)."""
        _slab_call(self.H, self.Z, self.n, P, ps, rows, self.buf)


# ---------------------------------------------------------------------------
# the sweep loop
# ---------------------------------------------------------------------------

# real floating-point operations of one complex multiply-add, and of one
# rotated element pair (two outputs, each a real and a complex product)
_CFMA, _PAIR = 8, 20


def _sweeps(ops, n, m, kw, wb, budget, nibble, aed=True):
    """Run sweeps on every lane of ``ops`` in lock step until each lane's
    active block closes or its budget runs out.  Returns (stats, steps):
    for each lane (hi, sweeps, aed_deflated, skipped_chases, flops_done,
    flops_needed), and the sweeps of the loop, one host read each.

    A sweep of the loop takes every live lane through the same steps, one
    launch a step over the lanes that take it: the band scan and the AED
    (one read of the lanes' results), the AED transforms where they
    deflated, then chase window j of every lane that chases and has one,
    with its slab products, for j = 0, 1, ...  Each lane's decisions (its
    active block, exceptional sweeps, the nibble rule, its budget) are its
    own, so a lane's arithmetic is what it would be alone.

    flops_done counts this implementation's work: the slab products
    exactly (overlapping windows included), a chase rotation as 2 wb
    element pairs (half a window row of H, a row of U, half a window
    column), an AED window as 100 kwe^3.  flops_needed is the least
    arithmetic that carries out the same sweeps whatever the windowing:
    every chase rotation applied directly to its 2n element pairs (a row
    pair and a column pair of H, a column pair of Z), and every applied AED
    transform as one dense kwe x kwe product with its 2n - kwe slab
    columns and rows.  Without ``aed`` the shifts come from the trailing
    m x m block, nothing deflates beyond the band scan and every sweep
    chases."""
    B = ops.lanes
    hi_top = [n - 1] * B
    it, stall, aed_tot, skip_tot, flops, need = ([0] * B for _ in range(6))
    live = [l for l in range(B) if hi_top[l] > 0 and budget > 0]
    steps = 0
    while live:
        excs = [stall[l] >= EXC_STALL for l in live]
        found = ops.scan(live, [hi_top[l] for l in live], excs, aed)
        steps += 1
        applied, chases = [], []
        for l, exc, (lo, hi_band, s, kwe, hi) in zip(live, excs, found):
            it[l] += 1
            if hi_band <= 0:
                hi_top[l] = 0
                continue
            flops[l] += 100 * kwe ** 3
            if hi < hi_band:
                applied.append((l, s, kwe))
                flops[l] += _CFMA * kwe * kwe * ((n - s - kwe) + s + n)
                need[l] += _CFMA * kwe * kwe * ((n - s - kwe) + s + n)
            nibbled = (hi_band - hi) * 100 > nibble * max(kwe, 1) and not exc
            if hi > lo and not nibbled:
                chases.append((l, lo, hi, chase_windows(n, lo, hi, m, wb)))
                bulges = min(m, (hi - lo - 1) // 2 + 1)
                flops[l] += _PAIR * 2 * wb * bulges * (hi - lo)
                need[l] += _PAIR * 2 * n * bulges * (hi - lo)
            stall[l] = 0 if (hi < hi_top[l] or exc) else stall[l] + 1
            aed_tot[l] += hi_band - hi
            skip_tot[l] += int(nibbled)
            hi_top[l] = hi
        if applied:
            ops.apply_aed(applied)
        if chases:
            ops.start_chase()
        while chases:
            # window j of every lane that still has one
            step, left = [], []
            for l, lo, hi, windows in chases:
                w = next(windows, None)
                if w is not None:
                    step.append((l, *w, lo, hi))
                    left.append((l, lo, hi, windows))
            chases = left
            if step:
                ops.chase(step)
                ops.apply_window([(l, a, wbe) for l, a, wbe, *_ in step])
                for l, a, wbe, *_ in step:
                    flops[l] += _CFMA * wbe * wbe * ((n - a - wbe) + a + n)
        live = [l for l in live if hi_top[l] > 0 and it[l] < budget]
    stats = list(zip(hi_top, it, aed_tot, skip_tot, flops, need))
    return stats, steps


def _check_args(H, Q, m, kw, wb, aed):
    if H.dim() not in (2, 3) or H.shape[-1] != H.shape[-2] \
            or H.shape != Q.shape or not H.is_complex() \
            or H.dtype != Q.dtype or H.device != Q.device:
        raise ValueError('schur_ms: expected two complex (n, n) or (B, n, n) '
                         'arrays of one type on one device')
    if wb <= _overlap(m):
        raise ValueError(f'window {wb} too small for {m} bulges '
                         f'(stride {wb - _overlap(m)} <= 0)')
    if aed and m > kw:
        raise ValueError(f'm={m} shifts need an AED window kw >= m '
                         f'(got {kw})')


def _lanes(X):
    """X as a batch: (n, n) -> (1, n, n), a view."""
    return X[None] if X.dim() == 2 else X


def run_sweeps(H, Z, budget, plain=False, m=24, kw=AED_KW, wb=None,
               defl_mult=4.0, nibble=NIBBLE, aed=True):
    """At most ``budget`` sweeps in place on H and Z, (n, n) or (B, n, n)
    with the lanes in lock step: the kernels for CUDA tensors, the plain
    version for CPU tensors or when ``plain``.  Returns the stats of
    :func:`_sweeps`, a list of one tuple a lane for a batch; H stays a
    unitary similarity of its input, upper Hessenberg with the rows below
    hi triangular."""
    wb = window(m) if wb is None else wb
    stats, _ = _sweeps(_ops(_lanes(H), _lanes(Z), plain, m, kw, wb,
                            defl_mult), H.shape[-1], m, kw, wb, budget,
                       nibble, aed)
    return stats[0] if H.dim() == 2 else stats


def _ops(H, Z, plain, m, kw, wb, defl_mult):
    """The steps of a sweep on the lanes of H and Z (B, n, n): the kernels
    for CUDA tensors, the plain version for CPU tensors or when
    ``plain``."""
    if not plain and H.device.type != 'cpu':
        if H.device.type != 'cuda':
            raise RuntimeError(f'schur_ms: no kernel for device '
                               f'{H.device.type!r}')
        if H.dtype != torch.complex64:
            raise TypeError(f'schur_ms: the CUDA kernels take complex64 only '
                            f'(got {H.dtype}); float64 kernels are still to '
                            f'be ported')
        if not (H.is_contiguous() and Z.is_contiguous()):
            raise ValueError('schur_ms: H and Z must be contiguous')
        return _CudaOps(H, Z, m, kw, wb, defl_mult)
    return _PlainOps(H, Z, m, kw, wb, defl_mult)


def _finish(H, Z, stats, return_stats, one):
    """T = triu(H), NaN on the diagonal of each lane that did not converge;
    the first lane alone when ``one``."""
    T = torch.triu(H)
    for l, st in enumerate(stats):
        if st[0] > 0:
            T[l].diagonal().fill_(float('nan'))
    if one:
        T, Z, stats = T[0], Z[0], stats[0]
    if return_stats:
        return T, Z, stats
    return T, Z


def schur_ms_plain(H, Q, m=24, kw=AED_KW, wb=None, defl_mult=4.0,
                   max_iter_factor=MAX_ITER_FACTOR, nibble=NIBBLE, aed=True,
                   budget=None, return_stats=False):
    """The plain PyTorch version of :func:`schur_ms` (same arguments)."""
    wb = window(m) if wb is None else wb
    _check_args(H, Q, m, kw, wb, aed)
    n = H.shape[-1]
    H3, Z3 = _lanes(H).clone(), _lanes(Q).clone()
    if budget is None:
        budget = max_sweeps(n, m, max_iter_factor)
    stats, _ = _sweeps(_PlainOps(H3, Z3, m, kw, wb, defl_mult), n, m, kw, wb,
                       budget, nibble, aed)
    return _finish(H3, Z3, stats, return_stats, H.dim() == 2)


def schur_ms(H, Q, m=24, kw=AED_KW, wb=None, defl_mult=4.0,
             max_iter_factor=MAX_ITER_FACTOR, nibble=NIBBLE, aed=True,
             budget=None, return_stats=False):
    """Schur form of a Hessenberg H with its Q: (T, Z), H = Z T Z^H; or of
    a batch (B, n, n) of them, each matrix on its own, the lanes through
    each sweep in lock step (:func:`_sweeps`).

    ``budget`` sweeps at most a lane (default ``(max_iter_factor n) // m +
    8 m + 40``); when it runs out the lane's eigenvalues (the diagonal of T)
    are NaN.  With ``return_stats`` also returns (hi, sweeps, AED-deflated,
    skipped chases, flops done, flops needed), a list of one a lane for a
    batch, hi == 0 meaning converged (see :func:`_sweeps` for the two
    counts).  ``wb`` is the chase window, by default :func:`window` of m;
    windows start at multiples of ``ALIGN`` and advance by wb less the
    overlap m bulges need.  ``aed=False`` takes the sweep's shifts from the
    trailing m x m block instead of the AED window (eig_qr_hbm.py's
    aed=False branch).  A CUDA tensor goes through the kernels of
    ``csrc/schur_ms.cu`` (complex64 only), a CPU tensor through the plain
    version.  The ``eig.schur`` span counts the lanes' sweeps added
    together (``sweeps``), the lanes (``matrices``) and the loop's sweeps
    (``lockstep_sweeps``, one host read each)."""
    wb = window(m) if wb is None else wb
    _check_args(H, Q, m, kw, wb, aed)
    n = H.shape[-1]
    with timing.span('eig.schur') as sp:
        H3, Z3 = _lanes(H).contiguous().clone(), _lanes(Q).contiguous().clone()
        if budget is None:
            budget = max_sweeps(n, m, max_iter_factor)
        ops = _ops(H3, Z3, False, m, kw, wb, defl_mult)
        stats, steps = _sweeps(ops, n, m, kw, wb, budget, nibble, aed)
        if sp is not None:
            sp.count('sweeps', sum(st[1] for st in stats))
            sp.count('matrices', len(stats))
            sp.count('lockstep_sweeps', steps)
            if aed and isinstance(ops, _CudaOps):
                sp.count('aed_rotations', ops.aed_rotations)
        return _finish(H3, Z3, stats, return_stats, H.dim() == 2)
