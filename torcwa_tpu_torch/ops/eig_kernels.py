"""The batched eig kernels of the small-n route, their plain versions, and
the launch counts of every kernel of the port.

Counterpart of the batched kernels of ``torcwa_tpu/ops/eig_qr_pallas.py``
(the large-n route is in ``hess_blocked.py``, ``schur_ms.py`` and
``vec_blocked.py``, the one-launch multishift QR in ``schur_qr_ms.py``, the
batched AED multishift QR in ``schur_qr_baed.py``, the packed-layout
single-shift QR in ``schur_qr_packed.py``).
:func:`schur_qr_v2` is the stand-alone "v2" single-shift QR
(``schur_qr_pallas[_batched]``): the function of :func:`schur_qr` under
other rules, on no route of ``eig_qr``.  Each stage has

* a wrapper (:func:`hessenberg`, :func:`schur_qr`, :func:`schur_qr_v2`,
  :func:`tri_vectors`) that launches the CUDA kernel in ``csrc/`` for a CUDA tensor and raises
  for anything the kernel does not take, and uses the plain version only
  for a tensor that lies on the CPU;
* a plain PyTorch version (``*_plain``) with the same rules, batched over
  the leading dimension, in the input's precision (float32 or float64
  eps), which the CPU tests hold against the Pallas kernels;
* a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else.

All arrays are (B, n, n) complex, row-major.
"""

import ctypes

import torch

from ..utils import timing
from . import _build

__all__ = ['hessenberg', 'hessenberg_cluster', 'hessenberg_cluster_info',
           'schur_qr', 'schur_qr_v2', 'tri_vectors', 'tri_vectors_slots',
           'hessenberg_plain', 'schur_qr_plain', 'schur_qr_v2_plain',
           'tri_vectors_plain', 'LAUNCHES', 'reset_launch_counts']

# TPU-kernel defaults (eig_qr_pallas.py: _CPLX_STALL, _NRUNS, _DEFL_MULT);
# csrc/schur_qr.cu compiles in the same values
CPLX_STALL = 30
NRUNS = 4
DEFL_MULT = 4.0
EXC_EVERY = 13
MAX_ITER_FACTOR = 40
ACC_RULES = dict(nruns=NRUNS, defl_mult=DEFL_MULT, cplx_stall=CPLX_STALL)
# the v2 kernel's rules (eig_qr_pallas._kernel): one window per lane,
# deflation multiplier 1, the complex Wilkinson branch always open
V2_RULES = dict(nruns=1, defl_mult=1., cplx_stall=0)
# rows of a chase window of csrc/schur_qr.cu (its kW): the window at which
# the plain model of its schedule follows the kernel
WINDOW = 32

# 'hess_panel' counts one per panel of hessenberg_blocked (csrc/
# hess_panel.cu, the panel's column loop), 'schur_ms' every launch of a
# function of csrc/schur_ms.cu (band scan, AED or trailing-block shifts,
# chase, slab products), 'tri_vectors_blocked' one per row block,
# 'schur_qr_ms' one per matrix, 'schur_qr_baed' and 'schur_qr_packed' one
# per batch; their wrappers live in ops/hess_blocked.py, ops/schur_ms.py,
# ops/vec_blocked.py, ops/schur_qr_ms.py, ops/schur_qr_baed.py and
# ops/schur_qr_packed.py
LAUNCHES = {'hessenberg': 0, 'schur_qr': 0, 'tri_vectors': 0,
            'hess_panel': 0, 'schur_ms': 0, 'tri_vectors_blocked': 0,
            'schur_qr_v2': 0, 'schur_qr_ms': 0, 'schur_qr_baed': 0,
            'schur_qr_packed': 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _consts(dtype):
    if dtype in (torch.complex64, torch.float32):
        return 1.1920929e-07, 1e-31
    return 2.220446049250313e-16, 1e-291


def _check(name, *ts):
    for t in ts:
        if t.dim() != 3 or t.shape[-1] != t.shape[-2]:
            raise ValueError(f'{name}: expected (B, n, n), got '
                             f'{tuple(t.shape)}')
        if not t.is_complex():
            raise TypeError(f'{name}: expected a complex tensor, got '
                            f'{t.dtype}')
        if t.shape != ts[0].shape or t.device != ts[0].device:
            raise ValueError(f'{name}: inputs differ in shape or device')
    dev = ts[0].device.type
    if dev == 'cpu':
        return False
    if dev != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {dev!r}')
    for t in ts:
        if t.dtype != torch.complex64:
            raise TypeError(f'{name}: the CUDA kernel takes complex64 only '
                            f'(got {t.dtype}); float64 kernels are still '
                            f'to be ported')
        if not t.is_contiguous():
            raise ValueError(f'{name}: input must be contiguous')
    return True


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')


# ---------------------------------------------------------------------------
# Hessenberg reduction
# ---------------------------------------------------------------------------

# csrc/hessenberg.cu reduces each matrix on one thread-block cluster of P
# CTAs where a CTA's shared memory holds its columns of H: ceil(n / P)
# columns of n entries, the reflectors v of the last four steps (Q's rows
# take them four at a time) with their beta, and the partial sums of u, 8
# bytes an entry, against the 227 KB a block may use.  Its C entry point
# picks P from n, and hessenberg_cluster mirrors the choice: P = CLUSTER
# (8, the portable size) where that fits, n <= 461: an H100 runs 15
# clusters of 8 at once but only 7 of 16, so a batch of 8 at P = 16 takes
# two waves (B = 8, n = 338: 2.79-2.82 ms at P = 8, 5.37-5.48 at P = 16 on
# an NVIDIA H100 80GB HBM3 at 700 W, qr_compare.py --stage hessenberg of
# d655315, which could force P).
# Else P = CLUSTER_WIDE (16, the largest an H100 takes) up to
# CLUSTER_MAX_N (640); larger n takes the one-block kernel (P = 0).
CLUSTER = 8
CLUSTER_WIDE = 16
SMEM_PER_BLOCK = 232448


def cluster_smem_bytes(n, p):
    """Shared memory of one CTA of the cluster kernel."""
    return 8 * (-(-n // p) * n + 5 * n + 4)


CLUSTER_MAX_N = max(n for n in range(1, 4096)
                    if cluster_smem_bytes(n, CLUSTER_WIDE) <= SMEM_PER_BLOCK)


def hessenberg_cluster(n):
    """The cluster size the kernel takes at n: :data:`CLUSTER` where its
    columns of H fit, else :data:`CLUSTER_WIDE` where they fit, else 0
    (the one-block kernel)."""
    for p in (CLUSTER, CLUSTER_WIDE):
        if cluster_smem_bytes(n, p) <= SMEM_PER_BLOCK:
            return p
    return 0


def hessenberg_cluster_info(n):
    """The kernel :func:`hessenberg` launches at n on this card, as its C
    entry point reports it: dict(cluster, smem_bytes, active_clusters),
    active_clusters from cudaOccupancyMaxActiveClusters; None where n
    takes the one-block kernel."""
    out = (ctypes.c_int * 3)()
    _raise_on('hessenberg_cluster_info',
              _build.load().torcwa_hessenberg_cluster_info(n, out))
    if not out[0]:
        return None
    return dict(cluster=out[0], smem_bytes=out[1], active_clusters=out[2])


def hessenberg_plain(A, cluster=None):
    """Householder reduction A = Q H Q^H, reflector v = x + phase(x_0)
    ||x|| e_1, beta = 2 / ||v||^2 (eig_qr_pallas._kernel_hess).

    With ``cluster`` = P it models the order in which the cluster kernel
    sums u = beta H v: rank r's partial sum over its columns j = r mod P
    right of k, the P partials added in rank order."""
    B, n = A.shape[0], A.shape[-1]
    H = A.clone()
    Q = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n).clone()
    idx = torch.arange(n, device=A.device)
    for k in range(n - 2):
        x = torch.where(idx > k, H[:, :, k], torch.zeros_like(H[:, :, k]))
        alpha = H[:, k + 1, k]
        xnorm = torch.sqrt((x.abs() ** 2).sum(-1))
        aabs = alpha.abs()
        ph = torch.where(aabs > 0, alpha / torch.where(aabs > 0, aabs, 1.),
                         torch.ones_like(alpha))
        v = x.clone()
        v[:, k + 1] = v[:, k + 1] + ph * xnorm
        vnorm2 = (v.abs() ** 2).sum(-1)
        beta = torch.where(vnorm2 > 0,
                           2. / torch.where(vnorm2 > 0, vnorm2, 1.),
                           torch.zeros_like(vnorm2))[:, None]
        w = beta * torch.einsum('bi,bij->bj', v.conj(), H)
        H = H - v[:, :, None] * w[:, None, :]
        if cluster:
            Hv = torch.zeros_like(v)
            for r in range(cluster):
                j = idx[(idx % cluster == r) & (idx > k)]
                Hv = Hv + torch.einsum('bij,bj->bi', H[:, :, j], v[:, j])
            u = beta * Hv
        else:
            u = beta * torch.einsum('bij,bj->bi', H, v)
        H = H - u[:, :, None] * v.conj()[:, None, :]
        uq = beta * torch.einsum('bij,bj->bi', Q, v)
        Q = Q - uq[:, :, None] * v.conj()[:, None, :]
    below = idx[:, None] > idx[None, :] + 1
    return H.masked_fill(below, 0), Q


@timing.spanned('eig.hess')
def hessenberg(A):
    """Batched Hessenberg reduction: (B, n, n) complex -> (H, Q).

    On the card, one cluster of :func:`hessenberg_cluster` (n) CTAs per
    matrix, or one block per matrix where that is 0."""
    if not _check('hessenberg', A):
        return hessenberg_plain(A)
    B, n = A.shape[0], A.shape[-1]
    H = torch.empty_like(A)
    Q = torch.empty_like(A)
    err = _build.load().torcwa_hessenberg_c64(
        A.data_ptr(), H.data_ptr(), Q.data_ptr(), B, n, _stream())
    _raise_on('hessenberg', err)
    LAUNCHES['hessenberg'] += 1
    return H, Q


# ---------------------------------------------------------------------------
# Schur QR
# ---------------------------------------------------------------------------

def _givens(x, y):
    """(c real, s complex) with [[c, s], [-conj(s), c]] [x; y] = [r; 0].

    As csrc/common.cuh forms it: where |x|^2 + |y|^2 falls below 2^-120,
    x and y are first scaled by the power of two that brings their largest
    part into [0.5, 1).  That is exact and keeps the rotation unitary where
    the unscaled squares would near or leave the normal range (there they
    keep a few bits and c^2 + |s|^2 misses 1); elsewhere the rotation is
    the unscaled formula's."""
    mx = torch.maximum(torch.maximum(x.real.abs(), x.imag.abs()),
                       torch.maximum(y.real.abs(), y.imag.abs()))
    tiny = (x.real ** 2 + x.imag ** 2 + (y.real ** 2 + y.imag ** 2)
            < 2. ** -120) & (mx > 0)
    one = torch.ones_like(mx)
    e = torch.where(tiny, -torch.frexp(mx)[1], 0)
    # 2^e in two factors: for mx below 2^-128 it overflows a float32
    f1, f2 = torch.ldexp(one, e // 2), torch.ldexp(one, e - e // 2)
    x, y = x * f1 * f2, y * f1 * f2
    ax2 = x.real ** 2 + x.imag ** 2
    ay2 = y.real ** 2 + y.imag ** 2
    dn = torch.sqrt(ax2 + ay2)
    ax = torch.sqrt(ax2)
    one = torch.ones_like(dn)
    c = torch.where(dn > 0, ax / torch.where(dn > 0, dn, one), one)
    den = torch.where(ax > 0, ax, one) * torch.where(dn > 0, dn, one)
    both = (ax > 0) & (dn > 0)
    zero = torch.zeros_like(dn)
    sr = torch.where(both, (x.real * y.real + x.imag * y.imag) / den, zero)
    si = torch.where(both, (x.imag * y.real - x.real * y.imag) / den, zero)
    swap = (ax2 == 0) & (ay2 > 0)
    c = torch.where(swap, zero, c)
    sr = torch.where(swap, one, sr)
    si = torch.where(swap, zero, si)
    return c, torch.complex(sr, si)


def _wilkinson(a, b, c, d, stalled):
    """Eigenvalue of [[a, b], [c, d]] closest to d; an exactly real
    discriminant takes the complex branch only where ``stalled``."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    cr, ci, dr, di = c.real, c.imag, d.real, d.imag
    trr, tri = ar + dr, ai + di
    detr = (ar * dr - ai * di) - (br * cr - bi * ci)
    deti = (ar * di + ai * dr) - (br * ci + bi * cr)
    qr = (trr * trr - tri * tri) - 4 * detr
    qi = 2 * trr * tri - 4 * deti
    qmag = torch.sqrt(qr * qr + qi * qi)
    dscr = torch.sqrt(torch.clamp((qmag + qr) / 2, min=0.))
    sgn = torch.where((qi != 0) | stalled,
                      torch.where(qi >= 0, 1., -1.).to(qr.dtype),
                      torch.zeros_like(qr))
    dsci = sgn * torch.sqrt(torch.clamp((qmag - qr) / 2, min=0.))
    l1r, l1i = (trr + dscr) / 2, (tri + dsci) / 2
    l2r, l2i = (trr - dscr) / 2, (tri - dsci) / 2
    pick1 = ((l1r - dr) ** 2 + (l1i - di) ** 2
             < (l2r - dr) ** 2 + (l2i - di) ** 2)
    return torch.complex(torch.where(pick1, l1r, l2r),
                         torch.where(pick1, l1i, l2i))


def _rotate(c, s, W):
    """[c u + s v, c v - conj(s) u] for W = [u, v] stacked on dim -2
    (complex, (..., 2, m)), c real and s complex of the batch shape (...).
    The arithmetic is the kernel's, operation by operation, in real
    element-wise operations that round alike at any shape: so every
    schedule that applies the same rotation to an entry gets the same
    bits.  (c v + (-conj(s)) u rounds as c v - conj(s) u: IEEE rounding is
    symmetric in sign.)  A column rotation is ``_rotate(c, s.conj(), ...)``."""
    Wr = torch.view_as_real(W)                          # (..., 2, m, 2)
    X = Wr.flip(-3)                                     # [v, u]
    S = torch.view_as_real(torch.stack([s, -s.conj()], -1))[..., None, :]
    sr, si = S[..., 0], S[..., 1]                       # (..., 2, 1)
    xr, xi = X[..., 0], X[..., 1]
    p = torch.stack([sr * xr - si * xi, sr * xi + si * xr], -1)
    return torch.view_as_complex(c[..., None, None, None] * Wr + p)


def _rotate_rows(c, s, X, k):
    """Rows k, k+1 of X (..., r, m) take the rotation, in place."""
    X[..., k:k + 2, :] = _rotate(c, s, X[..., k:k + 2, :])


def _rotate_cols(c, s, X, k):
    """Columns k, k+1 of X (..., m, r) take the rotation's conjugate
    transpose from the right, in place."""
    cols = X[..., k:k + 2]
    cols.copy_(_rotate(c, s.conj(), cols.transpose(-1, -2))
               .transpose(-1, -2))


def _window_chains(cs, right, above, zcols):
    """The deferred half of a chase window: its rotations ``cs`` in
    ascending k on the slab right of the window (rows k0..k1+1), and on the
    slab above it and Z's columns k0..k1+1 from the right (views, updated
    in place).  The kernel runs the part that the next window does not
    read while it chases that window; no entry's operations change order."""
    for t, (c, s) in enumerate(cs):
        _rotate_rows(c, s, right, t)
        _rotate_cols(c, s, above, t)
        _rotate_cols(c, s, zcols, t)


def _window_run(H, Z, lo, hr, shift, hi, window):
    """One run's bulge chased from ``lo`` to ``hr`` on one lane (H, Z
    (n, n), updated in place) as csrc/schur_qr.cu schedules it: through
    windows of ``window`` rows (rows [a, a + w), columns [a - 1, a + w)),
    each rotation applied there to rows k, k+1 over columns >= k - 1 and to
    columns k, k+1 over rows <= k + 2 and recorded, and the window's
    rotations then applied to the rest by ``_window_chains``.  A window
    stops where the next column update would leave it; the next one starts
    where the bulge sits."""
    n = H.shape[-1]
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    x, y = H[lo, lo] - shift, H[lo + 1, lo]
    a = lo
    while True:
        re = min(a + window, n)
        k1 = hr - 1 if re == n else min(hr - 1, a + window - 3)
        c0 = max(a - 1, 0)
        win = H[a:re, c0:re]
        cs = []
        for k in range(a, k1 + 1):
            c, s = _givens(x, y)
            cs.append((c, s))
            _rotate_rows(c, s, win[:, max(k - 1, 0) - c0:], k - a)
            _rotate_cols(c, s, win[:min(k + 2, n - 1) - a + 1], k - c0)
            x = win[k + 1 - a, k - c0]
            y = (win[k + 2 - a, k - c0] if k + 2 <= min(hi, n - 1)
                 else zero)
        _window_chains(cs, H[a:k1 + 2, re:], H[:a, a:k1 + 2],
                       Z[:, a:k1 + 2])
        if k1 == hr - 1:
            return
        a = k1 + 1


def _single_shift_sweeps(H, Z, max_iters, nruns, defl_mult, cplx_stall,
                         window=None):
    """At most ``max_iters`` implicit single-shift QR sweeps: up to
    ``nruns`` windows a sweep, deflation at ``defl_mult`` eps (|d| + |d'|),
    the complex Wilkinson branch of an exactly real discriminant open after
    ``cplx_stall`` sweeps without progress.  Rotations are applied directly,
    all lanes in step; with ``window`` lane by lane in the schedule of the
    CUDA kernel (``_window_run``), which applies the same rotations.
    Returns (T, Z, hi, sweeps, rotations) per lane."""
    H = H.clone()
    Z = Z.clone()
    B, n = H.shape[0], H.shape[-1]
    dev = H.device
    eps, smlnum = _consts(H.dtype)
    hi = torch.full((B,), n - 1, dtype=torch.long, device=dev)
    stall = torch.zeros(B, dtype=torch.long, device=dev)
    sweeps = torch.zeros(B, dtype=torch.long, device=dev)
    rot = torch.zeros(B, dtype=torch.long, device=dev)
    ar = torch.arange(n, device=dev)
    lane = torch.arange(1, n, device=dev)
    bidx = torch.arange(B, device=dev)
    two_below = ar[:, None] == ar[None, :] + 2
    it = 0
    while it < max_iters and bool((hi > 0).any()):
        sweeps += (hi > 0).long()
        dg = torch.diagonal(H, dim1=-2, dim2=-1)
        sub = torch.diagonal(H, -1, dim1=-2, dim2=-1)          # H[c+1, c]
        sup = torch.diagonal(H, 1, dim1=-2, dim2=-1)           # H[c, c+1]
        d = dg.abs()
        thresh = torch.clamp(defl_mult * eps * (d[:, :-1] + d[:, 1:]),
                             min=smlnum)
        alive = (sub.real ** 2 + sub.imag ** 2) > thresh * thresh
        hi_new = torch.where((lane <= hi[:, None]) & alive, lane,
                             0).amax(-1)
        stall = torch.where(hi_new < hi, 0, stall + 1)
        hi = hi_new
        top_ok = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=dev),
                            ~alive], dim=1)                    # c==0 | dead

        def lo_of(h):
            return torch.where((ar <= h[:, None]) & top_ok, ar, 0).amax(-1)

        stalled = stall >= cplx_stall
        act = torch.zeros(B, n, dtype=torch.bool, device=dev)
        intro = torch.zeros(B, n, dtype=torch.bool, device=dev)
        x0 = torch.zeros(B, n, dtype=H.dtype, device=dev)
        y0 = torch.zeros(B, n, dtype=H.dtype, device=dev)
        h_r, l_r = hi, lo_of(hi)
        runs = []
        for r in range(nruns):
            if r > 0:
                h_r = torch.where((lane <= (l_r - 1)[:, None]) & alive, lane,
                                  0).amax(-1)
                l_r = lo_of(h_r)
            valid = h_r > 0
            hm = torch.clamp(h_r, min=1)
            a_ = H[bidx, hm - 1, hm - 1]
            b_ = H[bidx, hm - 1, hm]
            c_ = H[bidx, hm, hm - 1]
            d_ = H[bidx, hm, hm]
            sh = _wilkinson(a_, b_, c_, d_, stalled)
            if r == 0 and it % EXC_EVERY == EXC_EVERY - 1:
                sh = torch.complex(d_.real + 0.75 * c_.abs(), d_.imag)
            in_run = (ar >= l_r[:, None]) & (ar < h_r[:, None]) & valid[:, None]
            at_lo = (ar == l_r[:, None]) & valid[:, None]
            act |= in_run
            intro |= at_lo
            lo_c = l_r.clamp(max=n - 2)
            x0 = torch.where(at_lo, (H[bidx, lo_c, lo_c] - sh)[:, None], x0)
            y0 = torch.where(at_lo, H[bidx, lo_c + 1, lo_c][:, None], y0)
            runs.append((l_r.tolist(), h_r.tolist(), valid.tolist(), sh))
        rot += act.sum(-1)
        if window is not None and bool(act.any()):
            his = hi.tolist()
            for b in range(B):
                for lo_b, hr_b, ok, sh in reversed(runs):
                    if ok[b]:
                        _window_run(H[b], Z[b], lo_b[b], hr_b[b], sh[b],
                                    his[b], window)
            H = H.masked_fill(two_below, 0)
        elif bool(act.any()):
            ks = act.any(0).nonzero()
            k0, k1 = int(ks[0]), int(ks[-1]) + 1
            x = torch.zeros(B, dtype=H.dtype, device=dev)
            y = torch.zeros_like(x)
            for k in range(k0, k1):
                a_k, i_k = act[:, k], intro[:, k]
                x = torch.where(i_k, x0[:, k], x)
                y = torch.where(i_k, y0[:, k], y)
                c, s = _givens(x, y)
                c = torch.where(a_k, c, torch.ones_like(c))
                s = torch.where(a_k, s, torch.zeros_like(s))
                # the kernel's ranges: rows over columns >= k - 1, columns
                # over rows <= k + 2; the rest of those rows and columns is
                # below the band and stays zero
                _rotate_rows(c, s, H[:, :, max(k - 1, 0):], k)
                _rotate_cols(c, s, H[:, :min(k + 2, n - 1) + 1], k)
                _rotate_cols(c, s, Z, k)
                xn = H[:, k + 1, k]
                if k + 2 <= n - 1:
                    yn = torch.where(k + 2 <= hi, H[:, k + 2, k],
                                     torch.zeros_like(xn))
                else:
                    yn = torch.zeros_like(xn)
                x = torch.where(a_k, xn, x)
                y = torch.where(a_k, yn, y)
            H = H.masked_fill(two_below, 0)
        it += 1
    lower = ar[:, None] > ar[None, :]
    return H.masked_fill(lower, 0), Z, hi, sweeps, rot


def schur_qr_plain(H, Z, max_iter_factor=MAX_ITER_FACTOR, max_iters=None):
    """Implicit single-shift complex Schur QR by the rules of
    eig_qr_pallas._kernel_acc (four windows a sweep, multiplier 4, stall
    gate 30).  Returns (T, Z, hi, sweeps) with per-lane final window bottom
    ``hi`` (0 == converged) and sweep count; T is not NaN-poisoned here."""
    if max_iters is None:
        max_iters = max_iter_factor * H.shape[-1]
    return _single_shift_sweeps(H, Z, max_iters, **ACC_RULES)[:4]


def _poison(T, hi):
    """NaN on the diagonal of lanes whose window did not close."""
    bad = (hi > 0)[:, None, None]
    eye = torch.eye(T.shape[-1], dtype=torch.bool, device=T.device)
    return torch.where(bad & eye, torch.full_like(T, float('nan')), T)


def _single_shift_kernel(name, entry, H, Q, max_iters):
    """Launch one entry point of csrc/schur_qr.cu: (T, Z, (hi, sweeps,
    rotations))."""
    B, n = H.shape[0], H.shape[-1]
    T = torch.empty_like(H)
    Z = torch.empty_like(H)
    stats = torch.empty(B, 3, dtype=torch.int32, device=H.device)
    err = getattr(_build.load(), entry)(
        H.data_ptr(), Q.data_ptr(), T.data_ptr(), Z.data_ptr(),
        stats.data_ptr(), B, n, max_iters, _stream())
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return T, Z, (stats[:, 0], stats[:, 1], stats[:, 2])


def schur_qr(H, Q, max_iter_factor=MAX_ITER_FACTOR, return_stats=False,
             max_iters=None):
    """Batched Schur QR: Hessenberg H and its Q -> (T, Z) with H = Z T Z^H.

    Lanes that run out of the ``max_iter_factor * n`` sweep budget
    (``max_iters`` sweeps when given) get NaN eigenvalues (the zgeev INFO
    analogue).  With ``return_stats`` also returns (window bottom, sweeps,
    rotations applied) per lane, int tensors of shape (B,).  A CUDA tensor
    goes through ``csrc/schur_qr.cu`` (complex64 only), a CPU tensor
    through the plain version.
    """
    if max_iters is None:
        max_iters = max_iter_factor * H.shape[-1]
    with timing.span('eig.schur') as sp:
        if _check('schur_qr', H, Q):
            T, Z, st = _single_shift_kernel('schur_qr',
                                            'torcwa_schur_qr_c64', H, Q,
                                            max_iters)
        else:
            T, Z, hi, sweeps, rot = _single_shift_sweeps(H, Q, max_iters,
                                                         **ACC_RULES)
            st = (hi, sweeps, rot)
        T = _poison(T, st[0])
        if sp is not None:
            # summed where the stats lie; the recorder reads it back later
            sp.count('sweeps', st[1].sum())
            sp.count('matrices', H.shape[0])
    if return_stats:
        return T, Z, st
    return T, Z


def schur_qr_v2_plain(H, Z, max_iter_factor=MAX_ITER_FACTOR, max_iters=None):
    """The plain version of :func:`schur_qr_v2`: (T, Z, hi, sweeps,
    rotations), T as the sweeps left it."""
    if max_iters is None:
        max_iters = max_iter_factor * H.shape[-1]
    return _single_shift_sweeps(H, Z, max_iters, **V2_RULES)


def schur_qr_v2(H, Q, max_iter_factor=MAX_ITER_FACTOR, return_stats=False,
                max_iters=None):
    """Batched single-shift Schur QR by the v2 rules (one window per lane,
    deflation at eps (|d| + |d'|), complex Wilkinson branch always open):
    Hessenberg H and its Q -> (T, Z) with H = Z T Z^H.

    Counterpart of ``schur_qr_pallas_batched``: a lane that runs out of the
    ``max_iter_factor * n`` sweep budget (``max_iters`` sweeps when given)
    is handed back as it stands, NOT NaN-poisoned.  With ``return_stats``
    also returns (window bottom, sweeps, rotations applied) per lane.  A
    CUDA tensor goes through the kernel's second entry point in
    ``csrc/schur_qr.cu`` (complex64 only), a CPU tensor through the plain
    version."""
    if _check('schur_qr_v2', H, Q):
        if max_iters is None:
            max_iters = max_iter_factor * H.shape[-1]
        T, Z, st = _single_shift_kernel('schur_qr_v2',
                                        'torcwa_schur_qr_v2_c64', H, Q,
                                        max_iters)
    else:
        T, Z, hi, sweeps, rot = schur_qr_v2_plain(H, Q, max_iter_factor,
                                                  max_iters)
        st = (hi, sweeps, rot)
    if return_stats:
        return T, Z, st
    return T, Z


# ---------------------------------------------------------------------------
# Triangular eigenvectors
# ---------------------------------------------------------------------------

# csrc/tri_vectors.cu runs a warp per column where a lane's register
# slots hold the row sums, n <= 32 VEC_MAX_SLOTS, slots compiled in steps of
# VEC_SLOT_STEP; larger n takes the one-block kernel (0 slots)
VEC_MAX_SLOTS = 20
VEC_SLOT_STEP = 4


def tri_vectors_slots(n):
    """Register slots of row sums a lane of the warp-per-column kernel
    keeps at n; 0 where n takes the one-block kernel."""
    need = -(-n // 32)
    if need > VEC_MAX_SLOTS:
        return 0
    return -(-need // VEC_SLOT_STEP) * VEC_SLOT_STEP


def tri_vectors_plain(T, by_columns=False):
    """Unit upper-triangular Y with T Y = Y diag(lambda), by row
    back-substitution with LAPACK-style floored pivots
    (eig_qr_pallas._kernel_vec).

    With ``by_columns`` in the order of the warp-per-column kernel
    (csrc/tri_vectors.cu): each y_i, once formed, added into the sums of
    the rows above it, Y's unit entry first, so every sum is taken in
    descending l (the kernel multiplies by conj(D) / |D|^2 where this
    divides by |D|^2)."""
    B, n = T.shape[0], T.shape[-1]
    eps, smlnum = _consts(T.dtype)
    lam = torch.diagonal(T, dim1=-2, dim2=-1)
    tnorm = T.abs().sum(-2).amax(-1, keepdim=True)
    dmin = torch.clamp(eps * torch.maximum(lam.abs(), tnorm), min=smlnum)
    Y = torch.eye(n, dtype=T.dtype, device=T.device).expand(B, n, n).clone()
    idx = torch.arange(n, device=T.device)
    # by columns the unit entry Y[m, m] brings T[j, m] into the sums at
    # step j = m, the first term of each
    sums = torch.zeros_like(T) if by_columns else None
    for j in range(n - 1 if by_columns else n - 2, -1, -1):
        if by_columns:
            s = sums[:, j, :]
        else:
            trow = torch.where(idx > j, T[:, j, :],
                               torch.zeros_like(T[:, j, :]))
            s = torch.einsum('bl,blm->bm', trow, Y)
        drow = lam[:, j:j + 1] - lam
        dabs = drow.abs()
        small = dabs < dmin
        scl = torch.where(small & (dabs > 0),
                          dmin / torch.where(dabs > 0, dabs, 1.), 1.)
        drow = torch.where(small & (dabs == 0), dmin.to(T.dtype), drow * scl)
        dden = drow.real ** 2 + drow.imag ** 2
        dden = torch.where(dden > 0, dden, 1.)
        q = -(s * drow.conj()) / dden
        Y[:, j, :] = torch.where(idx > j, q, Y[:, j, :])
        if by_columns:
            sums[:, :j, :] += T[:, :j, j, None] * Y[:, j, None, :]
    return Y


def tri_vectors(T):
    """Batched triangular eigenvectors: (B, n, n) Schur factor -> Y.

    On the card a warp per column (:func:`tri_vectors_slots` (n) > 0) after
    a pre-pass that packs T's triangle into scratch, else one block per
    matrix."""
    if not _check('tri_vectors', T):
        return tri_vectors_plain(T)
    B, n = T.shape[0], T.shape[-1]
    Y = torch.empty_like(T)
    # scratch of the pre-pass: T's triangle packed by columns, and the
    # largest column sum of |T| in each tile of 32 columns
    tri = torch.empty(B, n * (n + 1) // 2, dtype=T.dtype, device=T.device)
    tmax = torch.empty(B, -(-n // 32), dtype=torch.float32, device=T.device)
    err = _build.load().torcwa_tri_vectors_c64(
        T.data_ptr(), Y.data_ptr(), tri.data_ptr(), tmax.data_ptr(), B, n,
        _stream())
    _raise_on('tri_vectors', err)
    LAUNCHES['tri_vectors'] += 1
    return Y
