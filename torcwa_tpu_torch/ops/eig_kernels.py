"""The three eig kernels of the main path, their plain versions and counts.

Counterpart of the batched small-n route of ``torcwa_tpu/ops/
eig_qr_pallas.py``.  Each stage has

* a wrapper (:func:`hessenberg`, :func:`schur_qr`, :func:`tri_vectors`)
  that launches the CUDA kernel in ``csrc/`` for a CUDA tensor and raises
  for anything the kernel does not take, and uses the plain version only
  for a tensor that lies on the CPU;
* a plain PyTorch version (``*_plain``) with the same rules, batched over
  the leading dimension, in the input's precision (float32 or float64
  eps), which the CPU tests hold against the Pallas kernels;
* a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches its kernel and nowhere else.

All arrays are (B, n, n) complex, row-major.
"""

import torch

from . import _build

__all__ = ['hessenberg', 'schur_qr', 'tri_vectors', 'hessenberg_plain',
           'schur_qr_plain', 'tri_vectors_plain', 'LAUNCHES',
           'reset_launch_counts']

# TPU-kernel defaults (eig_qr_pallas.py: _CPLX_STALL, _NRUNS, _DEFL_MULT);
# csrc/schur_qr.cu compiles in the same values
CPLX_STALL = 30
NRUNS = 4
DEFL_MULT = 4.0
EXC_EVERY = 13
MAX_ITER_FACTOR = 40

LAUNCHES = {'hessenberg': 0, 'schur_qr': 0, 'tri_vectors': 0}


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

def hessenberg_plain(A):
    """Householder reduction A = Q H Q^H, reflector v = x + phase(x_0)
    ||x|| e_1, beta = 2 / ||v||^2 (eig_qr_pallas._kernel_hess)."""
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
        u = beta * torch.einsum('bij,bj->bi', H, v)
        H = H - u[:, :, None] * v.conj()[:, None, :]
        uq = beta * torch.einsum('bij,bj->bi', Q, v)
        Q = Q - uq[:, :, None] * v.conj()[:, None, :]
    below = idx[:, None] > idx[None, :] + 1
    return H.masked_fill(below, 0), Q


def hessenberg(A):
    """Batched Hessenberg reduction: (B, n, n) complex -> (H, Q)."""
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
    """(c real, s complex) with [[c, s], [-conj(s), c]] [x; y] = [r; 0]."""
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


def schur_qr_plain(H, Z, max_iter_factor=MAX_ITER_FACTOR):
    """Implicit single-shift complex Schur QR (eig_qr_pallas._kernel_acc
    rules, rotations applied directly).  Returns (T, Z, hi, sweeps) with
    per-lane final window bottom ``hi`` (0 == converged) and sweep count;
    T is not NaN-poisoned here."""
    H = H.clone()
    Z = Z.clone()
    B, n = H.shape[0], H.shape[-1]
    dev = H.device
    eps, smlnum = _consts(H.dtype)
    max_iters = max_iter_factor * n
    hi = torch.full((B,), n - 1, dtype=torch.long, device=dev)
    stall = torch.zeros(B, dtype=torch.long, device=dev)
    sweeps = torch.zeros(B, dtype=torch.long, device=dev)
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
        thresh = torch.clamp(DEFL_MULT * eps * (d[:, :-1] + d[:, 1:]),
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

        stalled = stall >= CPLX_STALL
        act = torch.zeros(B, n, dtype=torch.bool, device=dev)
        intro = torch.zeros(B, n, dtype=torch.bool, device=dev)
        x0 = torch.zeros(B, n, dtype=H.dtype, device=dev)
        y0 = torch.zeros(B, n, dtype=H.dtype, device=dev)
        h_r, l_r = hi, lo_of(hi)
        for r in range(NRUNS):
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
        if bool(act.any()):
            ks = act.any(0).nonzero()
            k0, k1 = int(ks[0]), int(ks[-1]) + 1
            x = torch.zeros(B, dtype=H.dtype, device=dev)
            y = torch.zeros_like(x)
            for k in range(k0, k1):
                a_k, i_k = act[:, k], intro[:, k]
                x = torch.where(i_k, x0[:, k], x)
                y = torch.where(i_k, y0[:, k], y)
                c, s = _givens(x, y)
                c = torch.where(a_k, c, torch.ones_like(c)).to(H.dtype)
                s = torch.where(a_k, s, torch.zeros_like(s))
                G = torch.stack([torch.stack([c, s], -1),
                                 torch.stack([-s.conj(), c], -1)], -2)
                GH = G.conj().transpose(-1, -2)
                H[:, k:k + 2, :] = G @ H[:, k:k + 2, :]
                H[:, :, k:k + 2] = H[:, :, k:k + 2] @ GH
                Z[:, :, k:k + 2] = Z[:, :, k:k + 2] @ GH
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
    return H.masked_fill(lower, 0), Z, hi, sweeps


def _poison(T, hi):
    """NaN on the diagonal of lanes whose window did not close."""
    bad = (hi > 0)[:, None, None]
    eye = torch.eye(T.shape[-1], dtype=torch.bool, device=T.device)
    return torch.where(bad & eye, torch.full_like(T, float('nan')), T)


def schur_qr(H, Q, max_iter_factor=MAX_ITER_FACTOR, return_stats=False):
    """Batched Schur QR: Hessenberg H and its Q -> (T, Z) with H = Z T Z^H.

    Lanes that run out of the ``max_iter_factor * n`` sweep budget get NaN
    eigenvalues (the zgeev INFO analogue).  With ``return_stats`` also
    returns (window bottom, sweeps) per lane, int tensors of shape (B,).
    """
    if _check('schur_qr', H, Q):
        B, n = H.shape[0], H.shape[-1]
        T = torch.empty_like(H)
        Z = torch.empty_like(H)
        stats = torch.empty(B, 2, dtype=torch.int32, device=H.device)
        err = _build.load().torcwa_schur_qr_c64(
            H.data_ptr(), Q.data_ptr(), T.data_ptr(), Z.data_ptr(),
            stats.data_ptr(), B, n, max_iter_factor * n, _stream())
        _raise_on('schur_qr', err)
        LAUNCHES['schur_qr'] += 1
        hi, sweeps = stats[:, 0], stats[:, 1]
    else:
        T, Z, hi, sweeps = schur_qr_plain(H, Q, max_iter_factor)
    T = _poison(T, hi)
    if return_stats:
        return T, Z, (hi, sweeps)
    return T, Z


# ---------------------------------------------------------------------------
# Triangular eigenvectors
# ---------------------------------------------------------------------------

def tri_vectors_plain(T):
    """Unit upper-triangular Y with T Y = Y diag(lambda), by row
    back-substitution with LAPACK-style floored pivots
    (eig_qr_pallas._kernel_vec)."""
    B, n = T.shape[0], T.shape[-1]
    eps, smlnum = _consts(T.dtype)
    lam = torch.diagonal(T, dim1=-2, dim2=-1)
    tnorm = T.abs().sum(-2).amax(-1, keepdim=True)
    dmin = torch.clamp(eps * torch.maximum(lam.abs(), tnorm), min=smlnum)
    Y = torch.eye(n, dtype=T.dtype, device=T.device).expand(B, n, n).clone()
    idx = torch.arange(n, device=T.device)
    for j in range(n - 2, -1, -1):
        trow = torch.where(idx > j, T[:, j, :], torch.zeros_like(T[:, j, :]))
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
    return Y


def tri_vectors(T):
    """Batched triangular eigenvectors: (B, n, n) Schur factor -> Y."""
    if not _check('tri_vectors', T):
        return tri_vectors_plain(T)
    B, n = T.shape[0], T.shape[-1]
    Y = torch.empty_like(T)
    err = _build.load().torcwa_tri_vectors_c64(
        T.data_ptr(), Y.data_ptr(), B, n, _stream())
    _raise_on('tri_vectors', err)
    LAUNCHES['tri_vectors'] += 1
    return Y
