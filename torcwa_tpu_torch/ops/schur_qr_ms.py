"""Multishift Schur QR of ONE Hessenberg matrix with the whole iteration in
one kernel launch: H = Z T Z^H.

Counterpart of ``torcwa_tpu/ops/eig_qr_pallas_ms.py`` (``schur_qr_pallas_ms``,
TPU kernel ``_kernel_ms``).  Per sweep: the band scan gives the active block
[lo, hi] (deflation at eps (|d| + |d'|)); the m shifts are the eigenvalues
of the trailing m x m block ordered by distance to H[hi, hi]
(:func:`trailing_shifts_plain`, shared with ``schur_ms(aed=False)``); m
spacing-2 bulges are chased over the whole active block; 13 sweeps without
progress make the next sweep exceptional.  The budget is ``(max_iter_factor
n) // m + 8 m + 40`` sweeps; when it runs out the eigenvalues are NaN.

:func:`schur_qr_ms` launches ``csrc/schur_qr_ms.cu`` once for a CUDA tensor
(complex64 only) and raises for what the kernel does not take; a CPU tensor
goes through :func:`schur_qr_ms_plain`, the same sweeps rotation by rotation
in the input's precision.  Beside ``schur_ms`` (windowed, AED, sweep loop on
the host) this stage has no host round trip per sweep, no windows and no
slab products; it is not on a route of ``eig_qr`` and is reached through
``eig_qr.eig_small`` with the stage passed in.

On the card the matrix is worked by one thread-block cluster of P CTAs
with H (and Z^T where both fit) in the cluster's shared memory, column j
on rank j mod P (``csrc/ms_cluster.cuh``), or, where H's columns do not
fit, by one thread block with H and Z in device memory.
:func:`schur_qr_ms_cluster` mirrors the C entry point's choice;
``schur_qr_ms_plain(..., cluster=P)`` takes the cluster kernel's schedule
(:func:`chase_cluster_plain`).
"""

import ctypes

import torch

from . import _build
from .eig_kernels import LAUNCHES, _givens, _raise_on, _stream
from .schur_ms import (EXC_STALL, band_scan_plain, chase_plain, max_sweeps,
                       trailing_shifts_plain)

__all__ = ['schur_qr_ms', 'schur_qr_ms_plain', 'trailing_shifts_plain',
           'chase_cluster_plain', 'schur_qr_ms_cluster',
           'schur_qr_ms_cluster_info', 'MAX_M']

MAX_M = 64           # limit compiled into csrc/ms_shifts.cuh

# csrc/ms_cluster.cuh: P = CLUSTER where a rank holds at most CLUSTER_COLS
# columns (n <= 256), else CLUSTER_WIDE (16, non-portable); a CTA's shared
# memory holds its ceil(n / P) columns of H at a leading dimension n | 1,
# the same of Z^T where both fit, the trailing m x m block, the shift QR's
# m (m + 1) scratch and n flags (padded to 16 bytes), against the 227 KB a
# block may use less what its static shared memory may take
CLUSTER = 8
CLUSTER_WIDE = 16
CLUSTER_COLS = 32
SMEM_PER_BLOCK = 232448
STATIC_RESERVE = 8192


def cluster_smem_bytes(n, p, m, zs):
    """Dynamic shared memory of one CTA of the cluster kernel."""
    cols = -(-n // p) * (n | 1) * (2 if zs else 1)
    return 8 * (cols + m * m + m * (m + 1)) + (n + 15) // 16 * 16


def schur_qr_ms_cluster(n, m):
    """(P, z_shared): the kernel the C entry point launches at (n, m), P = 0
    for the one-block kernel.  P follows from n alone; whether Z^T sits in
    shared memory beside H, and whether H fits at all, from n and m."""
    if n < 2:
        return 0, False
    p = CLUSTER if -(-n // CLUSTER) <= CLUSTER_COLS else CLUSTER_WIDE
    room = SMEM_PER_BLOCK - STATIC_RESERVE
    for zs in (True, False):
        if cluster_smem_bytes(n, p, m, zs) <= room:
            return p, zs
    return 0, False


def schur_qr_ms_cluster_info(n, m):
    """The same choice as the C entry point reports it: dict(cluster,
    z_shared, smem_bytes); cluster 0 for the one-block kernel."""
    out = (ctypes.c_int * 3)()
    _raise_on('schur_qr_ms_cluster_info',
              _build.load().torcwa_schur_qr_ms_cluster_info(n, m, out))
    return dict(cluster=out[0], z_shared=bool(out[1]), smem_bytes=out[2])


def _check(H, Q, m):
    if H.dim() != 2 or H.shape[0] != H.shape[1] or H.shape != Q.shape \
            or not H.is_complex() or H.dtype != Q.dtype \
            or H.device != Q.device:
        raise ValueError('schur_qr_ms: expected two complex (n, n) matrices '
                         'of one type on one device')
    if not 1 <= m <= MAX_M:
        raise ValueError(f'schur_qr_ms: 1 <= m <= {MAX_M} (got {m})')


def _finish(T, Z, hi, sweeps, rotations, return_stats):
    """NaN on the diagonal when the window did not close; hi, sweeps and
    rotations are 0-d integer tensors on T's device."""
    eye = torch.eye(T.shape[-1], dtype=torch.bool, device=T.device)
    T = torch.where((hi > 0) & eye, torch.full_like(T, float('nan')), T)
    if return_stats:
        return T, Z, (hi, sweeps, rotations)
    return T, Z


def chase_cluster_plain(H, Z, shifts, lo, hi, P):
    """The chase of one sweep over the active block [lo, hi] in place on H
    and Z, in the schedule of the cluster kernel (csrc/ms_cluster.cuh) with
    P ranks: the rotations of :func:`schur_ms.chase_plain` over the whole
    matrix, each applied by the rank that owns the entries.  Rank r owns
    the columns j = r (mod P) of H and the same rows of Z (the columns of
    Z^T).  A step forms its rotations once from the carries (cx, cy); each
    rank rotates rows k, k + 1 of its columns >= max(k - 1, lo) and of its
    rows of Z; then the owner of column k rotates columns k, k + 1 on rows
    [0, half), the owner of k + 1 on rows [half, min(k + 2, hi)]; the new
    H[k + 1, k] and H[k + 2, k] are the bulge's next carry, and the owner
    of column lo writes the carry of the bulge that enters next step.
    Each update is the expression of ``chase_plain`` on the same operands,
    written where the owner's mask allows, so the two agree bit for bit
    when every entry has exactly one owner."""
    n, m = H.shape[-1], shifts.shape[0]
    dev = H.device
    idx = torch.arange(n, device=dev)[None, :]
    owner = idx % P
    ii = torch.arange(m, device=dev)
    nb = min(m, (hi - lo - 1) // 2 + 1)
    cx = torch.zeros(m, dtype=H.dtype, device=dev)
    cy = torch.zeros_like(cx)

    def intro(j):                      # by the owner of column lo
        cx[j], cy[j] = H[lo, lo] - shifts[j], H[lo + 1, lo]

    intro(0)
    for t in range(lo, hi - 1 + 2 * (nb - 1) + 1):
        ks = t - 2 * ii
        act = (ii < nb) & (ks >= lo) & (ks < hi)
        k = ks[act]
        c, s = _givens(cx[act], cy[act])
        c, s = c[:, None], s[:, None]
        # rows k, k+1 of H and columns k, k+1 of Z: each rank its own
        hk, h1 = H[k], H[k + 1]
        on = idx >= torch.clamp(k - 1, min=lo)[:, None]
        zap = (idx == (k - 1)[:, None]) & (k > lo)[:, None]
        nk = c * hk + s * h1
        n1 = torch.where(zap, torch.zeros_like(h1), c * h1 - s.conj() * hk)
        zl, zr = Z[:, k].T, Z[:, k + 1].T
        zk, z1 = c * zl + s.conj() * zr, c * zr - s * zl
        for r in range(P):
            mine = owner == r
            hk = torch.where(mine & on, nk, hk)
            h1 = torch.where(mine & on, n1, h1)
            zl, zr = torch.where(mine, zk, zl), torch.where(mine, z1, zr)
        H[k], H[k + 1], Z[:, k], Z[:, k + 1] = hk, h1, zl.T, zr.T
        # columns k, k+1, rows <= min(k + 2, hi): rows [0, half) by the
        # owner of column k, [half, kmax] by the owner of column k + 1
        kmax = torch.clamp(k + 2, max=hi)[:, None]
        half = (kmax + 1) // 2
        cl, cr = H[:, k].T, H[:, k + 1].T
        nl, nr = c * cl + s.conj() * cr, c * cr - s * cl
        for part in (idx < half, (idx >= half) & (idx <= kmax)):
            H[:, k] = torch.where(part, nl, H[:, k].T).T
            H[:, k + 1] = torch.where(part, nr, H[:, k + 1].T).T
        cx[act] = H[k + 1, k]
        k2 = torch.clamp(k + 2, max=hi)
        cy[act] = torch.where(k + 2 <= hi, H[k2, k], torch.zeros_like(k2,
                                                                   dtype=H.dtype))
        d = t + 1 - lo
        if d % 2 == 0 and d // 2 < nb:
            intro(d // 2)


def schur_qr_ms_plain(H, Q, m=8, max_iter_factor=40, return_stats=False,
                      cluster=None):
    """The plain PyTorch version of :func:`schur_qr_ms` (same arguments).
    With ``cluster`` = P each sweep's chase takes the cluster kernel's
    schedule (:func:`chase_cluster_plain`)."""
    _check(H, Q, m)
    n = H.shape[-1]
    H, Z = H.clone(), Q.clone()
    budget = max_sweeps(n, m, max_iter_factor)
    hi, it, stall, rot = n - 1, 0, 0, 0
    while hi > 0 and it < budget:
        hi_prev = hi
        lo, hi = band_scan_plain(H, hi, 1.0)
        exc = stall >= EXC_STALL
        if hi > 0:
            shifts = trailing_shifts_plain(H, lo, hi, m, exc)
            nb = min(m, (hi - lo - 1) // 2 + 1)
            if cluster:
                chase_cluster_plain(H, Z, shifts, lo, hi, cluster)
            else:
                zero = torch.zeros(m, dtype=H.dtype, device=H.device)
                chase_plain(H, shifts, zero, zero.clone(), 0, n, lo,
                            hi - 1 + 2 * (nb - 1), lo, hi, Z=Z)
            rot += nb * (hi - lo)
        stall = 0 if (hi < hi_prev or exc) else stall + 1
        it += 1
    dev = H.device
    return _finish(torch.triu(H), Z, torch.tensor(hi, device=dev),
                   torch.tensor(it, device=dev),
                   torch.tensor(rot, device=dev), return_stats)


def schur_qr_ms(H, Q, m=8, max_iter_factor=40, return_stats=False):
    """Schur form of one Hessenberg H with its Q: (T, Z), H = Z T Z^H, by m
    bulges a sweep, the whole iteration in one launch.

    With ``return_stats`` also returns (hi, sweeps, rotations) as 0-d
    integer tensors: the final window bottom (0 == converged), the sweeps
    taken (the pass that finds the block closed included, as the JAX entry
    counts) and the rotations applied.  A CUDA tensor goes through
    ``csrc/schur_qr_ms.cu`` (complex64 only; a cluster of
    :func:`schur_qr_ms_cluster` (n, m) CTAs, or one block), a CPU tensor
    through the plain version."""
    _check(H, Q, m)
    if H.device.type == 'cpu':
        return schur_qr_ms_plain(H, Q, m, max_iter_factor, return_stats)
    if H.device.type != 'cuda':
        raise RuntimeError(f'schur_qr_ms: no kernel for device '
                           f'{H.device.type!r}')
    if H.dtype != torch.complex64:
        raise TypeError(f'schur_qr_ms: the CUDA kernel takes complex64 only '
                        f'(got {H.dtype}); float64 kernels are still to be '
                        f'ported')
    n = H.shape[-1]
    T = H.contiguous().clone()
    # the kernel holds Z transposed, so that a column rotation of Z is a
    # rotation of two contiguous rows
    Zt = Q.mT.clone(memory_format=torch.contiguous_format)
    stats = torch.zeros(3, dtype=torch.int64, device=H.device)
    err = _build.load().torcwa_schur_qr_ms_c64(
        T.data_ptr(), Zt.data_ptr(), stats.data_ptr(), n, m,
        max_sweeps(n, m, max_iter_factor), _stream())
    _raise_on('schur_qr_ms', err)
    LAUNCHES['schur_qr_ms'] += 1
    return _finish(T, Zt.mT.contiguous(), stats[0], stats[1], stats[2],
                   return_stats)
