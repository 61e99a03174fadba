"""Batched multishift Schur QR with aggressive early deflation inside the
launch: H = Z T Z^H for a (B, n, n) batch of Hessenberg matrices.

Counterpart of ``torcwa_tpu/ops/attic/eig_qr_pallas_baed.py``
(``schur_qr_pallas_baed``, TPU kernel ``_kernel_baed``).  Per matrix and per
sweep: the band scan gives the active block [lo, hi] (deflation at eps (|d| +
|d'|)); AED on the ``kw``-row trailing window deflates what it can, its
transform being applied to H and Z only where it deflated; the sweep's ``m``
shifts are the undeflated window eigenvalues nearest the new corner; then
every sweep chases up to m spacing-2 bulges over the whole active block; 13
sweeps without progress make the next sweep exceptional.  The budget is
``(max_iter_factor n) // m + 8 m + 40`` sweeps per matrix; where it runs out
the eigenvalues are NaN.  The same contract as ``eig_kernels.schur_qr``, so
the stage enters ``eig_qr.eig_small(A3, stage)`` or ``eig_qr.SMALL_SCHUR``.

:func:`schur_qr_baed` launches ``csrc/schur_qr_baed.cu`` once for a CUDA
batch (complex64 only; the sweep loop on the device: a thread-block cluster
of :func:`schur_qr_baed_cluster` CTAs per matrix where H and the AED arrays
fit its shared memory and the batch runs in one wave of clusters, one thread
block per matrix otherwise; the AED window's Schur form chased by one warp)
and raises for what the kernel does not
take; a CPU batch goes
through :func:`schur_qr_baed_plain`, the same sweeps lane by lane from the
plain parts of ``schur_ms.py`` (``band_scan_plain``, ``aed_plain``,
``chase_plain``), in the input's precision.  Beside ``schur_ms`` (one matrix,
windowed chase, sweep loop on the host) this stage has multiplier 1 in the
band scan and the spike test, no nibble rule, no windows and no host round
trip; beside the TPU kernel, whose lanes run in lock step until the slowest
is done, every matrix here ends with its own last sweep, so ``sweeps`` is
counted per matrix.
"""

import ctypes

import torch

from . import _build
from .eig_kernels import LAUNCHES, _check, _poison, _raise_on, _stream
from .schur_ms import (AED_KW, EXC_STALL, aed_plain, band_scan_plain,
                       chase_plain, max_sweeps)
from .schur_qr_ms import (CLUSTER, CLUSTER_WIDE, SMEM_PER_BLOCK,
                          STATIC_RESERVE)

__all__ = ['schur_qr_baed', 'schur_qr_baed_plain', 'schur_qr_baed_cluster',
           'schur_qr_baed_cluster_info', 'MAX_M', 'MAX_KW']

# limits compiled into csrc/ms_shifts.cuh and csrc/aed_warp.cuh
MAX_M, MAX_KW = 64, 64


def cluster_smem_bytes(n, p, kw):
    """Dynamic shared memory of one CTA of the cluster kernel
    (csrc/baed_cluster.cuh): its ceil(n / P) columns of H at a leading
    dimension n | 1, the AED arrays of csrc/aed_warp.cuh (2 (kw + 1)^2 +
    2 kw + 1 complex64) and n flags padded to 16 bytes."""
    cols = -(-n // p) * (n | 1)
    return 8 * (cols + 2 * (kw + 1) ** 2 + 2 * kw + 1) + (n + 15) // 16 * 16


def schur_qr_baed_cluster(n, kw=AED_KW):
    """The cluster size the C entry point launches at (n, kw) for a batch
    that runs in one wave of clusters: 8 where a CTA's share fits its
    shared memory (n <= 392 at kw = 64), else 16 (n <= 553), else 0, the
    one-block kernel.  m does not enter.  A batch of more matrices than the
    card runs clusters at once (:func:`schur_qr_baed_cluster_info`) takes
    the one-block kernel: a second wave would double the time."""
    room = SMEM_PER_BLOCK - STATIC_RESERVE
    for p in (CLUSTER, CLUSTER_WIDE):
        if cluster_smem_bytes(n, p, kw) <= room:
            return p
    return 0


def schur_qr_baed_cluster_info(n, m=8, kw=AED_KW):
    """The same choice as the C entry point reports it on the card:
    dict(cluster, smem_bytes, clusters_at_once); cluster 0 for the
    one-block kernel (clusters_at_once 0).  A batch of B matrices runs on
    the clusters where B <= clusters_at_once."""
    out = (ctypes.c_int * 3)()
    _raise_on('schur_qr_baed_cluster_info',
              _build.load().torcwa_schur_qr_baed_cluster_info(n, m, kw, out))
    return dict(cluster=out[0], smem_bytes=out[1], clusters_at_once=out[2])


def _check_args(H, Q, m, kw):
    on_card = _check('schur_qr_baed', H, Q)
    if H.dtype != Q.dtype:
        raise ValueError('schur_qr_baed: H and Q differ in type')
    n = H.shape[-1]
    if n < kw + 10:
        raise ValueError(f'schur_qr_baed: n={n} too small for AED window '
                         f'kw={kw} (needs n >= kw + 10)')
    if not 1 <= m <= min(kw, MAX_M) or kw > MAX_KW:
        raise ValueError(f'schur_qr_baed: 1 <= m <= kw <= {MAX_KW} '
                         f'(got m={m}, kw={kw})')
    return on_card


def _lane_plain(H, Z, m, kw, budget):
    """The sweeps of one matrix, in place on H and Z (plain Z): (hi, sweeps,
    rotations, rows AED deflated, complex multiply-adds of the applied AED
    transforms)."""
    n = H.shape[-1]
    hi, it, stall, rot, deflated, cmacs = n - 1, 0, 0, 0, 0, 0
    while hi > 0 and it < budget:
        hi_prev = hi
        lo, hi = band_scan_plain(H, hi, 1.0)
        exc = stall >= EXC_STALL
        if hi > 0:
            s, kwe, hi_new, shifts, P = aed_plain(H, lo, hi, m, kw, 1.0, exc,
                                                  uncut_scale=True)
            if hi_new < hi:
                e = s + kwe
                H[s:e, e:] = P @ H[s:e, e:]
                H[:s, s:e] = H[:s, s:e] @ P.mH
                Z[:, s:e] = Z[:, s:e] @ P.mH
                deflated += hi - hi_new
                cmacs += kwe * kwe * ((n - e) + s + n)
                hi = hi_new
            if hi > lo:
                nb = min(m, (hi - lo - 1) // 2 + 1)
                zero = torch.zeros(m, dtype=H.dtype, device=H.device)
                chase_plain(H, shifts, zero, zero.clone(), 0, n, lo,
                            hi - 1 + 2 * (nb - 1), lo, hi, Z=Z)
                rot += nb * (hi - lo)
        stall = 0 if (hi < hi_prev or exc) else stall + 1
        it += 1
    return hi, it, rot, deflated, cmacs


def _finish(T, Z, stats, return_stats):
    """NaN on the diagonal of matrices whose block did not close; stats:
    (B, 5) int64 on T's device."""
    T = _poison(T, stats[:, 0])
    if return_stats:
        return T, Z, tuple(stats.unbind(1))
    return T, Z


def schur_qr_baed_plain(H, Q, m=8, kw=AED_KW, max_iter_factor=40,
                        return_stats=False, max_iters=None):
    """The plain PyTorch version of :func:`schur_qr_baed` (same arguments)."""
    _check_args(H, Q, m, kw)
    n = H.shape[-1]
    if max_iters is None:
        max_iters = max_sweeps(n, m, max_iter_factor)
    T, Z = H.clone(), Q.clone()
    stats = torch.tensor([_lane_plain(t, z, m, kw, max_iters)
                          for t, z in zip(T, Z)], dtype=torch.int64,
                         device=H.device).reshape(-1, 5)
    return _finish(torch.triu(T), Z, stats, return_stats)


def schur_qr_baed(H, Q, m=8, kw=AED_KW, max_iter_factor=40,
                  return_stats=False, max_iters=None):
    """Batched Schur QR with AED: Hessenberg H and its Q, (B, n, n) complex,
    -> (T, Z) with H = Z T Z^H, by up to m bulges a sweep after an AED pass
    on a window of kw rows, all sweeps of all matrices in one launch.

    Needs n >= kw + 10 and m <= kw <= 64 (``ValueError``).  A matrix that runs
    out of its ``(max_iter_factor n) // m + 8 m + 40`` sweeps (``max_iters``
    sweeps when given) gets NaN eigenvalues.  With ``return_stats`` also
    returns, per matrix as int64 tensors of shape (B,): the final window
    bottom (0 == converged), the sweeps taken (the pass that finds the block
    closed included), the rotations applied, the rows AED deflated and the
    complex multiply-adds of the applied AED transforms (kwe^2 per row or
    column of the off-window slabs).  A CUDA batch goes through
    ``csrc/schur_qr_baed.cu`` (complex64 only), a CPU batch through the plain
    version."""
    if not _check_args(H, Q, m, kw):
        return schur_qr_baed_plain(H, Q, m, kw, max_iter_factor, return_stats,
                                   max_iters)
    B, n = H.shape[0], H.shape[-1]
    if max_iters is None:
        max_iters = max_sweeps(n, m, max_iter_factor)
    T = H.clone()
    # the kernel holds Z transposed, so that a column rotation of Z is a
    # rotation of two contiguous rows
    Zt = Q.mT.contiguous()
    stats = torch.zeros(B, 5, dtype=torch.int64, device=H.device)
    err = _build.load().torcwa_schur_qr_baed_c64(
        T.data_ptr(), Zt.data_ptr(), stats.data_ptr(), B, n, m, kw, max_iters,
        _stream())
    _raise_on('schur_qr_baed', err)
    LAUNCHES['schur_qr_baed'] += 1
    return _finish(T, Zt.mT.contiguous(), stats, return_stats)
