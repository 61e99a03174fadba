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
"""

import torch

from . import _build
from .eig_kernels import LAUNCHES, _raise_on, _stream
from .schur_ms import (EXC_STALL, band_scan_plain, chase_plain, max_sweeps,
                       trailing_shifts_plain)

__all__ = ['schur_qr_ms', 'schur_qr_ms_plain', 'trailing_shifts_plain',
           'MAX_M']

MAX_M = 64           # limit compiled into csrc/ms_shifts.cuh


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


def schur_qr_ms_plain(H, Q, m=8, max_iter_factor=40, return_stats=False):
    """The plain PyTorch version of :func:`schur_qr_ms` (same arguments)."""
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
    ``csrc/schur_qr_ms.cu`` (complex64 only), a CPU tensor through the plain
    version."""
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
