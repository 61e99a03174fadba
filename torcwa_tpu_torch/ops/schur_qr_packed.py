"""Batched single-shift Schur QR on a packed planar layout: H = Z T Z^H for
a (B, n, n) batch of Hessenberg matrices.

Counterpart of ``torcwa_tpu/ops/attic/eig_qr_pallas_packed.py``
(``schur_qr_pallas_packed``, TPU kernel ``_kernel_packed``): the iteration of
``eig_kernels.schur_qr`` (up to four windows a sweep, stall-gated complex
Wilkinson branch, an exceptional shift every 13th sweep) with the deflation
threshold eps (|d| + |d'|) (multiplier 1, not 4), on H and Z^T stored as
planar rows ``[re(0..n) pad | im(0..n) pad]`` of 2 npad float32, npad = n
rounded up so that the imaginary half starts on a 128-byte line.  The budget
is ``max_iter_factor n`` sweeps; where it runs out the eigenvalues are NaN.
The same contract as ``eig_kernels.schur_qr``, so the stage enters
``eig_qr.eig_small(A3, stage)`` or ``eig_qr.SMALL_SCHUR``.

:func:`schur_qr_packed` packs H and Q^T (:func:`pack_planar`), launches
``csrc/schur_qr_packed.cu`` once for a CUDA batch (complex64 only; one thread
block per matrix, rotations applied directly to the packed rows) and unpacks
(:func:`unpack_planar`); it raises for what the kernel does not take.  A CPU
batch goes through :func:`schur_qr_packed_plain`, the shared single-shift
sweeps of ``eig_kernels.py`` under this stage's rules, in the input's
precision; the layout is the kernel's design and changes no number, so the
plain version works on the complex arrays.
"""

import torch

from . import _build
from .eig_kernels import (LAUNCHES, MAX_ITER_FACTOR, _check, _poison,
                          _raise_on, _single_shift_sweeps, _stream)

__all__ = ['schur_qr_packed', 'schur_qr_packed_plain', 'pack_planar',
           'unpack_planar', 'padded', 'PACKED_RULES', 'LINE_FLOATS']

# the TPU kernel's rules (eig_qr_pallas_packed: _NRUNS, the multiplier-free
# threshold, _CPLX_STALL); csrc/single_shift.cuh compiles in the same values
PACKED_RULES = dict(nruns=4, defl_mult=1., cplx_stall=30)
LINE_FLOATS = 32     # float32 values of a 128-byte line


def padded(n):
    """Floats of one half of a packed row: n rounded up to a 128-byte line."""
    return -(-n // LINE_FLOATS) * LINE_FLOATS


def pack_planar(X):
    """(..., n, n) complex -> (..., n, 2 npad) real rows [re | 0 | im | 0]."""
    n, npad = X.shape[-1], padded(X.shape[-1])
    Xp = torch.zeros(X.shape[:-1] + (2 * npad,), dtype=X.real.dtype,
                     device=X.device)
    Xp[..., :n] = X.real
    Xp[..., npad:npad + n] = X.imag
    return Xp


def unpack_planar(Xp, n):
    """The inverse of :func:`pack_planar`: (..., n, 2 npad) -> (..., n, n)."""
    npad = Xp.shape[-1] // 2
    return torch.complex(Xp[..., :n], Xp[..., npad:npad + n])


def _finish(T, Z, hi, sweeps, rot, return_stats):
    T = _poison(T, hi)
    if return_stats:
        return T, Z, (hi, sweeps, rot)
    return T, Z


def _check_args(H, Q):
    on_card = _check('schur_qr_packed', H, Q)
    if H.dtype != Q.dtype:
        raise ValueError('schur_qr_packed: H and Q differ in type')
    return on_card


def schur_qr_packed_plain(H, Q, max_iter_factor=MAX_ITER_FACTOR,
                          return_stats=False, max_iters=None):
    """The plain PyTorch version of :func:`schur_qr_packed` (same
    arguments)."""
    _check_args(H, Q)
    if max_iters is None:
        max_iters = max_iter_factor * H.shape[-1]
    T, Z, hi, sweeps, rot = _single_shift_sweeps(H, Q, max_iters,
                                                 **PACKED_RULES)
    return _finish(T, Z, hi, sweeps, rot, return_stats)


def schur_qr_packed(H, Q, max_iter_factor=MAX_ITER_FACTOR,
                    return_stats=False, max_iters=None):
    """Batched single-shift Schur QR on the packed layout: Hessenberg H and
    its Q, (B, n, n) complex, -> (T, Z) with H = Z T Z^H.

    A matrix that runs out of the ``max_iter_factor n`` sweep budget
    (``max_iters`` sweeps when given) gets NaN eigenvalues.  With
    ``return_stats`` also returns (window bottom, sweeps, rotations applied)
    per matrix, int tensors of shape (B,), bottom 0 meaning converged.  A
    CUDA batch goes through ``csrc/schur_qr_packed.cu`` (complex64 only), a
    CPU batch through the plain version."""
    if not _check_args(H, Q):
        return schur_qr_packed_plain(H, Q, max_iter_factor, return_stats,
                                     max_iters)
    B, n = H.shape[0], H.shape[-1]
    if max_iters is None:
        max_iters = max_iter_factor * n
    # Z goes in transposed, so that a column rotation of Z is a rotation of
    # two contiguous packed rows
    Hp, Ztp = pack_planar(H), pack_planar(Q.mT)
    stats = torch.zeros(B, 3, dtype=torch.int32, device=H.device)
    err = _build.load().torcwa_schur_qr_packed_f32(
        Hp.data_ptr(), Ztp.data_ptr(), stats.data_ptr(), B, n, padded(n),
        max_iters, _stream())
    _raise_on('schur_qr_packed', err)
    LAUNCHES['schur_qr_packed'] += 1
    Z = unpack_planar(Ztp, n).mT.contiguous()
    return _finish(unpack_planar(Hp, n), Z, stats[:, 0], stats[:, 1],
                   stats[:, 2], return_stats)
