"""Blocked eigenvectors of one large triangular Schur factor.

Counterpart of ``torcwa_tpu/ops/vec_blocked.py``.  The unit upper-
triangular Y with T Y = Y diag(lambda) is built in row blocks from the
bottom.  Per block [r0, r1) the contribution of the rows already solved,
S = T[r0:r1, r1:] Y[r1:, :], is one ``torch.matmul`` (it is outside the
Pallas kernel in the JAX package too), and the in-block backward
recurrence

    Y[j, m] = -(S[j, m] + sum_{j<l<r1} T[j, l] Y[l, m]) / D[j, m],  m > j,

with D[j, m] = lambda_j - lambda_m floored in modulus at dmin_m, runs in
the hand-written kernel ``csrc/tri_vectors_blocked.cu``
(:func:`tri_vectors_block`); :func:`tri_vectors_block_plain` is its plain
version.  V = Z Y and the normalisation stay with the caller.
"""

import torch

from . import _build
from .eig_kernels import LAUNCHES, _consts, _raise_on, _stream

__all__ = ['tri_vectors_blocked', 'tri_vectors_block',
           'tri_vectors_block_plain', 'pivot_floor', 'MAX_BLOCK']

# rows of a block: a lane of the kernel keeps the sums of MAX_BLOCK / 32
# of them in registers
MAX_BLOCK = 128


def pivot_floor(T):
    """dmin_m = max(eps max(|lambda_m|, ||T||_1), smlnum): the LAPACK-style
    floor of the pivots lambda_j - lambda_m, per column m."""
    eps, smlnum = _consts(T.dtype)
    lam = torch.diagonal(T)
    tnorm = T.abs().sum(0).amax()
    return torch.clamp(eps * torch.maximum(lam.abs(), tnorm), min=smlnum)


def tri_vectors_block_plain(T, S, dmin, Y, r0, r1, by_columns=False):
    """Rows [r0, r1) of Y in place, from S (r1 - r0, n) and the rows of Y
    below r1; Y must hold the identity in rows [r0, r1).

    Row by row, each row's sum over the rows below it in ascending order;
    with ``by_columns`` in the order of csrc/tri_vectors_blocked.cu: sums
    seeded from S, and each y_j, once formed, added into the sums of the
    rows above it (Y's identity rows with them), so every sum is taken in
    descending order."""
    n = T.shape[-1]
    lam = torch.diagonal(T)
    idx = torch.arange(n, device=T.device)
    sums = S.clone() if by_columns else None
    for j in range(r1 - 1, r0 - 1, -1):
        if by_columns:
            s = sums[j - r0]
        else:
            s = S[j - r0] + T[j, j + 1:r1] @ Y[j + 1:r1]
        d = lam[j] - lam
        dabs = d.abs()
        small = dabs < dmin
        scl = torch.where(small & (dabs > 0),
                          dmin / torch.where(dabs > 0, dabs, 1.), 1.)
        d = torch.where(small & (dabs == 0), dmin.to(T.dtype), d * scl)
        dden = d.real ** 2 + d.imag ** 2
        dden = torch.where(dden > 0, dden, 1.)
        q = -(s * d.conj()) / dden
        Y[j] = torch.where(idx > j, q, Y[j])
        if by_columns:
            sums[:j - r0] += T[r0:j, j, None] * Y[j]
    return Y


def tri_vectors_block(T, S, dmin, Y, r0, r1):
    """One block of the recurrence, in place on Y: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    n = T.shape[-1]
    if not (T.shape == Y.shape == (n, n) and S.shape == (r1 - r0, n)
            and dmin.shape == (n,) and 0 <= r0 < r1 <= n):
        raise ValueError('tri_vectors_block: inconsistent shapes')
    dev = T.device.type
    if dev == 'cpu':
        return tri_vectors_block_plain(T, S, dmin, Y, r0, r1)
    if dev != 'cuda':
        raise RuntimeError(f'tri_vectors_block: no kernel for device {dev!r}')
    if not (T.dtype == S.dtype == Y.dtype == torch.complex64
            and dmin.dtype == torch.float32):
        raise TypeError('tri_vectors_block: the CUDA kernel takes complex64 '
                        f'only (got {T.dtype}); float64 kernels are still to '
                        'be ported')
    if r1 - r0 > MAX_BLOCK:
        raise ValueError(f'tri_vectors_block: block {r1 - r0} > {MAX_BLOCK}')
    for t in (T, S, dmin, Y):
        if not t.is_contiguous() or t.device != T.device:
            raise ValueError('tri_vectors_block: inputs must be contiguous '
                             'and on one device')
    if r0 + 1 >= n:                      # no column right of the block
        return Y
    err = _build.load().torcwa_tri_vectors_block_c64(
        T.data_ptr(), S.data_ptr(), dmin.data_ptr(), Y.data_ptr(), n, r0,
        r1 - r0, _stream())
    _raise_on('tri_vectors_block', err)
    LAUNCHES['tri_vectors_blocked'] += 1
    return Y


def tri_vectors_blocked(T, block=MAX_BLOCK):
    """(n, n) upper-triangular Schur factor -> unit upper-triangular Y."""
    if T.dim() != 2 or T.shape[0] != T.shape[1] or not T.is_complex():
        raise ValueError('tri_vectors_blocked: expected one complex (n, n) '
                         f'matrix, got {tuple(T.shape)} {T.dtype}')
    n = T.shape[-1]
    T = T.contiguous()
    dmin = pivot_floor(T)
    Y = torch.eye(n, dtype=T.dtype, device=T.device)
    for r1 in range(n, 0, -block):
        r0 = max(r1 - block, 0)
        S = (T[r0:r1, r1:] @ Y[r1:]).contiguous()
        tri_vectors_block(T, S, dmin, Y, r0, r1)
    return Y
