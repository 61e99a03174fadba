"""Batched complex eig through the three kernels: Hessenberg -> Schur QR ->
triangular eigenvectors, then V = Z Y and unit-norm columns; complex64
results then take one refinement step with the residual in complex128.

Counterpart of the routing in ``torcwa_tpu/ops/eig_qr_real.py`` (the
batched small-n route, ``_eig_real_batched``).  Every n takes the same
route: these kernels keep H, Z and Y in device memory and have no size
ceiling, so the TPU's VMEM-driven thresholds (``_HBM_MIN_N_SINGLE``,
``_acc_chunk``) do not carry over.  The large-n route (multishift QR,
blocked vectors) is still to be ported.
"""

import torch

from .eig_kernels import hessenberg, schur_qr, tri_vectors

__all__ = ['eig_qr']

# pairs with |E_ij| >= _REFINE_GAP |w_j - w_i| are degenerate at the
# accuracy of the first pass and keep their basis
_REFINE_GAP = 0.1


def _refine(A, w, V):
    """One step of first-order eigenpair refinement of a complex64 result.

    With the residual taken in complex128 (where the complex64 A is exact),
    A V = V (diag(w) + E) and the first-order update is w_i += E_ii and
    V += V F, F_ij = E_ij / (w_j - w_i) off the diagonal.  The single-shift
    QR accumulates ~1e5 rotations into Z, which leaves the eigenvectors of
    close pairs about 10x less accurate than LAPACK's complex64; this step
    brings them to the accuracy of A itself.  Non-converged (NaN) lanes stay
    NaN."""
    A64, w64, V64 = A.to(torch.complex128), w.to(torch.complex128), \
        V.to(torch.complex128)
    R = A64 @ V64 - V64 * w64[..., None, :]
    E = torch.linalg.solve_ex(V64, R)[0]
    gap = w64[..., None, :] - w64[..., :, None]              # w_j - w_i
    off = ~torch.eye(w.shape[-1], dtype=torch.bool, device=w.device)
    ok = off & (E.abs() < _REFINE_GAP * gap.abs())
    F = torch.where(ok, E / torch.where(ok, gap, torch.ones_like(gap)),
                    torch.zeros_like(E))
    V64 = V64 + V64 @ F
    V64 = V64 / torch.linalg.vector_norm(V64, dim=-2, keepdim=True)
    w64 = w64 + torch.diagonal(E, dim1=-2, dim2=-1)
    return w64.to(w.dtype), V64.to(V.dtype)


def eig_qr(A):
    """(..., n, n) complex -> (w (..., n), V (..., n, n)).

    Eigenvalues of lanes that did not converge are NaN.  V has columns of
    unit 2-norm, up to a phase; the downstream RCWA algebra does not
    depend on the phase."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    A3 = A.reshape(-1, n, n).contiguous()
    H, Q = hessenberg(A3)
    T, Z = schur_qr(H, Q)
    w = torch.diagonal(T, dim1=-2, dim2=-1)
    V = Z @ tri_vectors(T)
    nrm = torch.linalg.vector_norm(V, dim=-2, keepdim=True)
    V = V / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    if A3.dtype == torch.complex64:
        w, V = _refine(A3, w, V)
    return w.reshape(batch + (n,)), V.reshape(batch + (n, n))
