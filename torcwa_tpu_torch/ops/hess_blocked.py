"""Blocked (compact-WY) Hessenberg reduction of one large matrix.

Counterpart of ``torcwa_tpu/ops/hess_blocked.py`` (LAPACK zgehrd's panel
algorithm, dlahr2 structure), which is plain XLA in the JAX package and
holds no Pallas kernel; here it is plain torch on native complex tensors,
so the GEMV and GEMM calls go to cuBLAS on the card.  Callers pin IEEE
float32 (``_constants.f32_pinned``).

Per panel starting at column k0, width p, trailing size t = n - k0:
  Q_p = P_k0 ... P_k0+p-1 = I - V T V^H                    (compact WY)
  column j of the current matrix, needed to build reflector j:
      u = a0_j - Y (T (V^H e_j)),   Y = A0[k0:, k0:] V     (one GEMV/col)
      c = u - V (T^H (V^H u))
  panel end (all updates touch only rows and columns >= k0):
      A[k0:, k0:] <- M1 - V (T^H (V^H M1)),  M1 = A[k0:, k0:] - Y (T V^H)
      A[:k0, k0:] <- A[:k0, k0:] - (A[:k0, k0:] V) (T V^H)
      Q[:, k0:]   <- Q[:, k0:]   - (Q[:, k0:] V)   (T V^H)
The reflector convention (v = x + phase(x_0) ||x|| e_1, beta = 2/||v||^2)
is that of ``eig_kernels.hessenberg_plain``.

What bounds it on an H100: the per-column GEMV streams the trailing block
from device memory (~n^3/6 elements in all, v being zero above its head),
and each column issues some thirty small launches, so at n = 3362 the
host's launch rate, not the card, sets the time.  A panel's column loop and
its end-of-panel update are the spans ``eig.hess.columns`` and
``eig.hess.update`` (``utils.timing``), so a trace tells the two apart.
"""

import torch

from ..utils import timing

__all__ = ['hessenberg_blocked']


def _panel(A, Q, k0, p):
    """Reduce columns [k0, k0+p) of A in place and fold the panel's
    reflectors into Q."""
    n = A.shape[-1]
    t = n - k0
    cols = min(p, n - 2 - k0)            # the tail panel may be short
    At = A[k0:, k0:]                     # panel-start block, read only here
    V = A.new_zeros(t, p)
    Y = A.new_zeros(t, p)
    T = A.new_zeros(p, p)
    one = torch.ones((), dtype=A.real.dtype, device=A.device)
    with timing.span('eig.hess.columns'):
        for jj in range(cols):
            Vj, Yj, Tj = V[:, :jj], Y[:, :jj], T[:jj, :jj]
            u = At[:, jj] - Yj @ (Tj @ V[jj, :jj].conj())
            c = u - Vj @ (Tj.mH @ (Vj.mH @ u))
            # Householder from the local rows > jj of c: v = x + phase(x_0)
            # ||x|| e_1, so ||v||^2 = 2 ||x|| (||x|| + |x_0|); a division by
            # zero lands in the branch that torch.where discards
            x = c[jj + 1:]
            alpha = x[0]
            xnorm = torch.linalg.vector_norm(x)
            aabs = alpha.abs()
            ph = torch.where(aabs > 0, alpha / aabs, one)
            v = x.clone()
            v[0] += ph * xnorm
            vnorm2 = 2. * xnorm * (xnorm + aabs)
            beta = torch.where(vnorm2 > 0, 2. / vnorm2, 0.)
            T[:jj, jj] = -beta * (Tj @ (V[jj + 1:, :jj].mH @ v))
            T[jj, jj] = beta
            # v is zero above its head: the GEMV reads columns > jj only
            Y[:, jj] = At[:, jj + 1:] @ v
            V[jj + 1:, jj] = v
    with timing.span('eig.hess.update'):
        TVh = T @ V.mH                                      # (p, t)
        M1 = At - Y @ TVh
        A[k0:, k0:] = M1 - V @ (T.mH @ (V.mH @ M1))
        if k0:
            Atop = A[:k0, k0:]
            A[:k0, k0:] = Atop - (Atop @ V) @ TVh
        Qc = Q[:, k0:]
        Q[:, k0:] = Qc - (Qc @ V) @ TVh

@timing.spanned('eig.hess')
def hessenberg_blocked(A, panel=128):
    """(n, n) complex -> (H, Q) with A = Q H Q^H, H upper Hessenberg and
    Q unitary."""
    if A.dim() != 2 or A.shape[0] != A.shape[1] or not A.is_complex():
        raise ValueError('hessenberg_blocked: expected one complex (n, n) '
                         f'matrix, got {tuple(A.shape)} {A.dtype}')
    n = A.shape[-1]
    H = A.clone()
    Q = torch.eye(n, dtype=A.dtype, device=A.device)
    if n > 2:
        p = min(panel, n - 2)
        for k0 in range(0, n - 2, p):
            _panel(H, Q, k0, p)
    idx = torch.arange(n, device=A.device)
    return H.masked_fill(idx[:, None] > idx[None, :] + 1, 0), Q
