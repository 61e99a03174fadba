"""Complex eig through the hand-written kernels, by two routes, then
V = Z Y, unit-norm columns and four refinement steps with the residual in
complex128.

Counterpart of the routing in ``torcwa_tpu/ops/eig_qr_real.py``
(``eig_qr_real``, ``_eig_real_batched``, ``_eig_real_single``):

* n < ``LARGE_MIN_N``: the batched route, one thread block per matrix:
  ``hessenberg`` -> ``schur_qr`` (single shift) -> ``tri_vectors``
  (``eig_kernels.py``);
* n >= ``LARGE_MIN_N``: the large-n route: ``hessenberg_blocked``
  lane by lane (compact-WY panels: each panel's column loop one launch of
  ``csrc/hess_panel.cu``, its end-of-panel update three cuBLAS GEMMs) ->
  ``schur_ms`` once on the batch, its lanes in lock step (windowed
  multishift QR with aggressive early deflation, m = 24 shifts below
  n = 4200, else 32) -> ``tri_vectors_blocked`` lane by lane.

The small route is :func:`eig_small` with the Schur stage passed in:
``eig_qr`` passes ``SMALL_SCHUR`` (``schur_qr``), and the stand-alone stages
``schur_qr_v2``, ``schur_qr_ms`` (through :func:`lane_by_lane`),
``schur_qr_baed`` (batched multishift QR with AED in the launch,
``schur_qr_baed.py``) and ``schur_qr_packed`` (packed-layout single-shift QR,
``schur_qr_packed.py``) run the same composition, Hessenberg -> that stage ->
triangular vectors -> V = Z Y -> unit columns -> refinement, without being on
a route; a whole solve goes through one of them with ``SMALL_SCHUR`` swapped.

The small route's kernels keep H, Z and Y in device memory and have no
size ceiling, but run one block per matrix and a single-shift QR whose
work grows as n^3 sweeps of O(n) latency-bound rotations; the threshold is
where the two routes were measured to cross on an H100 (PERF.md), not the
TPU's VMEM-driven ``_HBM_MIN_N_SINGLE``.
"""

import torch

from .._constants import f32_pinned
from ..utils import timing
from .eig_kernels import hessenberg, schur_qr, tri_vectors
from .hess_blocked import hessenberg_blocked
from .schur_ms import schur_ms
from .vec_blocked import tri_vectors_blocked

__all__ = ['eig_qr', 'eig_small', 'lane_by_lane', 'LARGE_MIN_N']

# matrices of this order and above take the large-n route
LARGE_MIN_N = 512
# the Schur stage of the small route, (H, Q) -> (T, Z) on (B, n, n); read at
# call time, so a check can drive the route through another stage
SMALL_SCHUR = schur_qr
# deflation-threshold multiplier of the multishift QR (eig_qr_real._HBM_DEFL)
LARGE_DEFL_MULT = 4.0
# refinement of the result, complex64 or complex128: (steps, gap).  Pairs with |E_ij| >= gap
# |w_j - w_i| count as degenerate at the accuracy of the pass before and keep
# their basis.  The multishift QR streams ~2000 slab products through Z at
# n = 3362 and leaves a Schur residual of ~1e-5 ||A||, ten times the small
# route's, where 38 eigenvalue pairs lie closer than 1e-2 (spectral radius
# 2286): with gap 0.1 those pairs are never touched and the raster-gradient
# cosine stops at 0.96-0.99.  Gap 1.0, the edge of where the first-order
# update still contracts, and four steps reach 0.997-0.9998 on four order-20
# scenes; one step less or gap 0.5 falls to 0.96-0.99 on one of them.  The
# small route holds its gates with one step already; it takes the same four
# (+10 to 30 ms on a 270 ms order-6 sweep), which also lifts its 0.2 degree
# cosine from 0.889 to 0.998 (H100, refine_scenes.py, PERF.md)
REFINE = (4, 1.0)


def _refine(A, w, V, gap=REFINE[1]):
    """One step of first-order eigenpair refinement.

    With the residual taken in complex128 (where a complex64 A is exact),
    A V = V (diag(w) + E) and the first-order update is w_i += E_ii and
    V += V F, F_ij = E_ij / (w_j - w_i) off the diagonal.  The single-shift
    QR accumulates ~1e5 rotations into Z, which leaves the eigenvectors of
    close pairs about 10x less accurate than LAPACK's complex64; this step
    brings them to the accuracy of A itself.  A complex128 result takes it
    in its own precision, which still removes what the rotations added:
    at order (2, 2), 0.2 degrees, the raster gradient's distance from the
    JAX package's falls from 2.1e-6 to 5.6e-7 (LAPACK's own: 9.4e-7).
    Pairs with |E_ij| >= gap |w_j - w_i| keep their basis.  Non-converged
    (NaN) lanes stay NaN."""
    A64, w64, V64 = A.to(torch.complex128), w.to(torch.complex128), \
        V.to(torch.complex128)
    R = A64 @ V64 - V64 * w64[..., None, :]
    E = torch.linalg.solve_ex(V64, R)[0]
    dw = w64[..., None, :] - w64[..., :, None]               # w_j - w_i
    off = ~torch.eye(w.shape[-1], dtype=torch.bool, device=w.device)
    ok = off & (E.abs() < gap * dw.abs())
    F = torch.where(ok, E / torch.where(ok, dw, torch.ones_like(dw)),
                    torch.zeros_like(E))
    V64 = V64 + V64 @ F
    V64 = V64 / torch.linalg.vector_norm(V64, dim=-2, keepdim=True)
    w64 = w64 + torch.diagonal(E, dim1=-2, dim2=-1)
    return w64.to(w.dtype), V64.to(V.dtype)


def large_shifts(n):
    """Shifts per sweep of the multishift QR (eig_qr_real._hbm_shifts)."""
    return 24 if n < 4200 else 32


def _stack(xs):
    """The (n, n) tensors xs as one (B, n, n); a view of the one for B = 1."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def _eig_large(A3):
    """(B, n, n) through the large-n route: (w, V), V = Z Y not yet
    normalised.  The Hessenberg and vector stages run lane by lane, the
    Schur stage once over the batch."""
    lanes = [hessenberg_blocked(a) for a in A3]
    T, Z = schur_ms(_stack([h for h, _ in lanes]),
                    _stack([q for _, q in lanes]),
                    m=large_shifts(A3.shape[-1]), defl_mult=LARGE_DEFL_MULT)
    with timing.span('eig.vectors'):
        return (torch.diagonal(T, dim1=-2, dim2=-1),
                _stack([z @ tri_vectors_blocked(t) for t, z in zip(T, Z)]))


def _finish(A3, w, V):
    """Unit-norm columns and the refinement steps."""
    nrm = torch.linalg.vector_norm(V, dim=-2, keepdim=True)
    V = V / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    with timing.span('eig.refine'):
        for _ in range(REFINE[0]):
            w, V = _refine(A3, w, V, REFINE[1])
    return w, V


def lane_by_lane(stage, **kw):
    """A batched Schur stage (H, Q) -> (T, Z) on (B, n, n) from one that
    takes a single matrix, e.g. ``lane_by_lane(schur_qr_ms, m=16)``."""
    def batched(H, Q):
        lanes = [stage(h, q, **kw) for h, q in zip(H, Q)]
        return (torch.stack([l[0] for l in lanes]),
                torch.stack([l[1] for l in lanes]))
    return batched


def eig_small(A3, schur=None):
    """(B, n, n) through the batched composition: ``hessenberg`` -> the
    Schur stage ``schur(H, Q) -> (T, Z)`` (default ``SMALL_SCHUR``) ->
    ``tri_vectors`` -> V = Z Y -> unit columns -> refinement."""
    H, Q = hessenberg(A3)
    T, Z = (SMALL_SCHUR if schur is None else schur)(H, Q)
    w = torch.diagonal(T, dim1=-2, dim2=-1)
    with timing.span('eig.vectors'):
        V = Z @ tri_vectors(T)
    return _finish(A3, w, V)


def eig_qr(A):
    """(..., n, n) complex -> (w (..., n), V (..., n, n)).

    Eigenvalues of lanes that did not converge are NaN.  V has columns of
    unit 2-norm, up to a phase; the downstream RCWA algebra does not
    depend on the phase."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    A3 = A.reshape(-1, n, n).contiguous()
    large = n >= LARGE_MIN_N
    with f32_pinned(), timing.span('eig', n=n, batch=A3.shape[0],
                                   route='large' if large else 'small'):
        if large:
            w, V = _finish(A3, *_eig_large(A3))
        else:
            w, V = eig_small(A3)
    return w.reshape(batch + (n,)), V.reshape(batch + (n, n))
