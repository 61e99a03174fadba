"""Order (25, 25) on one CUDA card through torcwa_tpu_torch's large-n route:

    python3 order25_check.py

2N = 5202 is the first size at which ``schur_ms`` takes m = 32 shifts, and
``window(32)`` = 192 rows is wider than the 169 rows ``ms_chase`` stages in
shared memory, so the chase works in device memory.  Two steps:

1. ``schur_ms`` at n = 640 with m = 32 (the unstaged chase, several windows)
   on a random complex64 matrix, against complex128 LAPACK;
2. one order-(25, 25) solve of the bench layer (one wavelength, grid 256,
   float32, 500 nm, 10 degrees), forward and raster gradient, against the
   complex128 torch.linalg.eig oracle: launch counts, stage times, peak
   memory.

Checks (exit code 1 if one fails): convergence, eigenvalues and |t_xx|^2
within 1e-4 of the oracle.  The raster-gradient cosine is printed and not
gated: the refinement setting ``eig_qr.REFINE`` was measured at order 20
only.  It shares the scene and the helpers of chip_smoke.py.  Needs no JAX
and no network; allow 900 s.
"""

import math
import sys
import time

import chip_smoke as cs

ORDER = (25, 25)
N_CHECK, M_CHECK = 640, 32


def main():
    import torch
    if not torch.cuda.is_available():
        print('order25_check: CUDA is not available', file=sys.stderr)
        return 2
    from torcwa_tpu_torch._constants import f32_pinned
    # the script's own products in IEEE f32 too
    with f32_pinned():
        return run(torch)


def run(torch):
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import (eig_kernels as ek, eig_qr as eq,
                                      schur_ms as sm, vec_blocked as vb)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    dev = torch.device('cuda', 0)
    c128 = torch.complex128
    smi = cs.smi_line()
    print(f'card: {smi}')

    cs.phase(f'1. schur_ms at n = {N_CHECK}, m = {M_CHECK}, wb = '
             f'{sm.window(M_CHECK)} (chase in device memory)')
    A = cs.rand_c64(torch, N_CHECK, 25, dev)
    H, Q = hessenberg_blocked(A)
    T, Z, st = sm.schur_ms(H, Q, m=M_CHECK, defl_mult=eq.LARGE_DEFL_MULT,
                           return_stats=True)
    w_ref = torch.linalg.eigvals(A.to(c128))
    d = cs.set_dist(torch.diagonal(T).to(c128), w_ref) \
        / float(w_ref.abs().max())
    res, orth, tri = cs.schur_quality(torch, A, T, Z)
    print(f'  (hi, sweeps, aed, skipped) {st[:4]}; eigenvalues vs complex128 '
          f'{d:.2e}; residual {res:.2e}; unitarity {orth:.2e}')
    cs.check(st[0] == 0 and d <= 1e-4 and res <= 1e-5 and orth <= 1e-5
             and tri, f'schur_ms n={N_CHECK} m={M_CHECK}: converged, '
             'eigenvalues <= 1e-4, residual and unitarity <= 1e-5')

    cs.phase(f'2. the order-{ORDER} solve, {cs.LAM_L[0]} nm, '
             f'{cs.WELL_POSED_DEG} deg')
    inc = math.radians(cs.WELL_POSED_DEG)
    eps, A = cs.wave_matrices(torch, tp, ORDER, cs.LAM_L, inc, torch.float32,
                              dev)
    A = A[0].contiguous()
    n = A.shape[-1]
    m = eq.large_shifts(n)
    print(f'  n = {n}, m = {m}, wb = {sm.window(m)}')

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (H, Q), t_h = timed(lambda: hessenberg_blocked(A))
    (T, Z, st), t_s = timed(lambda: sm.schur_ms(
        H, Q, m=m, defl_mult=eq.LARGE_DEFL_MULT, return_stats=True))
    Y, t_v = timed(lambda: vb.tri_vectors_blocked(T))
    res, orth, tri = cs.schur_quality(torch, A, T, Z)
    print(f'  stages, one run each: hessenberg_blocked {t_h:.1f} ms, schur_ms '
          f'{t_s:.1f} ms, tri_vectors_blocked {t_v:.1f} ms [{smi}]')
    print(f'  schur_ms (hi, sweeps, aed-deflated, skipped chases) {st[:4]}, '
          f'{st[4]:.3e} flops done for {st[5]:.3e} needed; Schur residual '
          f'{res:.2e}, unitarity {orth:.2e}')
    cs.check(st[0] == 0 and tri and res <= 1e-4 and orth <= 1e-4,
             'order 25: schur_ms converged, Schur residual and unitarity '
             '<= 1e-4')
    w = torch.diagonal(T)[None]
    V = (Z @ Y)[None]
    V = V / torch.linalg.vector_norm(V, dim=-2, keepdim=True)
    for _ in range(eq.REFINE[0]):
        w, V = eq._refine(A[None], w, V, eq.REFINE[1])
    w_ref = torch.linalg.eigvals(A.to(c128))
    ew = cs.set_dist(w[0].to(c128), w_ref) / float(w_ref.abs().max())
    r1 = float((A @ V[0] - V[0] * w[0]).abs().max() / A.abs().max())
    print(f'  eigenvalues vs complex128 torch.linalg.eig {ew:.2e} of the '
          f'spectral radius; eigen-residual after the refinement {r1:.2e}')
    cs.check(ew <= 1e-4, 'order 25: eigenvalues within 1e-4 of the spectral '
             'radius of the complex128 oracle')
    del H, Q, T, Z, Y, V, w, w_ref

    ek.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (T_k, g_k), t_fg = timed(lambda: cs.fwd_grad(
        torch, tp, eps, cs.LAM_L, ORDER, inc, 'kernels'))
    launches = dict(ek.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f'  fwd+grad through the kernels, one run: {t_fg / 1e3:.3f} '
          f's/solve, peak memory {peak:.3f} GB, launches {launches} [{smi}]')
    cs.check(launches['schur_ms'] > 0 and launches['tri_vectors_blocked'] > 0
             and launches['schur_qr'] == 0,
             'order 25 went through the large-route kernels')
    T_o, g_o = cs.fwd_grad(torch, tp, eps.double(), cs.LAM_L, ORDER, inc,
                           'torch')
    (T_l, g_l), t_l = timed(lambda: cs.fwd_grad(
        torch, tp, eps, cs.LAM_L, ORDER, inc, 'torch'))
    dT = float((T_k.double() - T_o).abs().max())
    print(f'  |t_xx|^2: kernels {T_k.tolist()} oracle {T_o.tolist()} '
          f'torch.linalg.eig complex64 {T_l.tolist()} '
          f'({t_l / 1e3:.3f} s/solve fwd+grad)')
    print(f'  raster-gradient cosine vs the complex128 oracle (not gated): '
          f'kernels {cs.cosine(g_k, g_o):.6f}, torch.linalg.eig complex64 '
          f'{cs.cosine(g_l, g_o):.6f}')
    cs.check(dT <= 1e-4, f'order 25: |t_xx|^2 vs oracle {dT:.2e} <= 1e-4')
    cs.check(bool(torch.isfinite(g_k).all()), 'order 25: gradient finite')

    if cs.FAILURES:
        print(f'\n{len(cs.FAILURES)} check(s) failed:', *cs.FAILURES,
              sep='\n  ')
        return 1
    print('order25_check: ok')
    return 0


if __name__ == '__main__':
    sys.exit(main())
