"""GPU smoke run of torcwa_tpu_torch: build, check and time the eig kernels
and drive the Example-1 sweep (order 6, 8 wavelengths, grid 256, float32)
forward and backward through them on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1. environment: versions, card, power limit, nvcc; IEEE f32 pinned
  2. build: nvcc the kernels in torcwa_tpu_torch/csrc
  3. each kernel against its plain PyTorch version on the card, on random
     complex64 matrices (B=2, n=48) and on the order-6 wave matrices
     A = P Q (B=8, n=338) built by the port's own pq_pair
  4. the slice: launch counts of the main path, |t_xx|^2 and the raster
     gradient against a complex128 torch.linalg.eig oracle at 0, 0.2 and
     10 degrees, at order 6 and at order 10 (2N = 882, one wavelength)
  5. times with CUDA events (median of 5 after a warm-up)
  6. torch.profiler over one sweep: device time by kernel, idle share
The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Needs no JAX and no network.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

L = (300., 300.)
WIDTH = 160.
THICK = 600.
EPS_HI = 2.0709 ** 2
EPS_SUB = 1.46 ** 2
GRID = 256
LAMS = np.linspace(400., 700., 8)
# gradient checks: float32 resolves the mode pairs from this tilt on
WELL_POSED_DEG = 10.

REPLACES = {
    'hessenberg': 'torcwa_tpu/ops/eig_qr_pallas.py:889',
    'schur_qr': 'torcwa_tpu/ops/eig_qr_pallas.py:351',
    'tri_vectors': 'torcwa_tpu/ops/eig_qr_pallas.py:768',
}
SOURCES = {
    'hessenberg': 'torcwa_tpu_torch/csrc/hessenberg.cu',
    'schur_qr': 'torcwa_tpu_torch/csrc/schur_qr.cu',
    'tri_vectors': 'torcwa_tpu_torch/csrc/tri_vectors.cu',
}


FAILURES = []


def check(cond, msg):
    """Record a check; the run goes on so that one call shows every
    failure, and exits non-zero at the end if any check failed."""
    if not cond:
        FAILURES.append(msg)
    print(f'  {"ok" if cond else "FAILED"}  {msg}', flush=True)


def phase(name):
    print(f'\n== {name}', flush=True)


def smi_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=5):
    """Median milliseconds of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def nearest_err(w, w_ref):
    """Largest distance from an eigenvalue of w to its nearest in w_ref."""
    return float((w[..., :, None] - w_ref[..., None, :]).abs()
                 .amin(-1).amax())


def wave_matrices(torch, tp, order, lams, inc, dtype, dev):
    """A = P Q of the bench layer at every wavelength: (B, 2N, 2N)."""
    from torcwa_tpu_torch.ops.fourier import material_conv
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=GRID, ny=GRID, edge_sharpness=500.,
                    dtype=dtype, device=dev)
    occ = g.rectangle(WIDTH, WIDTH, L[0] / 2., L[1] / 2.)
    eps = occ * EPS_HI + (1. - occ)
    freq = torch.as_tensor(1. / lams, dtype=dtype, device=dev)
    kx, ky = tp.kvectors_real(freq, inc, 0., math.sqrt(EPS_SUB), order, L,
                              dtype)
    P, Q = tp.pq_pair(material_conv(eps, order), kx, ky)
    return eps, P @ Q


def kernel_checks(torch, ek, A, label, record, elementwise):
    """Phase 3 on one batch of matrices; fills `record` with the errors.

    Hessenberg: the backward error ||Q H Q^H - A||_F / ||A||_F of kernel
    and plain version is held to 1e-5, Q's departure from unitarity to
    1e-5, and the two reconstructions Q H Q^H to 1e-5 ||A||_F of each
    other.  With ``elementwise`` H and Q themselves must agree, H within
    1e-4 ||A||_2 and Q within 1e-4.  That holds only where the reduction
    is forward-stable: on the wave matrices the subdiagonal falls to
    ~1e-5 max|A| (a near-breakdown of the Krylov sequence), and two
    float32 reductions that sum in different orders, or one float32 and
    one float64 reduction, then differ at O(max|A|) while both are
    backward-stable, so there only the gauge-free checks apply."""
    from torcwa_tpu_torch.ops.eig_kernels import (hessenberg_plain,
                                                  schur_qr_plain,
                                                  tri_vectors_plain)
    print(f'-- {label}: B={A.shape[0]} n={A.shape[-1]}', flush=True)
    n = A.shape[-1]
    amax = float(A.abs().max())
    afro = torch.linalg.matrix_norm(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)

    H, Q = ek.hessenberg(A)
    t0 = time.perf_counter()
    Hp, Qp = hessenberg_plain(A)
    torch.cuda.synchronize()
    print(f'  plain hessenberg {time.perf_counter() - t0:.2f} s')
    eh = float((H - Hp).abs().max())
    eq = float((Q - Qp).abs().max())
    rec = Q @ H @ Q.mH
    res = float((torch.linalg.matrix_norm(rec - A) / afro).max())
    res_p = float((torch.linalg.matrix_norm(Qp @ Hp @ Qp.mH - A)
                   / afro).max())
    orth = float((Q.mH @ Q - eye).abs().max())
    drec = (rec - Qp @ Hp @ Qp.mH).abs().amax((-2, -1))
    sub = torch.diagonal(Hp, -1, dim1=-2, dim2=-1).abs().min()
    print(f'  hess: max|dH| = {eh:.3e} ({eh / amax:.2e} max|A|), max|dQ| = '
          f'{eq:.3e}, smallest subdiagonal {float(sub) / amax:.2e} max|A|; '
          f'||QHQ^H - A||/||A|| kernel {res:.2e} plain {res_p:.2e}; '
          f'max|Q^H Q - I| = {orth:.2e}; '
          f'max|QHQ^H - (QHQ^H)_plain| = {float(drec.max()):.3e}')
    check(res <= 1e-5 and res_p <= 1e-5,
          'hessenberg residual (kernel and plain) <= 1e-5')
    check(orth <= 1e-5, 'hessenberg Q unitary within 1e-5')
    check(bool((drec <= 1e-5 * afro).all()),
          'hessenberg kernel and plain reconstruct the same matrix within '
          '1e-5 ||A||_F')
    if elementwise:
        a2 = torch.linalg.matrix_norm(A, ord=2)
        dh = (H - Hp).abs().amax((-2, -1))
        check(bool((dh <= 1e-4 * a2).all()) and eq <= 1e-4,
              'hessenberg kernel == plain element-wise: H within '
              '1e-4 ||A||_2, Q within 1e-4')

    T, Z, (hi, sw) = ek.schur_qr(H, Q, return_stats=True)
    # the plain QR runs ~1e5 small launches (~100 s at B=8 n=338): it is
    # timed once, here, with CUDA events; the plain Hessenberg above has
    # warmed the same operators
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    Tp, Zp, hip, swp = schur_qr_plain(H, Q)
    ev[1].record()
    ev[1].synchronize()
    qr_plain_ms = ev[0].elapsed_time(ev[1])
    print(f'  plain schur_qr {qr_plain_ms / 1e3:.2f} s')
    print(f'  sweeps kernel {sw.tolist()} plain {swp.tolist()}')
    check(bool((hi == 0).all()), 'schur_qr: every lane converged')
    w = torch.diagonal(T, dim1=-2, dim2=-1)
    w_ref = torch.linalg.eigvals(H.to(torch.complex128))
    ew = nearest_err(w.to(torch.complex128), w_ref) \
        / float(w_ref.abs().max())
    ewp = nearest_err(w.to(torch.complex128),
                      torch.diagonal(Tp, dim1=-2, dim2=-1)
                      .to(torch.complex128))
    rz = float((torch.linalg.matrix_norm(Z @ T @ Z.mH - A) / afro).max())
    print(f'  qr: eig rel err vs complex128 {ew:.2e}, vs plain (abs) '
          f'{ewp:.2e}, ||Z T Z^H - A||/||A|| = {rz:.2e}')
    check(ew <= 1e-4, 'schur_qr eigenvalues vs torch.linalg.eig <= 1e-4')
    check(rz <= 1e-5, 'schur_qr residual <= 1e-5')
    mk, mp = int(sw.max()), int(swp.max())
    check(abs(mk - mp) <= 0.3 * mp,
          f'sweeps kernel {mk} within 30% of plain {mp}')

    Y = ek.tri_vectors(T)
    Yp = tri_vectors_plain(T)
    V = Z @ Y
    V = V / torch.linalg.vector_norm(V, dim=-2, keepdim=True)
    Vp = Z @ Yp
    Vp = Vp / torch.linalg.vector_norm(Vp, dim=-2, keepdim=True)
    ey = float((Y - Yp).abs().max()) / float(Yp.abs().max())
    ev = float((V - Vp).abs().max())
    # eigenpair residuals ||A v - w v|| / ||A||: gauge- and basis-free
    r_k = float(((A @ V - V * w[..., None, :]).abs().amax((-2, -1))
                 / A.abs().amax((-2, -1))).max())
    r_p = float(((A @ Vp - Vp * w[..., None, :]).abs().amax((-2, -1))
                 / A.abs().amax((-2, -1))).max())
    # columns whose eigenvalue is separated from all others by > 1e-3 of
    # the spectral radius: there y = -s / (l_j - l_m) is well conditioned
    gap = (w[..., :, None] - w[..., None, :]).abs()
    gap = gap + torch.eye(w.shape[-1], device=w.device) * 1e30
    sep = gap.amin(-1) > 1e-3 * w.abs().amax(-1, keepdim=True)
    ev_sep = float(((V - Vp).abs().amax(-2) * sep).max())
    print(f'  vec: max|dY|/max|Y| = {ey:.2e}, max|dV| = {ev:.2e} '
          f'(separated columns {int(sep.sum())}/{sep.numel()}: {ev_sep:.2e}),'
          f' residual kernel {r_k:.2e} plain {r_p:.2e}')
    record.update(hess=float(drec.max()), qr=ewp, vec=ev, vec_sep=ev_sep,
                  ey=ey, r_k=r_k, r_p=r_p, qr_plain_ms=qr_plain_ms)
    return H, Q, T


def slice_loss(torch, tp, eps, lams, order, inc, backend):
    from torcwa_tpu_torch.fmm import solve_stack_pair, sparam_xy_pair
    spec = tp.StackSpec(order=order, L=L, n_layers=1, has_input=True)
    cdt = torch.complex64 if eps.dtype == torch.float32 else torch.complex128
    freq = torch.as_tensor(1. / lams, dtype=eps.dtype, device=eps.device)
    e_in = torch.tensor(EPS_SUB, dtype=cdt, device=eps.device)
    S, intr = solve_stack_pair(
        spec, freq, inc, 0., eps[None],
        torch.tensor([THICK], dtype=eps.dtype, device=eps.device),
        eps_in=e_in, eig_backend=backend)
    t = sparam_xy_pair(S, intr['kx'], intr['ky'], e_in, 1., order, [0, 0],
                       [0, 0], 'xx')
    T = t.real[..., 0] ** 2 + t.imag[..., 0] ** 2
    return T


def fwd_grad(torch, tp, eps, lams, order, inc, backend):
    er = eps.detach().clone().requires_grad_(True)
    T = slice_loss(torch, tp, er, lams, order, inc, backend)
    T.mean().backward()
    return T.detach(), er.grad


def cosine(a, b):
    a = a.double().flatten()
    b = b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def grad_checks(torch, tp, eps32, lams, order, tilt_deg):
    """Forward and raster gradient at `tilt_deg` through the kernels
    (float32) against the complex128 torch.linalg.eig oracle.

    Checked at every tilt: |t_xx|^2 within 1e-4 and a finite gradient.
    At 10 deg, where the closest mode pairs are ~1e-3 apart and float32
    resolves them, the whole raster gradient must have cosine >= 0.99 with
    the oracle's.  At 0.2 deg pairs of modes in different symmetry sectors
    are ~1e-6 apart and float32 round-off in A itself mixes them (an exact
    eig of the float32 A scores a cosine of -0.45 there, see PERF.md), so
    the cosine is printed only, and the derivative along the meta-atom's
    own raster (the pillar permittivity, the knob of a design sweep) must
    lie within 5% of the oracle's, the tolerance of the JAX package's
    float32 gradient test (tests/test_f32_broadening.py).  The cosine of
    torch.linalg.eig in complex64 on the same float32 pipeline is printed
    beside the kernels' at both tilts."""
    inc = math.radians(tilt_deg)
    label = f'order {order[0]}, {len(lams)} wavelength(s), {tilt_deg} deg'
    T_k, g_k = fwd_grad(torch, tp, eps32, lams, order, inc, 'kernels')
    T_o, g_o = fwd_grad(torch, tp, eps32.double(), lams, order, inc, 'torch')
    _, g_l = fwd_grad(torch, tp, eps32, lams, order, inc, 'torch')
    occ = (eps32.double() - 1.) / (EPS_HI - 1.)
    d_o, d_k, d_l = (float((g.double() * occ).sum()) for g in (g_o, g_k,
                                                               g_l))
    dT = float((T_k.double() - T_o).abs().max())
    rel = abs(d_k - d_o) / abs(d_o)
    cos_k = cosine(g_k, g_o)
    print(f'  {label}: |t_xx|^2 kernels {T_k.tolist()} oracle {T_o.tolist()}')
    print(f'  {label}: gradient cosine vs oracle: kernels {cos_k:.6f}, '
          f'torch.linalg.eig complex64 {cosine(g_l, g_o):.6f}; '
          f'pillar-direction derivative oracle {d_o:.6e} kernels {d_k:.6e} '
          f'({rel:.2e} rel) complex64 {d_l:.6e} '
          f'({abs(d_l - d_o) / abs(d_o):.2e} rel)')
    check(dT <= 1e-4, f'{label}: |t_xx|^2 vs oracle {dT:.2e} <= 1e-4')
    check(bool(torch.isfinite(g_k).all()), f'{label}: gradient finite')
    if tilt_deg >= WELL_POSED_DEG:
        check(cos_k >= 0.99, f'{label}: raster gradient cosine {cos_k:.6f} '
              f'>= 0.99')
    else:
        check(rel <= 0.05, f'{label}: pillar-direction derivative within 5% '
              f'of the oracle')


def profile_sweep(torch, tp, eps32):
    """torch.profiler over one order-6 fwd+grad sweep: device time by
    kernel, and the share of the unprofiled wall time the card is idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def sweep():
        fwd_grad(torch, tp, eps32, LAMS, (6, 6), 0., 'kernels')
        torch.cuda.synchronize()

    sweep()
    t0 = time.perf_counter()
    for _ in range(3):
        sweep()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    ours = [e for e in kern if any(k + '_kernel' in e.key for k in REPLACES)]
    eig_ms = sum(e.self_device_time_total for e in ours) / 1e3
    n_other = sum(e.count for e in kern) - sum(e.count for e in ours)
    print(f'  wall per sweep (no profiler, mean of 3) {wall_ms:.3f} ms; '
          f'device kernels {busy:.3f} ms (idle {1 - busy / wall_ms:.3f} of '
          f'the wall); the eig kernels {eig_ms:.3f} ms; other kernels '
          f'{busy - eig_ms:.3f} ms in {n_other} launches')
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f'  {e.self_device_time_total / 1e3:10.3f} ms x{e.count:5d}  '
              f'{e.key[:100]}')
    check(len(ours) == len(REPLACES), 'the profile shows the three eig '
          'kernels')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch._constants import (f32_precision_pinned,
                                             pin_f32_precision)
    from torcwa_tpu_torch.ops import _build, eig_kernels as ek
    from torcwa_tpu_torch.ops.eig_kernels import (hessenberg_plain,
                                                  schur_qr_plain,
                                                  tri_vectors_plain)
    dev = torch.device('cuda', 0)
    torch.manual_seed(0)

    phase('1. environment')
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    nvcc = subprocess.run([_build._nvcc(), '--version'], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
          f'cuda {torch.version.cuda}')
    print(f'device {name}  count {torch.cuda.device_count()}')
    print(f'nvidia-smi: {smi}')
    print(f'nvcc: {nvcc[-1]}')
    pin_f32_precision()
    check(f32_precision_pinned(), 'IEEE f32 pinned (no TF32 in matmul or '
          'cudnn, float32 matmul precision highest)')

    phase('2. build')
    t0 = time.perf_counter()
    _build.load()
    print(f'build {time.perf_counter() - t0:.1f} s '
          f'(cached={_build.build_info["cached"]}) -> '
          f'{_build.build_info["path"]}')
    for line in _build.build_info['log'].splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            print('  ptxas:', line.strip())

    phase('3. kernels against their plain versions')
    rng = np.random.default_rng(0)
    A_rand = torch.as_tensor(
        (rng.standard_normal((2, 48, 48))
         + 1j * rng.standard_normal((2, 48, 48))).astype(np.complex64),
        device=dev)
    rec_rand, rec_main = {}, {}
    kernel_checks(torch, ek, A_rand, 'random complex64', rec_rand, True)
    check(rec_rand['ey'] <= 1e-4 and rec_rand['vec'] <= 1e-4,
          'tri_vectors kernel == plain: Y and V within 1e-4 relative')
    H, Q = ek.hessenberg(A_rand)
    T1, _, (hi1, _) = ek.schur_qr(H, Q, max_iter_factor=1, return_stats=True)
    d1 = torch.diagonal(T1, dim1=-2, dim2=-1)
    check(bool((hi1 > 0).all()) and bool(torch.isnan(d1).all()),
          'max_iter_factor=1 forces non-convergence: NaN eigenvalues')

    _, A6 = wave_matrices(torch, tp, (6, 6), LAMS, 0., torch.float32, dev)
    H6, Q6, T6 = kernel_checks(torch, ek, A6.contiguous(),
                               'order-6 wave matrices', rec_main, False)
    check(rec_main['vec_sep'] <= 1e-4,
          'tri_vectors kernel == plain within 1e-4 on separated columns')
    check(rec_main['r_k'] <= 10 * rec_main['r_p'] + 1e-6,
          'tri_vectors kernel eigen-residual on par with the plain version')

    phase('4. the slice (order 6, 8 wavelengths, grid 256, float32)')
    eps32, _ = wave_matrices(torch, tp, (6, 6), LAMS[:1], 0., torch.float32,
                             dev)
    eps64 = eps32.double()
    ek.reset_launch_counts()
    T_k, g_k = fwd_grad(torch, tp, eps32, LAMS, (6, 6), 0., 'kernels')
    torch.cuda.synchronize()
    launches = dict(ek.LAUNCHES)
    print(f'  launches on the main path: {launches}')
    for k, v in launches.items():
        check(v > 0, f'{k} kernel launched on the main path ({v})')
    T_o, _ = fwd_grad(torch, tp, eps64, LAMS, (6, 6), 0., 'torch')
    dT = float((T_k.double() - T_o).abs().max())
    print(f'  |t_xx|^2 kernels {T_k.tolist()}')
    print(f'  |t_xx|^2 oracle  {T_o.tolist()}')
    check(dT <= 1e-4, f'|t_xx|^2 vs complex128 oracle: {dT:.2e} <= 1e-4')
    check(bool(torch.isfinite(g_k).all()), 'raster gradient finite')
    for tilt_deg in (0.2, WELL_POSED_DEG):
        grad_checks(torch, tp, eps32, LAMS, (6, 6), tilt_deg)
        grad_checks(torch, tp, eps32, LAMS[3:4], (10, 10), tilt_deg)
    check(f32_precision_pinned(), 'IEEE f32 still pinned after the slice')

    phase('5. times (CUDA events, median of 5 after one warm-up)')
    print(f'card: {smi}')
    n_lam = len(LAMS)
    ms_k = cuda_ms(torch, lambda: fwd_grad(torch, tp, eps32, LAMS, (6, 6),
                                           0., 'kernels'))
    ms_o = cuda_ms(torch, lambda: fwd_grad(torch, tp, eps32, LAMS, (6, 6),
                                           0., 'torch'))
    print(f'  order-6 fwd+grad, eig kernels: {ms_k / n_lam / 1e3:.6f} s/solve '
          f'({ms_k:.3f} ms per 8-wavelength sweep) [{smi}]')
    print(f'  order-6 fwd+grad, torch.linalg.eig ORACLE (complex64): '
          f'{ms_o / n_lam / 1e3:.6f} s/solve [{smi}]')
    A6c = A6.contiguous()
    times = {}
    times['hessenberg'] = (cuda_ms(torch, lambda: ek.hessenberg(A6c)),
                           cuda_ms(torch, lambda: hessenberg_plain(A6c)),
                           'B=8 n=338')
    times['schur_qr'] = (cuda_ms(torch, lambda: ek.schur_qr(H6, Q6)),
                         rec_main['qr_plain_ms'],
                         'B=8 n=338; plain: one run, in phase 3')
    times['tri_vectors'] = (cuda_ms(torch, lambda: ek.tri_vectors(T6)),
                            cuda_ms(torch, lambda: tri_vectors_plain(T6)),
                            'B=8 n=338')
    for k, (tk, tpl, shape) in times.items():
        print(f'  {k}: kernel {tk:.3f} ms, plain {tpl:.3f} ms ({shape}) '
              f'[{smi}]')

    phase('6. profile of one order-6 fwd+grad sweep (torch.profiler)')
    profile_sweep(torch, tp, eps32)

    if FAILURES:
        print(f'\n{len(FAILURES)} check(s) failed:', *FAILURES, sep='\n  ')
        return 1
    errs = {'hessenberg': rec_main['hess'], 'schur_qr': rec_main['qr'],
            'tri_vectors': rec_main['vec_sep']}
    kernels = [{'name': k, 'route': 'cuda', 'source': SOURCES[k],
                'replaces': REPLACES[k], 'launches': launches[k],
                'max_abs_err': errs[k], 'ms': times[k][0],
                'plain_ms': times[k][1]} for k in REPLACES]
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
