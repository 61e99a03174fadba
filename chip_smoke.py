"""GPU smoke run of torcwa_tpu_torch: build, check and time the eig kernels
and drive the port's paths on one CUDA card, forward and backward: the
Example-1 sweep (order 6, 8 wavelengths, grid 256, float32) through the
batched small-n kernels, one order-(20, 20) solve (2N = 3362) through the
large-n route, the composed eig through the two stand-alone Schur
stages (schur_qr_v2 on the order-6 batch, schur_qr_ms on one matrix at
orders 6 to 8 and inside one order-(7, 7) solve), the order-6 and order-7
8-wavelength sweeps through the two batched stages that are on no route
(schur_qr_baed, schur_qr_packed), a three-layer stack through the
class API (rcwa, with the a-Si:H table of materials), and the two
optimisation examples (examples/torch/, Examples 5 and 6 at their published
orders, one matrix at n = 882 and 1054 through the large route) for a few
ADAM steps through optim.maximize_adam, and the sweep path: Examples 0-4
(examples/torch/; Example 1 at order 15 and Example 3 at order 20 through
the large route, one raster a lane in a batched solve) and the sweeps split
over devices (parallel).

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1. environment: versions, card, power limit, nvcc; the script runs in
     an IEEE f32 scope (_constants.f32_pinned)
  2. build: nvcc the kernels in torcwa_tpu_torch/csrc
  3. each small-route kernel against its plain PyTorch version on the card,
     on random complex64 matrices (B=2, n=48) and on the order-6 wave
     matrices A = P Q (B=8, n=338) built by the port's own pq_pair, with
     the kernel hessenberg takes there (cluster size, shared memory,
     clusters at once) and the one tri_vectors takes (a warp per column
     with its register slots, or one block a matrix); schur_qr's per-lane
     stats beside the per-rotation
     kernel's it replaced (QR_STATS_PER_ROTATION); after a budget of sweeps
     on a random batch,
     schur_qr element by element against the plain model of its windowed
     schedule
  4. the large-route kernels against their plain versions: the multishift
     QR at n = 300 and 640, one sweep of chase windows at n = 640 against
     the plain float32 and float64 chases, the slab products, the blocked
     vectors (against the plain recurrence by rows and by columns, the
     kernel's order) and the blocked Hessenberg reduction at n = 640 against
     the batched one, the NaN contract
  5. the order-6 slice: launch counts of the main path, |t_xx|^2 and the
     raster gradient against a complex128 torch.linalg.eig oracle at 0, 0.2
     and 10 degrees at order 6, and at 10 degrees at order 10 (2N = 882, one
     wavelength, which takes the large route)
  6. the order-20 slice: the three stages alone on A = P Q, two sweeps and
     the blocked vectors against their plain versions at this size, one
     fwd+grad with launch counts, |t_xx|^2 and the 10-degree raster gradient
     against the complex128 oracle; then normal incidence (degenerate mode
     pairs): the multishift QR converges and the forward |t_xx|^2 agrees
     with the oracle
  7. times with CUDA events (schur_qr beside the kernel it replaced;
     hessenberg at n = 338 and 450, with its cluster size and the
     clusters the card runs at once; torch.linalg.eig
     of the triangular factor beside the two vectors kernels); the two
     routes at n = 338, 450, 578 and 882
  8. torch.profiler over one order-6 sweep and one order-20 solve: device
     time by kernel, idle share
  9. the stand-alone stages against their plain versions: schur_qr_v2 at
     (2, 48), schur_qr_ms at n = 64 and 200 (with the kernel its entry
     point takes: a cluster of P CTAs, or one block), schur_ms(aed=False)
     at n = 160
     (and at n = 640 against complex128 LAPACK), the NaN / no-NaN contracts
 10. the composed eig (Hessenberg -> stage -> vectors -> refinement) at full
     width: schur_qr_v2 on the (8, 338, 338) order-6 batch, schur_qr_ms on
     one wave matrix at n = 338, 450 and 578 (with its kernel's cluster
     size and Z's placement), then one order-(7, 7) solve,
     forward and raster gradient, with the small route's Schur stage swapped
     to schur_qr_ms, against the complex128 oracle
 11. times of the stand-alone stages beside schur_qr and the two routes;
     schur_qr and schur_qr_v2 beside the kernel they replaced
 12. schur_qr_baed and schur_qr_packed against their plain versions on
     random complex64 batches at (2, 96) and (8, 112), lanes of different
     kinds in one schur_qr_baed launch, the NaN contracts, what they refuse
 13. the path at full width: the composed eig through each of the two on the
     (8, 338, 338) order-6 and (8, 450, 450) order-7 wave matrices, then the
     8-wavelength sweep, forward and raster gradient, with the small route's
     Schur stage swapped: schur_qr_baed at order 6 (0 and 10 degrees) and
     order 7 (10 degrees), schur_qr_packed at order 6 (10 degrees), against
     the complex128 oracle
 14. times of the two beside schur_qr at B = 8 and n = 338, 450, 578, with
     the kernel schur_qr_baed launches there (the cluster size, its shared
     memory, the clusters the card runs at once); each against its plain
     version at the path's shape (8, 338, 338): the state after a budget of
     sweeps on the wave matrices, one sweep element by element on a random
     batch (schur_qr_baed also at n = 450 and 578, on its other two
     kernels); the composed eig and the order-6 sweep through each, and the
     B = 8 batch through the large route at n = 450 and 578
 15. the class API: a-Si:H rectangle (300 nm), SU-8 spacer (200 nm,
     homogeneous), SiN circle (150 nm) between the substrate and air, order
     (6, 6), 532 nm, 10 degrees, complex64 through the eig kernels, forward
     and raster gradient, against the same class at complex128 through
     torch.linalg.eig (|S|^2, field_xz, gradient cosine); one layer at
     order (10, 10) against solve_stack_pair; launch counts, the kernels by
     name in a profile and no library eig, times, device time and idle
     share; with TF32 switched on outside, every product, solve and inverse
     of the forward and backward in IEEE f32 and the setting restored
 16. Example 5 (examples/torch/example5_shape_optimization.py: a-Si:H
     rectangle, 532 nm, order (10, 10), grid 300 x 300, FoM |t_yy - t_xx|)
     at its published configuration: EX_STEPS ADAM steps through
     maximize_adam and the eig kernels; every FoM and gradient finite, the
     FoM up, step 0 against the complex128 torch.linalg.eig oracle, a
     profiled step that names schur_ms's and tri_vectors_blocked's kernels
     and no library eig, the gradient at 10 degrees against the oracle's;
     s/iter beside the same loop through torch.linalg.eig (complex64),
     device time, idle share, peak memory, schur_ms's launches a step, and
     the large route's stages alone on the layer's matrix (n = 882)
 17. Example 6 (example6_topology_optimization.py: 700 x 300 nm cell,
     order (15, 8), grid 700 x 300, blur, projection, symmetrization) the
     same way (n = 1054); at 10 degrees the whole-density gradient cosine
 18. on each example's step-0 matrix: the whole Schur form against
     complex128 eigenvalues, two sweeps of schur_ms against its plain
     version from the same H, Q, and tri_vectors_blocked against its plain
     version on the same T (phase 6's tolerances)
 19. Examples 0, 2 and 4 (examples/torch/, the class API): Example 0's
     reflectances against Fresnel (0-80 degrees); Example 2 at order (5, 5)
     (n = 242, the small route): |E|^2 on the xz plane and the mid-layer xy
     cut against the same class at complex128 through torch.linalg.eig, the
     twin's envelope; Example 4 at order (4, 4): the float64 broadened
     dT/dR (torch.linalg.eig) against the finite difference and against
     tests/golden/example4.npz, and the float32 dT/dR through the kernels
     against the float64 one; the small route's kernels against their plain
     versions at n = 242 and 162
 20. Example 1, one raster a wavelength in one batched solve: order (4, 4)
     at 31 wavelengths (B = 31, n = 162) and order (15, 15) at 400, 550
     and 700 nm (n = 1922, the large route), |t_xx|^2 against the
     complex128 oracle, s/solve through the kernels and through
     torch.linalg.eig; parallel.shard_sweep and sweep_and_grad at order 4
     on a mesh of the card and of the card twice (5 points: the padding
     path) against the direct batched call; the large route's kernels
     against their plain versions at n = 1922 (as phase 18)
 21. Example 1-1 (three patterned layers) at orders 0, 3, 6, 9, 12 (n = 2
     to 1250, both routes): TRR + TLR + TRL + TLL <= 1 + 1e-4, order 12
     against the complex128 oracle; Example 3 at order (20, 20) at two
     points of the 11 x 11 grid in one batch, its eig stages timed with
     utils.StageTimer, one point against the oracle; the small route's kernels against their plain
     versions at n = 2 and 98 (the large route's at n = 722 and 1250:
     qr_compare.py --stage gates)
 22. hessenberg_blocked at n = 882 and 1922 (Examples 5 and 1's large
     sizes): each panel's column loop in one hess_panel launch against the
     plain column loop on the same A (Q H Q^H = A and Q unitary, each
     beside the plain loop's), the stage's time both ways, hess_panel's
     own device time and launches, beside the stage's bound
The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Needs no JAX and no network.
"""

import contextlib
import json
import math
import os
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

# the order-20 solve: one wavelength, one matrix
ORDER_L = (20, 20)
LAM_L = np.array([500.])

REPLACES = {
    'hessenberg': 'torcwa_tpu/ops/eig_qr_pallas.py:889',
    'schur_qr': 'torcwa_tpu/ops/eig_qr_pallas.py:351',
    'tri_vectors': 'torcwa_tpu/ops/eig_qr_pallas.py:768',
    'schur_ms': 'torcwa_tpu/ops/eig_qr_hbm.py:266',
    'tri_vectors_blocked': 'torcwa_tpu/ops/vec_blocked.py:34',
    'schur_qr_v2': 'torcwa_tpu/ops/eig_qr_pallas.py:82',
    'schur_qr_ms': 'torcwa_tpu/ops/eig_qr_pallas_ms.py:226',
    'schur_qr_baed': 'torcwa_tpu/ops/attic/eig_qr_pallas_baed.py:203',
    'schur_qr_packed': 'torcwa_tpu/ops/attic/eig_qr_pallas_packed.py:54',
}
SOURCES = {k: f'torcwa_tpu_torch/csrc/{k}.cu' for k in REPLACES}
# the v2 QR is the second entry point of the single-shift kernel's source
SOURCES['schur_qr_v2'] = SOURCES['schur_qr']
# sizes of the large-route kernel checks on random matrices
N_MID, N_BIG, N_SLAB = 300, 640, 3362
# schur_ms(aed=False) against its plain version (every sweep a Python
# chase): two overlapping chase windows of 128 rows at this size
N_NOAED = 160
SMALL = ('hessenberg', 'schur_qr', 'tri_vectors')
# the names of each small-route stage's kernels in a profile: the
# Hessenberg reduction's one-block or cluster kernel; the vectors' one-block
# kernel, or the packing pre-pass and the warp-per-column kernel
STAGE_KERNELS = {
    'hessenberg': ('hessenberg_kernel', 'hessenberg_cluster_kernel'),
    'schur_qr': ('schur_qr_kernel',),
    'tri_vectors': ('tri_vectors_kernel', 'tri_pack_kernel',
                    'tri_vectors_warp_kernel')}
LARGE = ('schur_ms', 'tri_vectors_blocked')
# every kernel of the large route: hessenberg_blocked's panel kernel too
# (it replaces no TPU kernel: no REPLACES entry)
LARGE_ROUTE = ('hess_panel',) + LARGE
ALT = ('schur_qr_v2', 'schur_qr_ms')
BATCHED_ALT = ('schur_qr_baed', 'schur_qr_packed')
# the stand-alone stages: shifts per sweep of schur_qr_ms on the wave
# matrices, and the sweeps of schur_qr_v2 that its plain version is timed on
# at B = 8, n = 338 (in full it would take minutes)
MS_M = 16
V2_BUDGET = 20
# the sweeps the plain versions of the two batched stages are timed on at
# B = 8, n = 338 (a plain schur_qr_baed sweep is a Python AED pass and a
# Python chase per lane, ~1 s; the plain single-shift QR takes minutes in full)
BAED_BUDGET = 2
PACKED_BUDGET = 10
# lanes of a batch the plain schur_qr_baed is run on in phase 12
PLAIN_LANES = 2
# rows by which kernel and plain may differ per lane after those sweeps
# (round-off decides which subdiagonal entry of a wave matrix deflates first)
BOTTOM_BAND = 8

# schur_ms's stats, (hi, sweeps, AED-deflated, skipped chases, flops done,
# flops needed), on the inputs of phases 4, 6 and 9 with PR 5's kernels
# (chip_smoke.py of commit bb0fee6 on an NVIDIA H100 80GB HBM3, 700 W).
# The two flop counts sum the sweeps' chase rotations and applied AED
# transforms, so an equal tuple is the same schedule of rotations
MS_STATS_PR5 = {
    'n=300': (0, 87, 294, 44, 6407764592, 817328544),
    'n=640': (0, 64, 637, 38, 23312448612, 6766040232),
    'order 20': (0, 281, 3325, 148, 3245527841700, 787502694904),
}
# PR 5's schur_ms at order 20 (PERF.md, final run of PR 5): the first two
# sweeps and the whole Schur form, ms; printed beside this run's times
MS_MS_PR5 = (60.1, 2540.5)
# the chase kernel against the plain float32 chase (chase_sweep_check): at
# most this many times the plain float32 chase's own distance from the
# float64 one on the same stretch, and never held tighter than the floor
# (of max|H|; for U absolute)
CHASE_ROOM = 8
CHASE_FLOOR = 1e-5

# the per-rotation single-shift QR kernel that the windowed chase replaced
# (commit dc04392, the parent of the redesign), on an NVIDIA H100 80GB HBM3
# at 700 W: per-lane (hi, sweeps, rotations) on phase 3's order-6 wave
# matrices, read through its C entry point by qr_compare.py.  Both kernels
# apply the same rotations in the same order; the sweeps part where nvcc
# fuses other products into FMAs (built with -fmad=false the two agree bit
# for bit: PERF.md)
QR_STATS_PER_ROTATION = {
    'order-6 wave matrices': [[0, 456, 81592], [0, 413, 79382],
                              [0, 443, 80332], [0, 430, 78394],
                              [0, 430, 80431], [0, 419, 78495],
                              [0, 426, 77716], [0, 422, 78131]],
}
# its times, ms, B = 8 (PERF.md: the final run of commit be561f7, whose
# kernel dc04392 kept): the whole Schur form of the order-6 batch at 0
# degrees (schur_qr, schur_qr_v2), and of the 10-degree batches at n = 338,
# 450, 578 (phase 14)
QR_MS_PER_ROTATION = {'schur_qr': 164.11, 'schur_qr_v2': 178.80,
             338: 178.3, 450: 353.7, 578: 751.1}
# sweeps of the budgeted element-wise check of schur_qr against the plain
# model of its windowed schedule (random batch, B x n), and its lanes
QR_MODEL_BUDGET = 2
QR_MODEL_LANES = 4

# the class API's stack (phase 15): a 300 nm a-Si:H rectangle on the
# substrate (the vendored table at 532 nm), a 200 nm SU-8 spacer
# (homogeneous), a 150 nm SiN circle, air above; 10 degrees
CLASS_ORDER = (6, 6)
CLASS_LAM = 532.
SU8_EPS = 1.6 ** 2
CLASS_ORDERS = [[0, 0], [1, 0], [0, 1], [-1, 0], [1, 1], [2, 0]]
# one layer through the class and the functional path on the large route
CLASS_ORDER_L = (10, 10)
# Examples 5 and 6 at their published configurations (phases 16-18):
# ADAM steps through maximize_adam, the first of which the s/iter median
# leaves out
EX_STEPS = 3
EX_NAMES = ('example5_shape_optimization', 'example6_topology_optimization')
# the azimuth of each example's 10-degree gradient check: Example 6 reads
# the (1, 0) order, which turns evanescent in air tilted toward +x
EX_AZI_DEG = {'example5': 0., 'example6': 180.}
# the ops whose float32 setting the pin check records: the products,
# solves and inverses of the forward and of torch's backward formulas
PINNED_OPS = {'mm', 'bmm', 'addmm', 'baddbmm', 'mv', 'addmv', 'dot',
              'linalg_solve', 'linalg_solve_ex', 'linalg_inv',
              'linalg_inv_ex', 'linalg_lu_solve', 'linalg_lu_factor_ex'}

# NVIDIA H100 SXM data sheet: device memory rate and the IEEE float32 rate
# outside the tensor cores (no TF32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
C64 = 8                                  # bytes of a complex64


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move `nbytes` (inputs read once, outputs written once) and
    do `flops` float32 operations."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


FAILURES = []


def vs_pr5(key, st):
    """schur_ms's stats beside PR 5's on the same input."""
    st = tuple(int(x) for x in st)
    ref = MS_STATS_PR5.get(key)
    same = 'the same' if st == ref else f'PR 5: {ref}'
    return f'stats {st} ({same})'


def check(cond, msg):
    """Record a check; the run goes on so that one call shows every
    failure, and exits non-zero at the end if any check failed."""
    if not cond:
        FAILURES.append(msg)
    print(f'  {"ok" if cond else "FAILED"}  {msg}', flush=True)


T_START = time.perf_counter()


def phase(name):
    print(f'\n== {name}  [{time.perf_counter() - T_START:.0f} s]', flush=True)


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


def once_ms(torch, fn):
    """Milliseconds of one run of fn() between CUDA events (no warm-up:
    for work whose kernels already ran)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def nearest_err(w, w_ref):
    """Largest distance from an eigenvalue of w to its nearest in w_ref."""
    return float((w[..., :, None] - w_ref[..., None, :]).abs()
                 .amin(-1).amax())


def set_dist(w, w_ref):
    """Largest distance between two eigenvalue sets, either way."""
    return max(nearest_err(w, w_ref), nearest_err(w_ref, w))


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


def hessenberg_path(ek, n):
    """Which kernel ek.hessenberg launches at n, with the cluster's shared
    memory and how many clusters the card runs at once."""
    info = ek.hessenberg_cluster_info(n)
    if info is None:
        return 'one block of 1024 threads per matrix'
    return (f'a cluster of {info["cluster"]} CTAs per matrix, '
            f'{info["smem_bytes"]} bytes of shared memory a CTA, '
            f'{info["active_clusters"]} clusters at once')


def tri_vectors_path(ek, n):
    """Which kernel ek.tri_vectors launches at n."""
    slots = ek.tri_vectors_slots(n)
    if not slots:
        return 'one block of 256 threads per matrix'
    return f'a warp per column, {slots} register slots of row sums a lane'


def schur_qr_ms_path(n, m):
    """Which kernel schur_qr_ms launches at (n, m), as its C entry point
    reports it."""
    from torcwa_tpu_torch.ops.schur_qr_ms import schur_qr_ms_cluster_info
    info = schur_qr_ms_cluster_info(n, m)
    if not info['cluster']:
        return 'one block of 1024 threads'
    return (f'a cluster of P = {info["cluster"]} CTAs, Z^T in '
            f'{"shared" if info["z_shared"] else "device"} memory, '
            f'{info["smem_bytes"]} bytes of shared memory a CTA')


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
    print(f'  hessenberg path: {hessenberg_path(ek, n)}')
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

    T, Z, (hi, sw, rot) = ek.schur_qr(H, Q, return_stats=True)
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
    st = [list(x) for x in zip(hi.tolist(), sw.tolist(), rot.tolist())]
    ref = QR_STATS_PER_ROTATION.get(label)
    print(f'  schur_qr per-lane (hi, sweeps, rotations) {st}'
          + ('' if ref is None else '; the same as the per-rotation kernel '
             'it replaced' if st == ref else
             f'; the per-rotation kernel it replaced: {ref}'))
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
    print(f'  tri_vectors path: {tri_vectors_path(ek, n)}')
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
                  ey=ey, r_k=r_k, r_p=r_p, qr_plain_ms=qr_plain_ms,
                  sweeps=sw.tolist())
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


def fwd_bwd_ms(torch, tp, eps, lams, order, inc, backend, reps=3):
    """Median milliseconds (forward, backward) of `reps` fwd+grad runs,
    each split by a CUDA event between the loss and its backward."""
    fw, bw = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        er = eps.detach().clone().requires_grad_(True)
        ev[0].record()
        T = slice_loss(torch, tp, er, lams, order, inc, backend)
        ev[1].record()
        T.mean().backward()
        ev[2].record()
        ev[2].synchronize()
        fw.append(ev[0].elapsed_time(ev[1]))
        bw.append(ev[1].elapsed_time(ev[2]))
    return statistics.median(fw), statistics.median(bw)


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
    ours = [e for e in kern if any(p in e.key for ps in STAGE_KERNELS.values()
                                   for p in ps)]
    shown = {k for k, ps in STAGE_KERNELS.items()
             if any(p in e.key for e in ours for p in ps)}
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
    check(shown == set(SMALL), 'the profile shows the three eig '
          'kernels')


def rand_c64(torch, n, seed, dev, scale=0.3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return torch.as_tensor((scale * a).astype(np.complex64), device=dev)


def schur_quality(torch, A, T, Z):
    """(||Z T Z^H - A||_F / ||A||_F, max|Z^H Z - I|, strictly lower part
    of T all zero)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    res = float(torch.linalg.matrix_norm(Z @ T @ Z.mH - A)
                / torch.linalg.matrix_norm(A))
    return res, float((Z.mH @ Z - eye).abs().max()), \
        bool((torch.tril(T, -1) == 0).all())


def plain_blocked_vectors(torch, vb, T, block, by_columns=False):
    """tri_vectors_blocked with the plain in-block recurrence (with
    ``by_columns`` in the kernel's order)."""
    n = T.shape[-1]
    dmin = vb.pivot_floor(T)
    Y = torch.eye(n, dtype=T.dtype, device=T.device)
    for r1 in range(n, 0, -block):
        r0 = max(r1 - block, 0)
        vb.tri_vectors_block_plain(T, T[r0:r1, r1:] @ Y[r1:], dmin, Y, r0, r1,
                                   by_columns=by_columns)
    return Y


def separated(torch, w, rel=1e-3):
    """Columns whose eigenvalue is farther than rel x spectral radius from
    every other: there the back substitution is well conditioned."""
    gap = (w[:, None] - w[None, :]).abs()
    gap = gap + torch.eye(w.shape[-1], device=w.device) * 1e30
    return gap.amin(-1) > rel * w.abs().amax()


def chase_sweep_check(torch, sm, H, m, wb, steps=8):
    """One sweep of m bulges with AED's shifts on the complex64 Hessenberg
    matrix H, window by window as the route runs it (windows of wb rows,
    each window's U applied to the slabs beside it), three times from H:
    through ms_chase, which forms U after its step loop from the rotations
    it recorded, and through chase_plain in float32 and in float64, which
    carry U step by step.  Float32 round-off grows along a chase, so the
    kernel is held to the plain float32 chase within CHASE_ROOM times what
    round-off alone does there, the plain float32 chase's distance from the
    float64 one on the same stretch, or CHASE_FLOOR, whichever is larger:
      * from one state, over the first `steps` steps of every window and
        over the last `steps` steps of the sweep, where the last bulges
        leave the active block at hi: H, U and the carries;
      * over the sweep, after each window: H;
    and to U W U^H = W' and U's unitarity within CHASE_FLOOR in every
    window, and to an H that is Hessenberg again after the last window.
    Returns (rows, ok): rows of (what, error, round-off, limit), H and the
    carries relative to max|H|."""
    n, c128 = H.shape[-1], torch.complex128
    lo, hi = sm.band_scan_plain(H, n - 1, 4.0)
    shifts = sm.aed_plain(H.clone(), lo, hi, m, sm.AED_KW, 4.0, False)[3]
    scale = float(H.abs().max())
    runs = {'k': H.clone(), 32: H.clone(), 64: H.to(c128)}
    carries = {k: torch.zeros(2 * m, dtype=X.dtype, device=H.device)
               for k, X in runs.items()}
    rows = []

    def chase(key, X, xy, a, wbe, t0, t1):
        if key == 'k':
            U = torch.empty(wbe, wbe, dtype=X.dtype, device=X.device)
            sm.ms_chase(X, shifts, xy, a, wbe, t0, t1, lo, hi, U)
            return U
        U = torch.eye(wbe, dtype=X.dtype, device=X.device)
        xs, ys = sm.chase_plain(X, shifts.to(X.dtype), xy[:m].clone(),
                                xy[m:].clone(), a, wbe, t0, t1, lo, hi, U=U)
        xy.copy_(torch.cat([xs, ys]))
        return U

    def apart(x, y):
        return float((x.to(c128) - y.to(c128)).abs().max())

    def row(what, got, p32, p64, rel):
        err, gap = apart(got, p32) / rel, apart(p32, p64) / rel
        rows.append((what, err, gap, max(CHASE_ROOM * gap, CHASE_FLOOR)))

    def from_state(what, X, xy, a, wbe, t0, t1):
        out = {}
        for key in runs:
            dt = c128 if key == 64 else X.dtype
            Xc, xyc = X.to(dt, copy=True), xy.to(dt, copy=True)
            out[key] = (Xc, chase(key, Xc, xyc, a, wbe, t0, t1), xyc)
        for i, part, rel in ((0, 'H', scale), (1, 'U', 1.), (2, 'xy', scale)):
            row(f'{what} {part}', *(out[k][i] for k in (('k', 32, 64))), rel)

    windows = list(sm.chase_windows(n, lo, hi, m, wb))
    for j, (a, wbe, tcur, t_end) in enumerate(windows):
        e = a + wbe
        from_state(f'window {j} steps {tcur}-{tcur + steps - 1}',
                   runs['k'], carries['k'], a, wbe, tcur, tcur + steps - 1)
        if j == len(windows) - 1:
            X, xy = runs['k'].clone(), carries['k'].clone()
            chase('k', X, xy, a, wbe, tcur, t_end - steps)
            from_state(f'sweep steps {t_end - steps + 1}-{t_end}', X, xy, a,
                       wbe, t_end - steps + 1, t_end)
        W0 = runs['k'][a:e, a:e].clone()
        for key, X in runs.items():
            U = chase(key, X, carries[key], a, wbe, tcur, t_end)
            if key == 'k':
                eye = torch.eye(wbe, dtype=X.dtype, device=X.device)
                rows.append((f'window {j} U W U^H - W\'',
                             apart(U @ W0 @ U.mH, X[a:e, a:e]) / scale, 0.,
                             CHASE_FLOOR))
                rows.append((f'window {j} U^H U - I', apart(U.mH @ U, eye),
                             0., CHASE_FLOOR))
            X[a:e, e:] = U @ X[a:e, e:]
            X[:a, a:e] = X[:a, a:e] @ U.mH
        row(f'sweep to window {j} H', runs['k'], runs[32], runs[64], scale)
    rows.append(('below the subdiagonal after the sweep',
                 float(torch.tril(runs['k'], -2).abs().max()) / scale, 0., 0.))
    return rows, all(err <= lim for _, err, _, lim in rows)


def large_kernel_checks(torch, ek, dev):
    """Phase 4: the kernels of the large-n route against their plain
    versions on random complex64 matrices."""
    from torcwa_tpu_torch.ops import (eig_qr as eq, schur_ms as sm,
                                      vec_blocked as vb)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked

    # n = 300: wb = 128 advancing by 64, so that several chase windows
    # overlap; kernels and plain version run the same sweep logic
    A = rand_c64(torch, N_MID, 300, dev)
    H, Q = hessenberg_blocked(A, panel=32)
    cfg = dict(m=8, kw=24, wb=128)
    T, Z, st = sm.schur_ms(H, Q, return_stats=True, **cfg)
    t0 = time.perf_counter()
    Tp, Zp, stp = sm.schur_ms_plain(H, Q, return_stats=True, **cfg)
    torch.cuda.synchronize()
    print(f'-- schur_ms n={N_MID} {cfg}: kernels (hi, sweeps, aed, skipped) '
          f'{st[:4]}, plain {stp[:4]} in {time.perf_counter() - t0:.1f} s; '
          f'kernels\' {vs_pr5("n=300", st)}')
    w, wp = torch.diagonal(T), torch.diagonal(Tp)
    rho = float(wp.abs().max())
    d = max(nearest_err(w, wp), nearest_err(wp, w)) / rho
    res, orth, tri = schur_quality(torch, A, T, Z)
    resp, orthp, _ = schur_quality(torch, A, Tp, Zp)
    print(f'  eigenvalue sets differ by {d:.2e} of the spectral radius; '
          f'residual kernels {res:.2e} plain {resp:.2e}; unitarity '
          f'{orth:.2e} / {orthp:.2e}')
    check(st[0] == 0 and stp[0] == 0, f'schur_ms n={N_MID}: both converged')
    check(d <= 1e-4, f'schur_ms n={N_MID}: kernels == plain eigenvalues <= 1e-4')
    check(res <= 1e-5 and orth <= 1e-5 and tri,
          f'schur_ms n={N_MID}: Schur residual and unitarity <= 1e-5, T '
          'triangular')
    check(0.5 * stp[1] <= st[1] <= 2 * stp[1] and st[2] > N_MID // 2,
          f'schur_ms n={N_MID}: sweeps within 2x of plain, AED deflates most')

    # n = 640 at the main path's settings.  The plain version is not run
    # here: its ~1e5 small launches take minutes at this size (it is held
    # against the kernels at n = 300 above and for two sweeps at n = 3362
    # in phase 6); the kernels are held against complex128 LAPACK instead
    A = rand_c64(torch, N_BIG, 640, dev)
    print(f'-- hessenberg n={N_BIG}, one matrix: {hessenberg_path(ek, N_BIG)}')
    H1, Q1 = ek.hessenberg(A[None].contiguous())
    H, Q = hessenberg_blocked(A)
    rec = float((Q @ H @ Q.mH - Q1[0] @ H1[0] @ Q1[0].mH).abs().max())
    hres = float(torch.linalg.matrix_norm(Q @ H @ Q.mH - A)
                 / torch.linalg.matrix_norm(A))
    eye = torch.eye(N_BIG, dtype=A.dtype, device=dev)
    horth = float((Q.mH @ Q - eye).abs().max())
    print(f'-- hessenberg_blocked n={N_BIG}: residual {hres:.2e}, unitarity '
          f'{horth:.2e}, max|QHQ^H - (QHQ^H)_kernel| = {rec:.2e}')
    check(hres <= 1e-5 and horth <= 1e-5 and
          rec <= 1e-5 * float(torch.linalg.matrix_norm(A)) and
          bool((torch.tril(H, -2) == 0).all()),
          f'hessenberg_blocked n={N_BIG} agrees with the batched kernel '
          '(gauge-free) within 1e-5')
    m = eq.large_shifts(N_BIG)
    T, Z, st = sm.schur_ms(H, Q, m=m, defl_mult=eq.LARGE_DEFL_MULT,
                           return_stats=True)
    w = torch.diagonal(T).to(torch.complex128)
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    d = max(nearest_err(w, w_ref), nearest_err(w_ref, w)) \
        / float(w_ref.abs().max())
    res, orth, tri = schur_quality(torch, A, T, Z)
    print(f'-- schur_ms n={N_BIG} as the route calls it (m={m}, kw={sm.AED_KW}, '
          f'wb={sm.window(m)}; plain version skipped: minutes at this size): '
          f'(hi, sweeps, aed, skipped) {st[:4]}, {vs_pr5("n=640", st)}; '
          f'eigenvalues vs complex128 {d:.2e}; residual {res:.2e}; '
          f'unitarity {orth:.3e} against its gate 1e-5 (9.894e-6 before '
          f'the warp-chain AED)')
    # the gate at float32's noise floor: on this input (seed 640) the
    # kernel read unitarity 9.894e-6 and residual 5.58e-6, its plain
    # float32 version 5.126e-6 and 5.79e-6 on the same H (qr_compare.py
    # --stage gates, NVIDIA H100 80GB HBM3 at 700 W): within 2x, no fault
    check(st[0] == 0 and d <= 1e-4 and res <= 1e-5 and orth <= 1e-5 and tri,
          f'schur_ms n={N_BIG}: converged, eigenvalues <= 1e-4, residual and '
          'unitarity <= 1e-5')
    # a whole sweep of chase windows as the route calls them at this size
    # (staged in shared memory), and with the m = 32 windows of order 25
    # (192 rows, worked in device memory): kernel against the plain float32
    # and float64 chases, window by window and over the sweep's last steps
    for mc, wbc in ((m, sm.window(m)), (32, sm.window(32))):
        rows, ok = chase_sweep_check(torch, sm, H, mc, wbc)
        print(f'-- ms_chase n={N_BIG} m={mc} wb={wbc} (U formed after the '
              'chase), one sweep: kernel against plain float32, plain '
              'float32 against float64, limit')
        for what, err, gap, lim in rows:
            print(f'     {what}: {err:.2e}, {gap:.2e}, {lim:.2e}')
        check(ok, f'ms_chase m={mc} wb={wbc}: H, U, carries == plain float32 '
              f'chase within max({CHASE_ROOM}x its float64 distance, '
              f'{CHASE_FLOOR}); U W U^H == W\', U unitary; H Hessenberg after '
              'the sweep')
    Y = vb.tri_vectors_blocked(T)
    Yp = plain_blocked_vectors(torch, vb, T, vb.MAX_BLOCK)
    Yc = plain_blocked_vectors(torch, vb, T, vb.MAX_BLOCK, by_columns=True)
    Y1 = ek.tri_vectors(T[None].contiguous())[0]
    sep = separated(torch, torch.diagonal(T))
    scale = float(Yp.abs().max())
    e_p = float(((Y - Yp).abs().amax(0) * sep).max()) / scale
    e_c = float(((Y - Yc).abs().amax(0) * sep).max()) / scale
    e_1 = float(((Y - Y1).abs().amax(0) * sep).max()) / scale
    print(f'-- tri_vectors_blocked n={N_BIG}: vs plain {e_p:.2e}, vs the '
          f'plain model of its order (by columns) {e_c:.2e}, vs the batched '
          f'kernel {e_1:.2e} (relative, {int(sep.sum())} separated columns '
          f'of {N_BIG})')
    check(e_p <= 1e-4 and e_c <= 1e-4 and e_1 <= 1e-4,
          f'tri_vectors_blocked n={N_BIG} == plain (both orders) == batched '
          'kernel <= 1e-4')

    # the slab products at the main path's shapes, the three products of
    # an applied transform in one launch as the route calls them: n = 3362,
    # the chase window's unitary and an AED transform of a window cut to
    # the active block (at most kw = 64)
    X = rand_c64(torch, N_SLAB, 7, dev)
    Z = rand_c64(torch, N_SLAB, 8, dev)
    worst = 0.
    for wdt, a in ((sm.window(eq.large_shifts(N_SLAB)), N_SLAB // 3),
                   (sm.AED_KW, N_SLAB - 361), (61, N_SLAB - 200)):
        P, e = rand_c64(torch, wdt, wdt, dev), a + wdt
        ref_X, ref_Z = X.clone(), Z.clone()
        ref_X[a:e, e:] = P @ X[a:e, e:]
        ref_X[:a, a:e] = X[:a, a:e] @ P.mH
        ref_Z[:, a:e] = Z[:, a:e] @ P.mH
        got = sm.ms_apply_window(X.clone(), Z.clone(), a, wdt, P)
        for g, r in zip(got, (ref_X, ref_Z)):
            worst = max(worst, float((g - r).abs().max() / r.abs().max()))
    print(f'-- ms_apply_window (one launch) vs torch.matmul: {worst:.2e} '
          'relative')
    check(worst <= 1e-5, 'ms_apply_window == torch.matmul within 1e-5')
    del X, Z

    A = rand_c64(torch, N_MID, 301, dev)
    H, Q = hessenberg_blocked(A)
    T1, _, st1 = sm.schur_ms(H, Q, budget=1, return_stats=True, **cfg)
    check(st1[0] > 0 and bool(torch.isnan(torch.diagonal(T1)).all()),
          'schur_ms with a budget of 1 sweep: NaN eigenvalues')


def two_sweeps_check(torch, sm, A, H, Q, cfg, rho, label):
    """Two sweeps in place, kernels against the plain version, from the
    same H, Q (A's Hessenberg form, rho its spectral radius).  Round-off
    may flip a deflation decision, so the two are compared gauge-free: each
    result is a unitary similarity of A in Hessenberg form, and the
    eigenvalues both have deflated agree.  Returns ((kernel ms, plain ms),
    the kernels' flops needed, the deflated eigenvalues' difference)."""
    n = A.shape[-1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    Hk, Zk, Hp, Zp = H.clone(), Q.clone(), H.clone(), Q.clone()
    ev[0].record()
    sk = sm.run_sweeps(Hk, Zk, 2, **cfg)
    ev[1].record()
    ev[2].record()
    sp = sm.run_sweeps(Hp, Zp, 2, plain=True, **cfg)
    ev[3].record()
    ev[3].synchronize()
    ms2 = (ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3]))
    rk, ok_, _ = schur_quality(torch, A, Hk, Zk)
    rp, op_, _ = schur_quality(torch, A, Hp, Zp)
    nd = n - 1 - max(sk[0], sp[0])
    dw = nearest_err(torch.diagonal(Hk)[n - nd:],
                     torch.diagonal(Hp)[n - nd:]) if nd else 0.
    print(f'  two sweeps at n = {n}: kernels {ms2[0]:.1f} ms, plain '
          f'{ms2[1]:.1f} ms; (hi, sweeps, aed, skipped) kernels '
          f'{sk[:4]} plain {sp[:4]}; residual {rk:.2e} / {rp:.2e}, '
          f'unitarity {ok_:.2e} / {op_:.2e}; the {nd} eigenvalues both '
          f'deflated differ by {dw:.2e}')
    check(abs(sk[0] - sp[0]) <= 8 and sk[1] == sp[1] == 2,
          f'{label}, two sweeps: kernels and plain deflate the same count '
          '(within 8)')
    # Q of the blocked reduction is unitary to ~1.5e-5 at n = 3362, so
    # the kernels are held to the plain version's own figures
    check(rk <= 2 * rp + 1e-6 and ok_ <= 2 * op_ + 1e-6 and rk <= 1e-5 and
          bool((torch.tril(Hk, -2) == 0).all()) and dw <= 1e-4 * rho,
          f'{label}, two sweeps: the kernels keep a unitary similarity in '
          'Hessenberg form (residual 1e-5, unitarity on par with the plain '
          'version) and deflate the plain version\'s eigenvalues (1e-4)')
    return ms2, sk[5], dw


def blocked_vectors_check(torch, vb, T, Y, label):
    """tri_vectors_blocked's Y of T against its plain version: relative on
    the separated columns (1e-4), and, on every column (a spectrum of
    mirror-symmetric modes may have no separated column), the eigen-residual
    max|T y - w y| / (max|T| max|y|) of each on par with the plain
    version's.  Returns (the error, the plain version's ms, one run, the
    kernel's and the plain version's eigen-residuals)."""
    n = T.shape[-1]
    got = []
    plain_ms = once_ms(torch, lambda: got.append(
        plain_blocked_vectors(torch, vb, T, vb.MAX_BLOCK)))
    Yp = got[0]
    w = torch.diagonal(T)
    sep = separated(torch, w)
    ey = float(((Y - Yp).abs().amax(0) * sep).max()) / float(Yp.abs().max())
    tmax = float(T.abs().max())
    rk, rp = (float(((T @ X - X * w).abs().amax(0)
                     / X.abs().amax(0)).max()) / tmax for X in (Y, Yp))
    print(f'  tri_vectors_blocked vs plain at n = {n}: {ey:.2e} relative on '
          f'{int(sep.sum())} separated columns; eigen-residual on all '
          f'{n} columns kernel {rk:.2e}, plain {rp:.2e}; plain '
          f'{plain_ms:.1f} ms')
    check(ey <= 1e-4, f'{label}: tri_vectors_blocked == plain <= 1e-4')
    check(rk <= 2 * rp + 1e-6, f'{label}: tri_vectors_blocked eigen-residual '
          'on par with the plain version\'s')
    return ey, plain_ms, rk, rp


def exact_eig_loss(torch, tp, eps, lams, order, inc):
    """fwd+grad of the float32 pipeline with its eig taken in complex128
    (an exact eig of the float32 A): the floor of any float32
    eigensolver."""
    from torcwa_tpu_torch.ops import eig as eig_mod

    def exact(A, backend):
        w, V = torch.linalg.eig(A.to(torch.complex128))
        return w.to(A.dtype), V.to(A.dtype)

    keep = eig_mod._forward
    eig_mod._forward = exact
    try:
        return fwd_grad(torch, tp, eps, lams, order, inc, 'torch')
    finally:
        eig_mod._forward = keep


@contextlib.contextmanager
def timed_eig_stages(torch, stages, whole):
    """Inside the scope each stage of the two eig routes runs through
    ``stages.wrap`` under its name ('hess': hessenberg and
    hessenberg_blocked, 'qr': SMALL_SCHUR and schur_ms, 'vec': tri_vectors
    and tri_vectors_blocked, 'refine': one _refine step), and the whole
    eig forward (either backend) through ``whole.wrap`` as 'eig'; each
    wrap waits for the card before it stops its clock."""
    from torcwa_tpu_torch.ops import eig as eig_mod, eig_qr as eq
    names = {'hessenberg': 'hess', 'hessenberg_blocked': 'hess',
             'SMALL_SCHUR': 'qr', 'schur_ms': 'qr', 'tri_vectors': 'vec',
             'tri_vectors_blocked': 'vec', '_refine': 'refine'}
    keep = {k: getattr(eq, k) for k in names}
    keep_fwd = eig_mod._forward
    for k, v in names.items():
        setattr(eq, k, stages.wrap(v, keep[k]))
    eig_mod._forward = whole.wrap('eig', keep_fwd)
    try:
        yield
    finally:
        for k, v in keep.items():
            setattr(eq, k, v)
        eig_mod._forward = keep_fwd


def order20_slice(torch, tp, ek, dev, out):
    """Phase 6: the order-(20, 20) solve through the large-n route."""
    from torcwa_tpu_torch.ops import (eig_qr as eq, schur_ms as sm,
                                      vec_blocked as vb)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    inc = math.radians(WELL_POSED_DEG)
    eps, A = wave_matrices(torch, tp, ORDER_L, LAM_L, inc, torch.float32, dev)
    A = A[0].contiguous()
    n = A.shape[-1]
    m = eq.large_shifts(n)
    cfg = dict(m=m, defl_mult=eq.LARGE_DEFL_MULT)
    print(f'-- A = P Q at order {ORDER_L}, {LAM_L[0]} nm, {WELL_POSED_DEG} '
          f'deg: n = {n}, schur_ms with {cfg}, kw = {sm.AED_KW}, wb = '
          f'{sm.window(m)} advancing by {sm.ALIGN}')
    H, Q = hessenberg_blocked(A)
    hres = float(torch.linalg.matrix_norm(Q @ H @ Q.mH - A)
                 / torch.linalg.matrix_norm(A))
    T, Z, st = sm.schur_ms(H, Q, return_stats=True, **cfg)
    res, orth, tri = schur_quality(torch, A, T, Z)
    print(f'  hessenberg_blocked residual {hres:.2e}; schur_ms (hi, sweeps, '
          f'aed-deflated, skipped chases) {st[:4]}, {st[4]:.3e} flops done '
          f'for {st[5]:.3e} needed, {vs_pr5("order 20", st)}; '
          f'Schur residual {res:.2e}, unitarity {orth:.2e}')
    check(st[0] == 0 and tri, 'order 20: schur_ms converged, T triangular')
    # float32 round-off of ~2000 slab products through Z: 1e-4, not 1e-5
    check(hres <= 1e-5 and res <= 1e-4 and orth <= 1e-4,
          'order 20: Hessenberg residual <= 1e-5, Schur residual and '
          'unitarity <= 1e-4')
    Y = vb.tri_vectors_blocked(T)
    w = torch.diagonal(T)
    V = Z @ Y
    V = V / torch.linalg.vector_norm(V, dim=-2, keepdim=True)
    amax = float(A.abs().max())
    r0 = float((A @ V - V * w).abs().max()) / amax
    w2, V2 = w[None], V[None]
    steps, gap = eq.REFINE
    for _ in range(steps):
        w2, V2 = eq._refine(A[None], w2, V2, gap)
    r1 = float((A @ V2[0] - V2[0] * w2[0]).abs().max()) / amax
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    rho = float(w_ref.abs().max())
    ew = max(nearest_err(w2[0].to(torch.complex128), w_ref),
             nearest_err(w_ref, w2[0].to(torch.complex128))) / rho
    print(f'  eigen-residual max|A V - V w| / max|A|: {r0:.2e} before, '
          f'{r1:.2e} after {steps} refinement steps; '
          f'eigenvalues vs complex128 torch.linalg.eig {ew:.2e} of the '
          f'spectral radius')
    check(ew <= 1e-4, 'order 20: eigenvalues within 1e-4 of the spectral '
          'radius of the complex128 oracle')
    check(r1 <= 1e-4, 'order 20: eigen-residual after refinement <= 1e-4')

    out['ms2'], out['need2'], out['err_ms'] = two_sweeps_check(
        torch, sm, A, H, Q, cfg, rho, 'order 20')
    out['err_vec'] = blocked_vectors_check(torch, vb, T, Y, 'order 20')[0]
    out.update(A=A, H=H, Q=Q, T=T, Z=Z, need=st[5], eps=eps, n=n, cfg=cfg)

    # the slice itself
    ek.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    T_k, g_k = fwd_grad(torch, tp, eps, LAM_L, ORDER_L, inc, 'kernels')
    torch.cuda.synchronize()
    out['launches'] = dict(ek.LAUNCHES)
    out['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
    print(f'  launches on the order-20 path: {out["launches"]}; peak memory '
          f'{out["peak_gb"]:.3f} GB')
    for k in LARGE_ROUTE:
        check(out['launches'][k] > 0, f'{k} launched on the order-20 path')
    for k in SMALL:
        check(out['launches'][k] == 0, f'{k} not launched at order 20')
    T_o, g_o = fwd_grad(torch, tp, eps.double(), LAM_L, ORDER_L, inc, 'torch')
    T_l, g_l = fwd_grad(torch, tp, eps, LAM_L, ORDER_L, inc, 'torch')
    T_e, g_e = exact_eig_loss(torch, tp, eps, LAM_L, ORDER_L, inc)
    dT = float((T_k.double() - T_o).abs().max())
    cos_k, cos_l, cos_e = (cosine(g, g_o) for g in (g_k, g_l, g_e))
    print(f'  |t_xx|^2: kernels {T_k.tolist()} oracle {T_o.tolist()} '
          f'torch.linalg.eig complex64 {T_l.tolist()} exact eig of the '
          f'float32 A {T_e.tolist()}')
    print(f'  raster-gradient cosine vs the complex128 oracle: kernels '
          f'{cos_k:.6f}, torch.linalg.eig complex64 {cos_l:.6f}, exact eig '
          f'of the float32 A {cos_e:.6f}')
    check(dT <= 1e-4, f'order 20: |t_xx|^2 vs oracle {dT:.2e} <= 1e-4')
    check(bool(torch.isfinite(g_k).all()), 'order 20: gradient finite')
    check(cos_k >= 0.99, f'order 20: raster gradient cosine {cos_k:.6f} '
          f'>= 0.99')
    del T_o, g_o, T_l, g_l, T_e, g_e

    # normal incidence, the bench workload's own: the modes come in
    # degenerate pairs.  Forward only (the gradient there is ill posed in
    # any eigensolver)
    _, A0 = wave_matrices(torch, tp, ORDER_L, LAM_L, 0., torch.float32, dev)
    A0 = A0[0].contiguous()
    H0, Q0 = hessenberg_blocked(A0)
    T0, Z0, st0 = sm.schur_ms(H0, Q0, return_stats=True, **cfg)
    res0, orth0, tri0 = schur_quality(torch, A0, T0, Z0)
    print(f'  0 deg: max|Im A| / max|A| = '
          f'{float(A0.imag.abs().max() / A0.abs().max()):.1e}; schur_ms '
          f'(hi, sweeps, aed-deflated, skipped chases) {st0[:4]}; Schur '
          f'residual {res0:.2e}, unitarity {orth0:.2e}')
    check(st0[0] == 0 and tri0 and res0 <= 1e-4 and orth0 <= 1e-4,
          'order 20, 0 deg: schur_ms converged, Schur residual and '
          'unitarity <= 1e-4')
    del A0, H0, Q0, T0, Z0
    with torch.no_grad():
        T_k0 = slice_loss(torch, tp, eps, LAM_L, ORDER_L, 0., 'kernels')
        T_o0 = slice_loss(torch, tp, eps.double(), LAM_L, ORDER_L, 0.,
                          'torch')
        T_l0 = slice_loss(torch, tp, eps, LAM_L, ORDER_L, 0., 'torch')
    dT0 = float((T_k0.double() - T_o0).abs().max())
    print(f'  0 deg |t_xx|^2: kernels {T_k0.tolist()} oracle {T_o0.tolist()} '
          f'torch.linalg.eig complex64 {T_l0.tolist()}')
    check(bool(torch.isfinite(T_k0).all()) and dT0 <= 1e-4,
          f'order 20, 0 deg: |t_xx|^2 vs oracle {dT0:.2e} <= 1e-4')


def schur_ms_split(torch, sm, H, Q, cfg):
    """Device time of one schur_ms(H, Q) by part, from torch.profiler:
    {part: (ms, launches)} for the chase windows, the slab products, AED
    and the band scan."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sm.schur_ms(H, Q, **cfg)
        torch.cuda.synchronize()
    parts = {'ms_chase': 'chase', 'ms_apply': 'slab products',
             'ms_aed': 'AED', 'ms_band_scan': 'band scan'}
    split = {v: [0., 0] for v in parts.values()}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for key, part in parts.items():
            if '::' + key in e.key:
                split[part][0] += e.self_device_time_total / 1e3
                split[part][1] += e.count
    return split


def profile_order20(torch, tp, eps):
    """torch.profiler over one order-20 fwd+grad: device time by kernel and
    the idle share of the unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    inc = math.radians(WELL_POSED_DEG)

    def solve():
        fwd_grad(torch, tp, eps, LAM_L, ORDER_L, inc, 'kernels')
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    solve()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity only: recording the ~1e6 host-side operator events of
    # this solve as well takes four times as long and changes no device time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    ms_k = sum(e.self_device_time_total for e in kern
               if '::ms_' in e.key) / 1e3
    print(f'  order-20 solve: wall (no profiler) {wall_ms:.1f} ms; device '
          f'kernels {busy:.1f} ms (idle {1 - busy / wall_ms:.3f} of the '
          f'wall) in {sum(e.count for e in kern)} launches; the schur_ms '
          f'functions {ms_k:.1f} ms; sweeps of this solve (ms_aed launches) '
          f'{sum(e.count for e in kern if "ms_aed" in e.key)}')
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:14]:
        print(f'  {e.self_device_time_total / 1e3:10.3f} ms x{e.count:5d}  '
              f'{e.key[:100]}')
    check(any('ms_chase' in e.key for e in kern)
          and any('tri_vectors_block_kernel' in e.key for e in kern),
          'the order-20 profile shows the large-route kernels')


def alt_kernel_checks(torch, ek, dev, A_rand, out):
    """Phase 9: the stand-alone Schur stages and schur_ms(aed=False) against
    their plain versions on random complex64 matrices."""
    from torcwa_tpu_torch.ops import (eig_qr as eq, schur_ms as sm,
                                      schur_qr_ms as sq)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    c128 = torch.complex128

    H, Q = ek.hessenberg(A_rand)
    T, Z, (hi, sw, rot) = ek.schur_qr_v2(H, Q, return_stats=True)
    Tp, Zp, hip, swp, rotp = ek.schur_qr_v2_plain(H, Q)
    w, wp = (torch.diagonal(x, dim1=-2, dim2=-1) for x in (T, Tp))
    rho = float(wp.abs().max())
    d = max(set_dist(w[b], wp[b]) for b in range(len(w))) / rho
    q = [schur_quality(torch, A_rand[b], T[b], Z[b]) for b in range(len(w))]
    res, orth = max(x[0] for x in q), max(x[1] for x in q)
    print(f'-- schur_qr_v2 B={A_rand.shape[0]} n={A_rand.shape[-1]}: sweeps '
          f'kernel {sw.tolist()} plain {swp.tolist()}, rotations '
          f'{rot.tolist()} / {rotp.tolist()}; eigenvalue sets differ by '
          f'{d:.2e} of the spectral radius; residual {res:.2e}, unitarity '
          f'{orth:.2e}')
    check(bool((hi == 0).all()) and bool((hip == 0).all()),
          'schur_qr_v2: every lane converged, kernel and plain')
    check(d <= 1e-4, 'schur_qr_v2: kernel == plain eigenvalues <= 1e-4')
    check(res <= 1e-5 and orth <= 1e-5 and all(x[2] for x in q),
          'schur_qr_v2: Schur residual and unitarity <= 1e-5, T triangular')
    check(abs(int(sw.max()) - int(swp.max())) <= 0.3 * int(swp.max()),
          'schur_qr_v2: sweeps within 30% of plain')
    T1, _, (hi1, sw1, _) = ek.schur_qr_v2(H, Q, max_iter_factor=1,
                                          return_stats=True)
    check(bool((hi1 > 0).all())
          and bool(torch.isfinite(torch.view_as_real(T1)).all()),
          'schur_qr_v2 out of budget: handed back unpoisoned (no NaN)')

    for n, m in ((64, 8), (200, 16)):
        A = rand_c64(torch, n, n, dev)
        H1, Q1 = ek.hessenberg(A[None].contiguous())
        T, Z, st = sq.schur_qr_ms(H1[0], Q1[0], m=m, return_stats=True)
        t0 = time.perf_counter()
        Tp, Zp, stp = sq.schur_qr_ms_plain(H1[0], Q1[0], m=m,
                                           return_stats=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st, stp = [int(x) for x in st], [int(x) for x in stp]
        w, wp = torch.diagonal(T), torch.diagonal(Tp)
        w_ref = torch.linalg.eigvals(A.to(c128))
        rho = float(w_ref.abs().max())
        d = set_dist(w, wp) / rho
        do = set_dist(w.to(c128), w_ref) / rho
        res, orth, tri = schur_quality(torch, A, T, Z)
        print(f'-- schur_qr_ms n={n} m={m} ({schur_qr_ms_path(n, m)}): (hi, '
              f'sweeps, rotations) kernel '
              f'{st} plain {stp} in {secs:.1f} s; eigenvalue sets differ by '
              f'{d:.2e} of the spectral radius, from complex128 LAPACK by '
              f'{do:.2e}; residual {res:.2e}, unitarity {orth:.2e}')
        check(st[0] == 0 and stp[0] == 0,
              f'schur_qr_ms n={n}: kernel and plain converged')
        check(d <= 1e-4 and do <= 1e-4, f'schur_qr_ms n={n}: kernel == plain '
              '== complex128 eigenvalues <= 1e-4')
        check(res <= 1e-5 and orth <= 1e-5 and tri, f'schur_qr_ms n={n}: '
              'Schur residual and unitarity <= 1e-5, T triangular')
        check(0.5 * stp[1] <= st[1] <= 2 * stp[1]
              and abs(st[2] - stp[2]) <= 0.2 * stp[2],
              f'schur_qr_ms n={n}: sweeps within 2x and rotations within 20% '
              'of plain')
    T1, _, st1 = sq.schur_qr_ms(H1[0], Q1[0], m=16, max_iter_factor=-100,
                                return_stats=True)
    check(int(st1[0]) > 0 and bool(torch.isnan(torch.diagonal(T1)).all()),
          'schur_qr_ms with a negative budget: NaN eigenvalues')

    A = rand_c64(torch, N_NOAED, 300, dev)
    H, Q = hessenberg_blocked(A, panel=32)
    cfg = dict(m=8, kw=24, wb=128, aed=False)
    T, Z, st = sm.schur_ms(H, Q, return_stats=True, **cfg)
    t0 = time.perf_counter()
    Tp, Zp, stp = sm.schur_ms_plain(H, Q, return_stats=True, **cfg)
    torch.cuda.synchronize()
    print(f'-- schur_ms n={N_NOAED} {cfg}: kernels (hi, sweeps, aed, skipped) '
          f'{st[:4]}, plain {stp[:4]} in {time.perf_counter() - t0:.1f} s')
    w, wp = torch.diagonal(T), torch.diagonal(Tp)
    d = set_dist(w, wp) / float(wp.abs().max())
    res, orth, tri = schur_quality(torch, A, T, Z)
    print(f'  eigenvalue sets differ by {d:.2e} of the spectral radius; '
          f'residual {res:.2e}, unitarity {orth:.2e}')
    check(st[0] == 0 and stp[0] == 0 and st[2] == 0 and st[3] == 0,
          f'schur_ms(aed=False) n={N_NOAED}: both converged, nothing deflated '
          'by AED, no chase skipped')
    check(d <= 1e-4 and res <= 1e-5 and orth <= 1e-5 and tri,
          f'schur_ms(aed=False) n={N_NOAED}: kernels == plain eigenvalues <= '
          '1e-4, residual and unitarity <= 1e-5')
    check(0.5 * stp[1] <= st[1] <= 2 * stp[1],
          f'schur_ms(aed=False) n={N_NOAED}: sweeps within 2x of plain')

    A = rand_c64(torch, N_BIG, 640, dev)
    H, Q = hessenberg_blocked(A)
    m = eq.large_shifts(N_BIG)
    cfg = dict(m=m, defl_mult=eq.LARGE_DEFL_MULT)
    T, Z, st = sm.schur_ms(H, Q, aed=False, return_stats=True, **cfg)
    _, _, sta = sm.schur_ms(H, Q, return_stats=True, **cfg)
    w_ref = torch.linalg.eigvals(A.to(c128))
    d = set_dist(torch.diagonal(T).to(c128), w_ref) \
        / float(w_ref.abs().max())
    res, orth, tri = schur_quality(torch, A, T, Z)
    print(f'-- schur_ms(aed=False) n={N_BIG} m={m} wb={sm.window(m)} (plain '
          f'version skipped: minutes at this size): (hi, sweeps, aed, '
          f'skipped) {st[:4]}, with AED {sta[:4]}; eigenvalues vs complex128 '
          f'{d:.2e}; residual {res:.2e}; unitarity {orth:.2e}')
    # ~12x the sweeps of the AED run, every one a chase with its slab
    # products through Z: the float32 round-off in Z grows with them (1.1e-5
    # measured at 744 sweeps), so 2e-5 here where the AED run is held to 1e-5
    check(st[0] == 0 and d <= 1e-4 and res <= 2e-5 and orth <= 2e-5 and tri,
          f'schur_ms(aed=False) n={N_BIG}: converged, eigenvalues <= 1e-4, '
          'residual and unitarity <= 2e-5')
    check(sta[0] == 0 and 2 * sta[1] <= st[1],
          f'schur_ms n={N_BIG}: AED needs at least 2x fewer sweeps')
    out.update(H640=H, Q640=Q, cfg640=cfg, sweeps640=(st[1], sta[1]))


def eig_checks(torch, label, A, w, V):
    """Eigenvalues of a (B, n, n) batch against the complex128 oracle and
    the eigen-residual after the refinement, both relative."""
    c128 = torch.complex128
    ew = 0.
    for b in range(A.shape[0]):
        w_ref = torch.linalg.eigvals(A[b].to(c128))
        ew = max(ew, set_dist(w[b].to(c128), w_ref)
                 / float(w_ref.abs().max()))
    r = float(((A @ V - V * w[..., None, :]).abs().amax((-2, -1))
               / A.abs().amax((-2, -1))).max())
    print(f'  {label}: eigenvalues vs complex128 torch.linalg.eig '
          f'{ew:.2e} of the spectral radius; max|A V - V w| / max|A| = '
          f'{r:.2e} after the refinement')
    check(ew <= 1e-4, f'{label}: eigenvalues within 1e-4 of the '
          'spectral radius of the complex128 oracle')
    check(r <= 1e-4, f'{label}: eigen-residual after refinement <= 1e-4')


def partial_state(torch, A, w_ref, Tb, Zb, hib, poisoned=False):
    """What an unfinished Schur stage holds after a budget of sweeps on the
    (B, n, n) batch A with complex128 eigenvalues w_ref: (the part of
    Z^H A Z below its subdiagonal and its upper triangle against T, both
    over the least ||A||_F; the unitarity of Z; the deflated eigenvalues
    against w_ref over the spectral radius; the rows deflated, summed over
    the lanes).  A stage that has put NaN on the diagonal of an unfinished
    lane (`poisoned`) is held to its strict upper triangle, and its deflated
    eigenvalues are read from the diagonal of Z^H A Z."""
    c128 = torch.complex128
    B, n = A.shape[0], A.shape[-1]
    rho = float(w_ref.abs().max())
    afro = float(torch.linalg.matrix_norm(A).min())
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Hs = Zb.mH.to(c128) @ A.to(c128) @ Zb.to(c128)
    below = float(torch.linalg.matrix_norm(torch.tril(Hs, -2)).max())
    if poisoned:
        Tb = torch.where(eye.real > 0, torch.zeros_like(Tb), Tb)
    upper = float(torch.linalg.matrix_norm(
        torch.triu(Hs, 1 if poisoned else 0) - Tb).max())
    orth = float((Zb.mH @ Zb - eye).abs().max())
    dg = torch.diagonal(Hs if poisoned else Tb, dim1=-2, dim2=-1)
    dw = max(nearest_err(dg[b, int(hib[b]) + 1:].to(c128), w_ref[b])
             if int(hib[b]) < n - 1 else 0. for b in range(B))
    return below / afro, upper / afro, orth, dw / rho, \
        int((n - 1 - hib).sum())


def alt_path(torch, tp, ek, dev, A6, H6, Q6, eps32, out):
    """Phase 10: the composed eig through the stand-alone stages at full
    width, and one order-(7, 7) solve through schur_qr_ms."""
    from torcwa_tpu_torch.ops import eig_qr as eq, schur_qr_ms as sq
    c128 = torch.complex128
    inc = math.radians(WELL_POSED_DEG)

    # schur_qr_v2 on the order-6 batch
    B6, n6 = A6.shape[0], A6.shape[-1]
    label = f'hessenberg -> schur_qr_v2 -> tri_vectors, B={B6} n={n6}'
    ek.reset_launch_counts()
    w, V = eq.eig_small(A6, ek.schur_qr_v2)
    torch.cuda.synchronize()
    lv = dict(ek.LAUNCHES)
    print(f'-- {label}: launches {lv}')
    check(lv['schur_qr_v2'] == 1 and lv['hessenberg'] == 1
          and lv['tri_vectors'] == 1 and lv['schur_qr'] == 0,
          'the composed eig launched hessenberg, schur_qr_v2 and tri_vectors '
          'once each and schur_qr not at all')
    out['launches'] = {'schur_qr_v2': lv['schur_qr_v2']}
    T, Z, (hi, sw, rot) = ek.schur_qr_v2(H6, Q6, return_stats=True)
    print(f'  sweeps {sw.tolist()}, rotations {rot.tolist()}')
    check(bool((hi == 0).all()), 'schur_qr_v2: every order-6 lane converged')
    eig_checks(torch, 'schur_qr_v2, order 6', A6, w, V)
    out['v2_rot'] = int(rot.sum())
    # The plain version takes ~90 s for ONE of these lanes in full, so it
    # meets the kernel at this shape twice.  First element by element after
    # one sweep, on a random batch of the same shape: there a sweep is
    # forward-stable and both make the same decisions (window, shift) from
    # the same numbers.  On the wave matrices it is not: their Hessenberg
    # subdiagonal falls to ~1e-5 max|A| (phase 3), each rotation is formed
    # from such entries, and one sweep already differs at O(max|A|) between
    # two float32 orders of summation while both stay backward-stable
    Ar = torch.stack([rand_c64(torch, n6, 100 + b, dev) for b in range(B6)])
    Hr, Qr = ek.hessenberg(Ar)
    T1, Z1, _ = ek.schur_qr_v2(Hr, Qr, max_iters=1, return_stats=True)
    T1p, Z1p = ek.schur_qr_v2_plain(Hr, Qr, max_iters=1)[:2]
    a2 = float(torch.linalg.matrix_norm(Ar, ord=2).min())
    dT, dZ = float((T1 - T1p).abs().max()), float((Z1 - Z1p).abs().max())
    print(f'  one sweep on a random batch, B={B6} n={n6}: max|T - T_plain| = '
          f'{dT:.3e} ({dT / a2:.2e} ||A||_2), max|Z - Z_plain| = {dZ:.3e}')
    check(dT <= 1e-4 * a2 and dZ <= 1e-4,
          'schur_qr_v2, one sweep: kernel == plain element-wise, T within '
          '1e-4 ||A||_2, Z within 1e-4')
    out['err_v2'] = dT
    # Then on the wave matrices, on the same budget of sweeps.  Round-off soon
    # decides which subdiagonal deflates first, so the two take different
    # paths (one lane in full: 825 against 1228 sweeps, the same
    # eigenvalues) and are not compared with each other: each must hold a unitary Z whose
    # similarity Z^H A Z is upper Hessenberg with T as its upper triangle
    # (an unfinished T has lost its subdiagonal), and what it has deflated
    # must be eigenvalues of A
    w_ref = torch.linalg.eigvals(A6.to(c128))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    Tk, Zk, (hik, swk, rotk) = ek.schur_qr_v2(H6, Q6, max_iters=V2_BUDGET,
                                              return_stats=True)
    ev[1].record()
    ev[2].record()
    Tp, Zp, hip, swp, rotp = ek.schur_qr_v2_plain(H6, Q6,
                                                  max_iters=V2_BUDGET)
    ev[3].record()
    ev[3].synchronize()
    out['v2_budget_ms'] = (ev[0].elapsed_time(ev[1]),
                           ev[2].elapsed_time(ev[3]))
    out['v2_budget_rot'] = int(rotk.sum())
    pk = partial_state(torch, A6, w_ref, Tk, Zk, hik)
    pp = partial_state(torch, A6, w_ref, Tp, Zp, hip)
    print(f'  the first {V2_BUDGET} sweeps at B={B6} n={n6}: kernel '
          f'{out["v2_budget_ms"][0]:.1f} ms, plain '
          f'{out["v2_budget_ms"][1]:.1f} ms; rotations {int(rotk.sum())} / '
          f'{int(rotp.sum())}; (below the subdiagonal of Z^H A Z, its upper '
          f'triangle against T, unitarity of Z, deflated eigenvalues against '
          f'complex128, eigenvalues deflated) kernel '
          f'({pk[0]:.2e}, {pk[1]:.2e}, {pk[2]:.2e}, {pk[3]:.2e}, {pk[4]}) '
          f'plain ({pp[0]:.2e}, {pp[1]:.2e}, {pp[2]:.2e}, {pp[3]:.2e}, '
          f'{pp[4]})')
    check(bool((swk == V2_BUDGET).all()) and bool((swp == V2_BUDGET).all())
          and 0.5 * pp[4] <= pk[4] <= 2 * pp[4]
          and 0.5 * int(rotp.sum()) <= int(rotk.sum()) <= 2 * int(rotp.sum()),
          f'schur_qr_v2, {V2_BUDGET} sweeps: kernel and plain deflate and '
          'rotate within 2x of each other')
    check(max(pk[:3]) <= 1e-5 and pk[3] <= 1e-4 and max(pp[:3]) <= 1e-5
          and pp[3] <= 1e-4,
          f'schur_qr_v2, {V2_BUDGET} sweeps: kernel and plain each keep a '
          'unitary Hessenberg similarity with T its upper triangle (1e-5) '
          'and deflate eigenvalues of A (1e-4)')

    # schur_qr_ms on one wave matrix at orders 6, 7, 8
    stage = eq.lane_by_lane(sq.schur_qr_ms, m=MS_M)
    out['ms'] = {}
    for order in (6, 7, 8):
        _, Ao = wave_matrices(torch, tp, (order, order), LAM_L, inc,
                              torch.float32, dev)
        Ao = Ao.contiguous()
        n = Ao.shape[-1]
        print(f'-- hessenberg -> schur_qr_ms (m={MS_M}) -> tri_vectors, one '
              f'wave matrix, order {order}, n={n}, {LAM_L[0]} nm, '
              f'{WELL_POSED_DEG} deg')
        H, Q = ek.hessenberg(Ao)
        T, Z, st = sq.schur_qr_ms(H[0], Q[0], m=MS_M, return_stats=True)
        st = [int(x) for x in st]
        res, orth, tri = schur_quality(torch, Ao[0], T, Z)
        print(f'  schur_qr_ms path: {schur_qr_ms_path(n, MS_M)}; (hi, sweeps, '
              f'rotations) {st}; Schur residual {res:.2e}, unitarity '
              f'{orth:.2e}')
        check(st[0] == 0 and tri and res <= 1e-5 and orth <= 1e-5,
              f'schur_qr_ms n={n}: converged, Schur residual and unitarity '
              '<= 1e-5')
        w, V = eq.eig_small(Ao, stage)
        eig_checks(torch, f'schur_qr_ms, order {order}', Ao, w, V)
        out['ms'][n] = dict(A=Ao, H=H[0], Q=Q[0], st=st)
        if order == 6:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            Tp, Zp, stp = sq.schur_qr_ms_plain(H[0], Q[0], m=MS_M,
                                               return_stats=True)
            ev[1].record()
            ev[1].synchronize()
            out['ms_plain_ms'] = ev[0].elapsed_time(ev[1])
            stp = [int(x) for x in stp]
            dw = set_dist(torch.diagonal(T), torch.diagonal(Tp))
            rho = float(torch.diagonal(Tp).abs().max())
            resp, orthp, _ = schur_quality(torch, Ao[0], Tp, Zp)
            print(f'  plain version in full: {out["ms_plain_ms"] / 1e3:.1f} '
                  f's, (hi, sweeps, rotations) {stp}; eigenvalue sets differ '
                  f'by {dw / rho:.2e} of the spectral radius; residual '
                  f'{resp:.2e}, unitarity {orthp:.2e}')
            check(stp[0] == 0 and dw <= 1e-4 * rho
                  and 0.5 * stp[1] <= st[1] <= 2 * stp[1],
                  f'schur_qr_ms n={n}: kernel == plain eigenvalues <= 1e-4, '
                  'sweeps within 2x')
            out['err_ms'] = dw

    # one order-(7, 7) solve with the small route's Schur stage swapped
    order = (7, 7)
    keep = eq.SMALL_SCHUR
    eq.SMALL_SCHUR = stage
    try:
        ek.reset_launch_counts()
        T_k, g_k = fwd_grad(torch, tp, eps32, LAM_L, order, inc, 'kernels')
        torch.cuda.synchronize()
        lm = dict(ek.LAUNCHES)
    finally:
        eq.SMALL_SCHUR = keep
    print(f'-- order-7 solve (2N = 450) through schur_qr_ms: launches {lm}')
    check(lm['schur_qr_ms'] >= 1 and lm['schur_qr'] == 0
          and lm['schur_ms'] == 0,
          f'schur_qr_ms launched on the order-7 path ({lm["schur_qr_ms"]}), '
          'schur_qr and schur_ms not')
    out['launches']['schur_qr_ms'] = lm['schur_qr_ms']
    T_o, g_o = fwd_grad(torch, tp, eps32.double(), LAM_L, order, inc,
                        'torch')
    dT = float((T_k.double() - T_o).abs().max())
    cos_k = cosine(g_k, g_o)
    print(f'  |t_xx|^2 through schur_qr_ms {T_k.tolist()} oracle '
          f'{T_o.tolist()}; raster-gradient cosine {cos_k:.6f}')
    check(dT <= 1e-4, f'order 7 through schur_qr_ms: |t_xx|^2 vs oracle '
          f'{dT:.2e} <= 1e-4')
    check(bool(torch.isfinite(g_k).all()) and cos_k >= 0.99,
          f'order 7 through schur_qr_ms: raster gradient finite, cosine '
          f'{cos_k:.6f} >= 0.99')


def qr_window_check(torch, ek, dev, n=338, lanes=QR_MODEL_LANES):
    """schur_qr after QR_MODEL_BUDGET sweeps on a random (lanes, n) batch
    (n = 338, phase 3's, is no multiple of the chase window's step, 30)
    against the plain model of its windowed schedule
    (``eig_kernels._single_shift_sweeps(..., window=WINDOW)``) on the same
    H, Q.  Each must hold a unitary Hessenberg similarity with T
    (partial_state; the kernel's unfinished lanes have a NaN diagonal by
    contract); element by element T's strict upper part within 1e-4
    ||A||_2 and Z within 1e-4 (float32, the Givens rotations formed under
    other contractions, as phase 14 holds the batched stages after one
    sweep); the stats equal (nothing deflates in two sweeps of a random
    matrix).  Returns max|T - T_model| / ||A||_2."""
    B, w = lanes, ek.WINDOW
    A = torch.stack([rand_c64(torch, n, 200 + b, dev) for b in range(B)])
    H, Q = ek.hessenberg(A)
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    a2 = float(torch.linalg.matrix_norm(A, ord=2).min())
    T, Z, st = ek.schur_qr(H, Q, max_iters=QR_MODEL_BUDGET, return_stats=True)
    t0 = time.perf_counter()
    Tp, Zp, *stp = ek._single_shift_sweeps(H, Q, QR_MODEL_BUDGET,
                                           **ek.ACC_RULES, window=w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pk = partial_state(torch, A, w_ref, T, Z, st[0], poisoned=True)
    pp = partial_state(torch, A, w_ref, Tp, Zp, stp[0])
    dT = float((torch.triu(T, 1) - torch.triu(Tp, 1)).abs().max())
    dZ = float((Z - Zp).abs().max())
    same = [a.tolist() for a in st] == [b.tolist() for b in stp]
    print(f'  schur_qr (window {w}), {QR_MODEL_BUDGET} sweeps on a random '
          f'batch B={B} n={n}: max|T - T_model| = {dT:.3e} ({dT / a2:.2e} '
          f'||A||_2), max|Z - Z_model| = {dZ:.3e}; (hi, sweeps, rotations) '
          f'kernel {[a.tolist() for a in st]} model '
          f'{[b.tolist() for b in stp]}; (below the subdiagonal, upper '
          f'triangle against T, unitarity of Z) kernel ({pk[0]:.2e}, '
          f'{pk[1]:.2e}, {pk[2]:.2e}) model ({pp[0]:.2e}, {pp[1]:.2e}, '
          f'{pp[2]:.2e}); model {secs:.1f} s')
    check(max(pk[:3]) <= 1e-5 and max(pp[:3]) <= 1e-5,
          f'schur_qr at n = {n}, {QR_MODEL_BUDGET} sweeps: kernel and model '
          'each keep a unitary Hessenberg similarity (1e-5)')
    check(dT <= 1e-4 * a2 and dZ <= 1e-4 and same,
          f'schur_qr at n = {n} == the model of its schedule after '
          f'{QR_MODEL_BUDGET} sweeps: T within 1e-4 ||A||_2, Z within 1e-4, '
          'the same stats')
    return dT / a2


def alt_times(torch, ek, smi, H6, Q6, out, times, bounds):
    """Phase 11: the stand-alone stages beside schur_qr and the routes."""
    from torcwa_tpu_torch.ops import (eig_qr as eq, schur_ms as sm,
                                      schur_qr_ms as sq)
    B6, n6 = H6.shape[0], H6.shape[-1]
    t_qr = cuda_ms(torch, lambda: ek.schur_qr(H6, Q6), reps=3)
    t_v2 = cuda_ms(torch, lambda: ek.schur_qr_v2(H6, Q6), reps=3)
    old = QR_MS_PER_ROTATION
    print(f'  the (8, 338, 338) order-6 batch at 0 deg: schur_qr {t_qr:.2f} '
          f'ms, schur_qr_v2 {t_v2:.2f} ms; the per-rotation kernel they '
          f'replaced {old["schur_qr"]} and {old["schur_qr_v2"]} ms '
          f'(PERF.md) [{smi}]')
    full_v2 = bound(4 * B6 * n6 * n6 * C64, out['v2_rot'] * 2 * n6 * 20)
    print(f'  the (8, 338, 338) order-6 batch, whole Schur form: schur_qr_v2 '
          f'{t_v2:.3f} ms (bound {full_v2[0]:.4f} ms by {full_v2[1]}, '
          f'{out["v2_rot"]} rotations), schur_qr {t_qr:.3f} ms [{smi}]')
    # the record holds the first V2_BUDGET sweeps, which the plain version
    # can be timed on; H, Q read, T, Z written; this run's rotations x their
    # 2n element pairs x 20 flops
    times['schur_qr_v2'] = (*out['v2_budget_ms'],
                            f'B=8 n=338, the first {V2_BUDGET} sweeps')
    bounds['schur_qr_v2'] = bound(4 * B6 * n6 * n6 * C64,
                                  out['v2_budget_rot'] * 2 * n6 * 20)
    out['v2_full'] = (t_v2, full_v2)
    stage = eq.lane_by_lane(sq.schur_qr_ms, m=MS_M)
    print('  one wave matrix (500 nm, 10 deg), median of 3; the small and '
          'the large route of eig_qr on the same matrices stand in phase 7:')
    for n, rec in out['ms'].items():
        A, H, Q = rec['A'], rec['H'], rec['Q']
        H1, Q1 = H[None].contiguous(), Q[None].contiguous()
        t8 = cuda_ms(torch, lambda: sq.schur_qr_ms(H, Q, m=8), reps=3)
        t16 = cuda_ms(torch, lambda: sq.schur_qr_ms(H, Q, m=MS_M), reps=3)
        s8 = [int(x) for x in sq.schur_qr_ms(H, Q, m=8,
                                             return_stats=True)[2]]
        t1 = cuda_ms(torch, lambda: ek.schur_qr(H1, Q1), reps=3)
        t2 = cuda_ms(torch, lambda: ek.schur_qr_v2(H1, Q1), reps=3)
        te = cuda_ms(torch, lambda: eq.eig_small(A, stage), reps=3)
        tl = cuda_ms(torch, lambda: torch.linalg.eig(A), reps=3)
        b = bound(4 * n * n * C64, rec['st'][2] * 2 * n * 20)
        print(f'    n = {n}: schur_qr_ms m={MS_M} {t16:.1f} ms '
              f'({rec["st"][1]} sweeps, {rec["st"][2]} rotations, bound '
              f'{b[0]:.4f} ms by {b[1]}), m=8 {t8:.1f} ms ({s8[1]} sweeps); '
              f'schur_qr on the same H, Q {t1:.1f} ms, schur_qr_v2 {t2:.1f} '
              f'ms; the composed eig through schur_qr_ms {te:.1f} ms; '
              f'library figure torch.linalg.eig complex64 {tl:.1f} ms '
              f'(all stages) [{smi}]')
        if n == n6:
            times['schur_qr_ms'] = (t16, out['ms_plain_ms'],
                                    f'n={n} m={MS_M}, one wave matrix; '
                                    'plain: one run, in phase 10')
            bounds['schur_qr_ms'] = b
    H, Q, cfg = out['H640'], out['Q640'], out['cfg640']
    t_off = cuda_ms(torch, lambda: sm.schur_ms(H, Q, aed=False, **cfg),
                    reps=3)
    t_on = cuda_ms(torch, lambda: sm.schur_ms(H, Q, **cfg), reps=3)
    print(f'  schur_ms at n = {N_BIG}, m = {cfg["m"]}: aed=False {t_off:.1f} '
          f'ms in {out["sweeps640"][0]} sweeps, aed=True {t_on:.1f} ms in '
          f'{out["sweeps640"][1]} sweeps [{smi}]')


def batched_alt_checks(torch, ek, dev, out):
    """Phase 12: schur_qr_baed and schur_qr_packed against their plain
    versions on random complex64 batches."""
    from torcwa_tpu_torch.ops import schur_qr_baed as sb, schur_qr_packed as sp
    c128 = torch.complex128

    def batch_quality(A, T, Z):
        q = [schur_quality(torch, A[b], T[b], Z[b]) for b in range(len(A))]
        return max(x[0] for x in q), max(x[1] for x in q), \
            all(x[2] for x in q)

    def sets(A, T, Tp):
        """Eigenvalue sets, kernel against plain (on the lanes Tp has) and
        against complex128 (every lane), largest over the lanes, relative
        to the spectral radius."""
        d = do = 0.
        for b in range(len(A)):
            w = torch.diagonal(T[b])
            w_ref = torch.linalg.eigvals(A[b].to(c128))
            rho = float(w_ref.abs().max())
            do = max(do, set_dist(w.to(c128), w_ref) / rho)
            if b < len(Tp):
                d = max(d, set_dist(w, torch.diagonal(Tp[b])) / rho)
        return d, do

    for B, n in ((2, 96), (8, 112)):
        A = torch.stack([rand_c64(torch, n, 1000 * n + b, dev)
                         for b in range(B)])
        H, Q = ek.hessenberg(A)
        T, Z, st = sb.schur_qr_baed(H, Q, return_stats=True)
        # the plain version goes lane by lane, ~10-20 s a lane at this size
        # (a Python AED pass and a Python chase per sweep): the first
        # PLAIN_LANES lanes
        t0 = time.perf_counter()
        Tp, Zp, stp = sb.schur_qr_baed_plain(H[:PLAIN_LANES], Q[:PLAIN_LANES],
                                             return_stats=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        d, do = sets(A, T, Tp)
        res, orth, tri = batch_quality(A, T, Z)
        print(f'-- schur_qr_baed B={B} n={n} m=8 kw=64: sweeps kernel '
              f'{st[1].tolist()} plain (first {len(Tp)} lanes) '
              f'{stp[1].tolist()} in {secs:.1f} s; '
              f'rotations {st[2].tolist()} / {stp[2].tolist()}; rows AED '
              f'deflated {st[3].tolist()} / {stp[3].tolist()}; eigenvalue '
              f'sets differ by {d:.2e} of the spectral radius, from '
              f'complex128 LAPACK by {do:.2e}; residual {res:.2e}, unitarity '
              f'{orth:.2e}')
        check(bool((st[0] == 0).all()) and bool((stp[0] == 0).all()),
              f'schur_qr_baed ({B}, {n}): every lane converged, kernel and '
              'plain')
        check(d <= 1e-4 and do <= 1e-4, f'schur_qr_baed ({B}, {n}): kernel '
              '== plain == complex128 eigenvalues <= 1e-4')
        check(res <= 1e-5 and orth <= 1e-5 and tri, f'schur_qr_baed ({B}, '
              f'{n}): Schur residual and unitarity <= 1e-5, T triangular')
        mk, mp = int(st[1][:len(Tp)].max()), int(stp[1].max())
        check(0.5 * mp <= mk <= 2 * mp and bool((st[3] > n // 2).all()),
              f'schur_qr_baed ({B}, {n}): sweeps within 2x of plain, AED '
              'deflates most rows')

        T, Z, st = sp.schur_qr_packed(H, Q, return_stats=True)
        t0 = time.perf_counter()
        Tp, Zp, stp = sp.schur_qr_packed_plain(H, Q, return_stats=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        d, do = sets(A, T, Tp)
        res, orth, tri = batch_quality(A, T, Z)
        print(f'-- schur_qr_packed B={B} n={n}: sweeps kernel '
              f'{st[1].tolist()} plain {stp[1].tolist()} in {secs:.1f} s; '
              f'rotations {st[2].tolist()} / {stp[2].tolist()}; eigenvalue '
              f'sets differ by {d:.2e} of the spectral radius, from '
              f'complex128 LAPACK by {do:.2e}; residual {res:.2e}, unitarity '
              f'{orth:.2e}')
        check(bool((st[0] == 0).all()) and bool((stp[0] == 0).all()),
              f'schur_qr_packed ({B}, {n}): every lane converged, kernel and '
              'plain')
        check(d <= 1e-4 and do <= 1e-4, f'schur_qr_packed ({B}, {n}): kernel '
              '== plain == complex128 eigenvalues <= 1e-4')
        check(res <= 1e-5 and orth <= 1e-5 and tri, f'schur_qr_packed ({B}, '
              f'{n}): Schur residual and unitarity <= 1e-5, T triangular')
        mk, mp = int(st[1].max()), int(stp[1].max())
        check(0.5 * mp <= mk <= 2 * mp,
              f'schur_qr_packed ({B}, {n}): sweeps within 2x of plain')
        # one sweep is forward-stable on a random batch: element by element
        # (after one sweep the diagonal is NaN by contract: the strict upper
        # part of T, and Z)
        T1, Z1 = sp.schur_qr_packed(H, Q, max_iters=1)
        T1p, Z1p = sp.schur_qr_packed_plain(H, Q, max_iters=1)
        a2 = float(torch.linalg.matrix_norm(A, ord=2).min())
        dT = float((torch.triu(T1, 1) - torch.triu(T1p, 1)).abs().max())
        dZ = float((Z1 - Z1p).abs().max())
        print(f'   one sweep: max|T - T_plain| = {dT:.3e} ({dT / a2:.2e} '
              f'||A||_2), max|Z - Z_plain| = {dZ:.3e}')
        check(dT <= 1e-4 * a2 and dZ <= 1e-4, f'schur_qr_packed ({B}, {n}), '
              'one sweep: kernel == plain element-wise, T within 1e-4 '
              '||A||_2, Z within 1e-4')

    # lanes of different kinds in one launch: exactly real, antisymmetric
    # (purely imaginary spectrum), complex, and one that is triangular already
    n = 96
    rng = np.random.default_rng(3)
    A0 = rng.standard_normal((n, n))
    Bm = rng.standard_normal((n, n))
    lanes = [A0, Bm - Bm.T, rng.standard_normal((n, n))
             + 1j * rng.standard_normal((n, n)),
             np.triu(rng.standard_normal((n, n)))]
    A = torch.as_tensor(np.stack(lanes).astype(np.complex64) * 0.3,
                        device=dev)
    H, Q = ek.hessenberg(A)
    H[3], Q[3] = A[3], torch.eye(n, dtype=A.dtype, device=dev)
    T, Z, st = sb.schur_qr_baed(H, Q, return_stats=True)
    res, orth, tri = batch_quality(A, T, Z)
    do = max(set_dist(torch.diagonal(T[b]).to(c128),
                      torch.linalg.eigvals(A[b].to(c128)))
             / float(A[b].abs().max()) for b in range(len(A)))
    print(f'-- schur_qr_baed, a real, an antisymmetric, a complex and a '
          f'triangular lane in one launch (n = {n}): sweeps {st[1].tolist()},'
          f' rotations {st[2].tolist()}; eigenvalues vs complex128 {do:.2e} '
          f'max|A|; residual {res:.2e}, unitarity {orth:.2e}')
    check(bool((st[0] == 0).all()) and do <= 1e-4 and res <= 1e-5
          and orth <= 1e-5 and tri,
          'schur_qr_baed, lanes of different kinds: converged, eigenvalues '
          '<= 1e-4, residual and unitarity <= 1e-5')
    check(int(st[1][3]) <= 2 and int(st[2][3]) == 0
          and int(st[1][:3].min()) > 2,
          'schur_qr_baed counts sweeps per lane (the triangular lane ends at '
          'once)')

    T1, _, st1 = sb.schur_qr_baed(H, Q, max_iter_factor=-100,
                                  return_stats=True)
    check(bool((st1[0] > 0).all()) and bool((st1[1] == 0).all()) and bool(
        torch.isnan(torch.diagonal(T1, dim1=-2, dim2=-1)).all()),
        'schur_qr_baed with a negative budget: no sweep, NaN eigenvalues')
    T1, _, st1 = sp.schur_qr_packed(H[:3].contiguous(), Q[:3].contiguous(),
                                    max_iter_factor=1, return_stats=True)
    check(bool((st1[0] > 0).all()) and bool(
        torch.isnan(torch.diagonal(T1, dim1=-2, dim2=-1)).all()),
        'schur_qr_packed with max_iter_factor=1: NaN eigenvalues')

    def raises(exc, fn, *a, **kw):
        try:
            fn(*a, **kw)
        except exc:
            return True
        return False

    Hs, Qs = H[:, :64, :64].contiguous(), Q[:, :64, :64].contiguous()
    check(raises(ValueError, sb.schur_qr_baed, Hs, Qs),
          'schur_qr_baed raises ValueError for n = 64 < kw + 10')
    check(raises(TypeError, sb.schur_qr_baed, H.to(c128), Q.to(c128))
          and raises(TypeError, sp.schur_qr_packed, H.to(c128), Q.to(c128)),
          'both raise TypeError for complex128 on the card')


def batched_alt_path(torch, tp, ek, dev, eps32, out):
    """Phase 13: the composed eig and the 8-wavelength sweep through
    schur_qr_baed and schur_qr_packed at full width."""
    from torcwa_tpu_torch.ops import (eig_qr as eq, schur_qr_baed as sb,
                                      schur_qr_packed as sp)
    c128 = torch.complex128
    inc = math.radians(WELL_POSED_DEG)
    stages = {'schur_qr_baed': sb.schur_qr_baed,
              'schur_qr_packed': sp.schur_qr_packed}
    out['wave'] = {}
    for order in (6, 7, 8):
        _, A = wave_matrices(torch, tp, (order, order), LAMS, inc,
                             torch.float32, dev)
        A = A.contiguous()
        H, Q = ek.hessenberg(A)
        out['wave'][A.shape[-1]] = dict(A=A, H=H, Q=Q)
        if order == 8:          # timed in phase 14 only
            continue
        B, n = A.shape[0], A.shape[-1]
        w_ref = [torch.linalg.eigvals(A[b].to(c128)) for b in range(B)]
        for name, stage in stages.items():
            print(f'-- hessenberg -> {name} -> tri_vectors, the order-{order} '
                  f'wave matrices at {WELL_POSED_DEG} deg, B={B} n={n}')
            T, Z, st = stage(H, Q, return_stats=True)
            q = [schur_quality(torch, A[b], T[b], Z[b]) for b in range(B)]
            res, orth = max(x[0] for x in q), max(x[1] for x in q)
            dw = max(set_dist(torch.diagonal(T[b]).to(c128), w_ref[b])
                     / float(w_ref[b].abs().max()) for b in range(B))
            print(f'  sweeps {st[1].tolist()}, rotations {st[2].tolist()}'
                  + (f', rows AED deflated {st[3].tolist()}'
                     if len(st) > 3 else '')
                  + f'; Schur residual {res:.2e}, unitarity {orth:.2e}, '
                  f'eigenvalues vs complex128 {dw:.2e} of the spectral '
                  'radius')
            check(bool((st[0] == 0).all()) and all(x[2] for x in q)
                  and res <= 1e-5 and orth <= 1e-5 and dw <= 1e-4,
                  f'{name} n={n}: every lane converged, Schur residual and '
                  'unitarity <= 1e-5, eigenvalues <= 1e-4')
            w, V = eq.eig_small(A, stage)
            eig_checks(torch, f'{name}, order {order}', A, w, V)

    # the sweeps, with the small route's Schur stage swapped
    oracle = {}

    def sweep(name, order, tilt_deg):
        label = (f'order-{order} sweep of {len(LAMS)} wavelengths at '
                 f'{tilt_deg} deg through {name}')
        tilt = math.radians(tilt_deg)
        keep = eq.SMALL_SCHUR
        eq.SMALL_SCHUR = stages[name]
        try:
            ek.reset_launch_counts()
            T_k, g_k = fwd_grad(torch, tp, eps32, LAMS, (order, order), tilt,
                                'kernels')
            torch.cuda.synchronize()
            lm = dict(ek.LAUNCHES)
        finally:
            eq.SMALL_SCHUR = keep
        if (order, tilt_deg) not in oracle:
            oracle[order, tilt_deg] = fwd_grad(
                torch, tp, eps32.double(), LAMS, (order, order), tilt,
                'torch')
        T_o, g_o = oracle[order, tilt_deg]
        dT = float((T_k.double() - T_o).abs().max())
        cos_k = cosine(g_k, g_o)
        print(f'-- {label}: launches {lm}; |t_xx|^2 {T_k.tolist()}; vs the '
              f'complex128 oracle {dT:.2e}; raster-gradient cosine '
              f'{cos_k:.6f}')
        check(lm[name] >= 1 and lm['schur_qr'] == 0 and lm['schur_ms'] == 0
              and lm['hessenberg'] >= 1 and lm['tri_vectors'] >= 1,
              f'{label}: {name} launched ({lm[name]}), schur_qr and schur_ms '
              'not')
        check(dT <= 1e-4, f'{label}: |t_xx|^2 vs oracle {dT:.2e} <= 1e-4')
        check(bool(torch.isfinite(g_k).all()), f'{label}: gradient finite')
        if tilt_deg >= WELL_POSED_DEG:
            check(cos_k >= 0.99, f'{label}: raster gradient cosine '
                  f'{cos_k:.6f} >= 0.99')
        return lm[name]

    sweep('schur_qr_baed', 6, 0.)
    out['launches'] = {
        'schur_qr_baed': sweep('schur_qr_baed', 6, WELL_POSED_DEG),
        'schur_qr_packed': sweep('schur_qr_packed', 6, WELL_POSED_DEG)}
    sweep('schur_qr_baed', 7, WELL_POSED_DEG)


def batched_alt_times(torch, tp, ek, smi, eps32, out, times, bounds):
    """Phase 14: the two batched stages beside schur_qr, and the B = 8 batch
    through the large route."""
    from functools import partial
    from torcwa_tpu_torch.ops import (eig_qr as eq, schur_qr_baed as sb,
                                      schur_qr_packed as sp)
    inc = math.radians(WELL_POSED_DEG)
    baed16 = partial(sb.schur_qr_baed, m=16)
    print(f'  the 8-wavelength wave matrices at {WELL_POSED_DEG} deg, median '
          'of 3, ms:')
    for n, rec in out['wave'].items():
        A, H, Q = rec['A'], rec['H'], rec['Q']
        B = A.shape[0]
        t_qr = cuda_ms(torch, lambda: ek.schur_qr(H, Q), reps=3)
        t_v2 = cuda_ms(torch, lambda: ek.schur_qr_v2(H, Q), reps=3)
        print(f'    B = {B}, n = {n}: schur_qr {t_qr:.2f} ms, schur_qr_v2 '
              f'{t_v2:.2f} ms; the per-rotation schur_qr they replaced '
              f'{QR_MS_PER_ROTATION[n]} ms (PERF.md) [{smi}]')
        t_pk = cuda_ms(torch, lambda: sp.schur_qr_packed(H, Q), reps=3)
        t_b8 = cuda_ms(torch, lambda: sb.schur_qr_baed(H, Q), reps=3)
        t_b16 = cuda_ms(torch, lambda: baed16(H, Q), reps=3)
        s_qr = ek.schur_qr(H, Q, return_stats=True)[2]
        s_pk = sp.schur_qr_packed(H, Q, return_stats=True)[2]
        s_b8 = sb.schur_qr_baed(H, Q, return_stats=True)[2]
        s_b16 = baed16(H, Q, return_stats=True)[2]
        info = sb.schur_qr_baed_cluster_info(n)
        one_wave = 0 < B <= info['clusters_at_once']
        print(f'    B = {B}, n = {n}: schur_qr_baed fits a cluster of '
              f'{info["cluster"]} CTAs a matrix (0: the one-block kernel), '
              f'{info["smem_bytes"]} bytes of shared memory a CTA, '
              f'{info["clusters_at_once"]} clusters at once on this card: '
              f'this batch runs on '
              + (f'clusters of {info["cluster"]}' if one_wave
                 else 'the one-block kernel'))
        check(info['cluster'] == sb.schur_qr_baed_cluster(n),
              f'n = {n}: the C entry point\'s cluster size is the one '
              'schur_qr_baed_cluster names')
        ok = all(bool((s[0] == 0).all()) for s in (s_qr, s_pk, s_b8, s_b16))
        check(ok, f'n = {n}: schur_qr, schur_qr_packed and schur_qr_baed '
              '(m = 8, 16) converge on every lane')
        b_pk = bound(4 * B * n * n * C64, int(s_pk[2].sum()) * 2 * n * 20)
        b_b8 = bound(4 * B * n * n * C64, int(s_b8[2].sum()) * 2 * n * 20
                     + 8 * int(s_b8[4].sum()))
        print(f'    B = {B}, n = {n}: schur_qr {t_qr:.1f} (sweeps '
              f'{s_qr[1].tolist()}); schur_qr_packed {t_pk:.1f} (sweeps '
              f'{s_pk[1].tolist()}, rotations {s_pk[2].tolist()}, bound '
              f'{b_pk[0]:.4f} by {b_pk[1]}); schur_qr_baed m=8 {t_b8:.1f} '
              f'(sweeps {s_b8[1].tolist()}, rotations {s_b8[2].tolist()}, '
              f'rows AED deflated {s_b8[3].tolist()}, bound {b_b8[0]:.4f} by '
              f'{b_b8[1]}), m=16 {t_b16:.1f} (sweeps {s_b16[1].tolist()}, '
              f'rotations {s_b16[2].tolist()}) [{smi}]')
        t_e = {k: cuda_ms(torch, lambda f=f: eq.eig_small(A, f), reps=3)
               for k, f in (('schur_qr', ek.schur_qr),
                            ('schur_qr_packed', sp.schur_qr_packed),
                            ('schur_qr_baed', sb.schur_qr_baed))}
        t_lib = cuda_ms(torch, lambda: torch.linalg.eig(A), reps=1)
        print(f'    B = {B}, n = {n}: the composed eig through '
              + ', '.join(f'{k} {v:.1f}' for k, v in t_e.items())
              + f'; library figure torch.linalg.eig complex64 {t_lib:.1f} '
              f'(all stages, one run) [{smi}]')
        if n == 338:
            out['full'] = {'schur_qr_baed': (t_b8, b_b8),
                           'schur_qr_packed': (t_pk, b_pk)}

    # the work the plain versions can be timed on, from the order-6 H, Q.
    # Kernel and plain meet at this shape as schur_qr_v2 and its plain
    # version do in phase 10: after the budget each must hold a unitary Z
    # whose similarity Z^H A Z is upper Hessenberg with T as its strict upper
    # triangle (an unfinished lane's diagonal is NaN by contract), what each
    # has deflated must be eigenvalues of A, and the two must have come as
    # far (rows deflated, window bottoms)
    rec = out['wave'][338]
    A, H, Q = rec['A'], rec['H'], rec['Q']
    B, n = H.shape[0], H.shape[-1]
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))

    def budgeted(name, kernel, plain, budget, aed):
        kernel(H, Q, max_iters=budget)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        Tk, Zk, sk = kernel(H, Q, max_iters=budget, return_stats=True)
        ev[1].record()
        ev[2].record()
        Tp, Zp, skp = plain(H, Q, max_iters=budget, return_stats=True)
        ev[3].record()
        ev[3].synchronize()
        t_k, t_p = ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])
        pk = partial_state(torch, A, w_ref, Tk, Zk, sk[0], poisoned=True)
        pp = partial_state(torch, A, w_ref, Tp, Zp, skp[0], poisoned=True)
        rk, rp = int(sk[2].sum()), int(skp[2].sum())
        cols = (0, 2, 3) if aed else (0, 2)
        print(f'  {name}, the first {budget} sweeps at B={B} n={n}: kernel '
              f'{t_k:.1f} ms, plain {t_p:.1f} ms; (bottom, rotations'
              + (', rows AED deflated' if aed else '') + ') kernel '
              + ' '.join(str(sk[i].tolist()) for i in cols) + ' plain '
              + ' '.join(str(skp[i].tolist()) for i in cols)
              + '; (below the subdiagonal of Z^H A Z, its strict upper '
              'triangle against T, unitarity of Z, deflated eigenvalues '
              'against complex128, eigenvalues deflated) kernel '
              f'({pk[0]:.2e}, {pk[1]:.2e}, {pk[2]:.2e}, {pk[3]:.2e}, {pk[4]}) '
              f'plain ({pp[0]:.2e}, {pp[1]:.2e}, {pp[2]:.2e}, {pp[3]:.2e}, '
              f'{pp[4]}) [{smi}]')
        check(bool((sk[1] == budget).all()) and bool((skp[1] == budget).all())
              and 0.5 * rp <= rk <= 2 * rp,
              f'{name}, {budget} sweeps on the wave matrices: kernel and '
              'plain rotate within 2x of each other')
        check(max(pk[:3]) <= 1e-5 and pk[3] <= 1e-4 and max(pp[:3]) <= 1e-5
              and pp[3] <= 1e-4,
              f'{name}, {budget} sweeps: kernel and plain each keep a unitary '
              'Hessenberg similarity with T its strict upper triangle (1e-5) '
              'and deflate eigenvalues of A (1e-4)')
        gap = int((sk[0] - skp[0]).abs().max())
        check(gap <= BOTTOM_BAND and 0.5 * pp[4] <= pk[4] <= 2 * pp[4],
              f'{name}, {budget} sweeps: window bottoms of kernel and plain '
              f'within {BOTTOM_BAND} rows of each other on every lane '
              f'({gap}), rows deflated within 2x')
        if aed:
            dk = int((sk[3] - skp[3]).abs().max())
            check(bool((sk[3] >= 1).all()) and dk <= BOTTOM_BAND,
                  f'{name}, {budget} sweeps: AED deflates on every lane, '
                  f'kernel and plain within {BOTTOM_BAND} rows per lane '
                  f'({dk})')
        return t_k, t_p, sk

    t_k, t_p, sk = budgeted('schur_qr_baed', sb.schur_qr_baed,
                            sb.schur_qr_baed_plain, BAED_BUDGET, True)
    times['schur_qr_baed'] = (t_k, t_p, f'B=8 n=338 m=8 kw=64, the first '
                              f'{BAED_BUDGET} sweeps')
    bounds['schur_qr_baed'] = bound(4 * B * n * n * C64,
                                    int(sk[2].sum()) * 2 * n * 20
                                    + 8 * int(sk[4].sum()))
    t_k, t_p, sk = budgeted('schur_qr_packed', sp.schur_qr_packed,
                            sp.schur_qr_packed_plain, PACKED_BUDGET, False)
    times['schur_qr_packed'] = (t_k, t_p, f'B=8 n=338, the first '
                                f'{PACKED_BUDGET} sweeps')
    bounds['schur_qr_packed'] = bound(4 * B * n * n * C64,
                                      int(sk[2].sum()) * 2 * n * 20)

    # one sweep is forward-stable on a random batch of the path's shape:
    # schur_qr_packed element by element (the strict upper part of T, whose
    # diagonal is NaN after one sweep, and Z), as schur_qr_v2 in phase 10;
    # schur_qr_baed, whose first sweep on a random matrix is an AED pass
    # that deflates nothing and a chase of m bulges, likewise
    Ar = torch.stack([rand_c64(torch, n, 100 + b, A.device)
                      for b in range(B)])
    Hr, Qr = ek.hessenberg(Ar)
    a2 = float(torch.linalg.matrix_norm(Ar, ord=2).min())
    for name, kernel, plain in (
            ('schur_qr_packed', sp.schur_qr_packed, sp.schur_qr_packed_plain),
            ('schur_qr_baed', sb.schur_qr_baed, sb.schur_qr_baed_plain)):
        T1, Z1 = kernel(Hr, Qr, max_iters=1)
        T1p, Z1p = plain(Hr, Qr, max_iters=1)
        dT = float((torch.triu(T1, 1) - torch.triu(T1p, 1)).abs().max())
        dZ = float((Z1 - Z1p).abs().max())
        print(f'  {name}, one sweep on a random batch, B={B} n={n}: '
              f'max|T - T_plain| = {dT:.3e} ({dT / a2:.2e} ||A||_2), '
              f'max|Z - Z_plain| = {dZ:.3e}')
        check(dT <= 1e-4 * a2 and dZ <= 1e-4,
              f'{name} ({B}, {n}), one sweep: kernel == plain element-wise, '
              'T within 1e-4 ||A||_2, Z within 1e-4')
        out['err_' + name[len('schur_qr_'):]] = dT
    # schur_qr_baed's other kernels (phase 13's n = 450 on a cluster of 16,
    # n = 578 on the one-block kernel), one sweep on two random lanes
    for n_b in (450, 578):
        Ar = torch.stack([rand_c64(torch, n_b, 100 + b, A.device)
                          for b in range(2)])
        Hr, Qr = ek.hessenberg(Ar)
        a2 = float(torch.linalg.matrix_norm(Ar, ord=2).min())
        T1, Z1 = sb.schur_qr_baed(Hr, Qr, max_iters=1)
        T1p, Z1p = sb.schur_qr_baed_plain(Hr, Qr, max_iters=1)
        dT = float((torch.triu(T1, 1) - torch.triu(T1p, 1)).abs().max())
        dZ = float((Z1 - Z1p).abs().max())
        print(f'  schur_qr_baed (cluster {sb.schur_qr_baed_cluster(n_b)}), '
              f'one sweep on a random batch, B=2 n={n_b}: max|T - T_plain| = '
              f'{dT:.3e} ({dT / a2:.2e} ||A||_2), max|Z - Z_plain| = {dZ:.3e}')
        check(dT <= 1e-4 * a2 and dZ <= 1e-4,
              f'schur_qr_baed (2, {n_b}), one sweep: kernel == plain '
              'element-wise, T within 1e-4 ||A||_2, Z within 1e-4')

    # the order-6 sweep through each stage beside the default
    keep = eq.SMALL_SCHUR
    try:
        for name, stage in (('schur_qr (the route)', ek.schur_qr),
                            ('schur_qr_packed', sp.schur_qr_packed),
                            ('schur_qr_baed', sb.schur_qr_baed),
                            ('schur_qr_baed m=16', baed16)):
            eq.SMALL_SCHUR = stage
            ms = cuda_ms(torch, lambda: fwd_grad(torch, tp, eps32, LAMS,
                                                 (6, 6), inc, 'kernels'),
                         reps=3)
            print(f'  order-6 fwd+grad at {WELL_POSED_DEG} deg through '
                  f'{name}: {ms / len(LAMS) / 1e3:.6f} s/solve ({ms:.3f} ms '
                  f'per 8-wavelength sweep) [{smi}]')
    finally:
        eq.SMALL_SCHUR = keep

    # the same batches through the large route, its Schur stage's lanes in
    # lock step and the other stages lane by lane (one run, its
    # kernels warm from phase 7: host-paced seconds; the small route on the
    # same batch is the composed eig through schur_qr above)
    keep = eq.LARGE_MIN_N
    eq.LARGE_MIN_N = 0
    try:
        for n in (450, 578):
            A = out['wave'][n]['A']
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            eq.eig_qr(A)
            ev[1].record()
            ev[1].synchronize()
            t_large = ev[0].elapsed_time(ev[1])
            print(f'    eig_qr on the B = {A.shape[0]}, n = {n} batch through '
                  f'the large route: {t_large:.1f} ms [{smi}]')
    finally:
        eq.LARGE_MIN_N = keep


def class_stack(torch, tp, dev, occ, circ, si, dtype, backend):
    """Phase 15's stack through the class API, solved."""
    sim = tp.rcwa(freq=1 / CLASS_LAM, order=list(CLASS_ORDER), L=L,
                  dtype=dtype, device=dev, eig_backend=backend)
    sim.add_input_layer(eps=EPS_SUB)
    sim.add_output_layer(eps=1.)
    sim.set_incident_angle(math.radians(WELL_POSED_DEG), 0.)
    sim.add_layer(thickness=300., eps=occ * si + (1. - occ))
    sim.add_layer(thickness=200., eps=SU8_EPS)
    sim.add_layer(thickness=150., eps=circ * EPS_HI + (1. - circ))
    sim.solve_global_smatrix()
    return sim


def class_txx(sim):
    """|t_xx(0, 0)|^2 of a solved class instance."""
    t = sim.S_parameters([0, 0], polarization='xx')
    return (t.real ** 2 + t.imag ** 2)[0]


def pin_check(torch, loss_of, x):
    """With TF32 switched on by the caller, run loss_of(x) forward and
    backward while a dispatch mode records the three float32 switches at
    every product, solve and inverse.  Returns (records forward, records
    backward, every record pinned, the caller's setting back after each)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torcwa_tpu_torch._constants import _switches

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in PINNED_OPS:
                self.seen.append(_switches())
            return func(*args, **(kwargs or {}))

    keep = _switches()
    tf32 = (True, True, 'high')
    try:
        torch.set_float32_matmul_precision('high')
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        xl = x.detach().clone().requires_grad_(True)
        with Record() as fwd:
            T = loss_of(xl)
        back_f = _switches() == tf32
        with Record() as bwd:
            T.backward()
            torch.cuda.synchronize()
        back_b = _switches() == tf32
    finally:
        torch.set_float32_matmul_precision(keep[2])
        torch.backends.cuda.matmul.allow_tf32 = keep[0]
        torch.backends.cudnn.allow_tf32 = keep[1]
    pinned = all(r == (False, False, 'highest') for r in fwd.seen + bwd.seen)
    return len(fwd.seen), len(bwd.seen), pinned, back_f and back_b


def class_api_phase(torch, tp, ek, smi, dev, out):
    """Phase 15: the class API on the card (stack of class_stack, order 6,
    complex64, through the eig kernels) against the same class at
    complex128 through torch.linalg.eig, and at order 10 against the
    functional path; launch counts, the kernels by name in a profile,
    times, device time and idle share, and the scoped pin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    c64, c128 = torch.complex64, torch.complex128
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=GRID, ny=GRID, edge_sharpness=1000.,
                    dtype=torch.float32, device=dev)
    occ = g.rectangle(180., 100., L[0] / 2., L[1] / 2.)
    circ = g.circle(80., L[0] / 2., L[1] / 2.)
    si = tp.aSiH(device=dev).eps(CLASS_LAM)
    print(f'  a-Si:H eps at {CLASS_LAM} nm from the copied table: '
          f'{complex(si):.6f}')

    def solve(o, dtype=c64, backend='kernels'):
        c = circ if dtype == c64 else circ.double()
        return class_stack(torch, tp, dev, o, c, si, dtype, backend)

    # the path: forward and raster gradient through the kernels
    ek.reset_launch_counts()
    o32 = occ.clone().requires_grad_(True)
    sk = solve(o32)
    class_txx(sk).backward()
    torch.cuda.synchronize()
    launches = dict(ek.LAUNCHES)
    print(f'  launches of the order-6 class solve, fwd+bwd: {launches}')
    for k in SMALL:
        check(launches[k] > 0,
              f'class API: {k} kernel launched ({launches[k]})')
    check(not any(v for k, v in launches.items() if k not in SMALL),
          'class API at order 6: no other eig kernel launched')
    out['launches'] = {k: launches[k] for k in SMALL}
    o64 = occ.double().requires_grad_(True)
    so = solve(o64, c128, 'torch')
    class_txx(so).backward()

    worst = 0.
    with torch.no_grad():
        for pol in ('xx', 'yy', 'pp', 'ss'):
            for port in ('transmission', 'reflection'):
                a = sk.S_parameters(CLASS_ORDERS, port=port,
                                    polarization=pol)
                b = so.S_parameters(CLASS_ORDERS, port=port,
                                    polarization=pol)
                worst = max(worst, float((a.abs().double() ** 2
                                          - b.abs() ** 2).abs().max()))
    print(f'  |S|^2 at {len(CLASS_ORDERS)} orders, xx yy pp ss, both ports: '
          f'kernels (complex64) against torch.linalg.eig (complex128) '
          f'{worst:.2e}')
    check(worst <= 1e-4, f'class API |S|^2 vs complex128 oracle: '
          f'{worst:.2e} <= 1e-4')
    x = torch.linspace(0., L[0], 16)
    z = np.linspace(-100., 750., 8)
    fields = []
    for s in (sk, so):
        s.source_planewave(amplitude=[1., 0.])
        with torch.no_grad():
            fields.append(s.field_xz(x, z, L[1] / 2.))
    for i, what in ((0, 'E'), (1, 'H')):
        fk = torch.stack(fields[0][i]).to(c128)
        fo = torch.stack(fields[1][i])
        err = float((fk - fo).abs().max() / fo.abs().max())
        print(f'  field_xz {what} at 8 z samples: {err:.2e} of max|{what}|')
        check(err <= 1e-3, f'class API field_xz {what} vs complex128 oracle: '
              f'{err:.2e} <= 1e-3 of max|{what}|')
    cos = cosine(o32.grad, o64.grad)
    print(f'  raster gradient of |t_xx|^2, first layer: cosine {cos:.6f}')
    check(cos >= 0.99, f'class API raster gradient cosine {cos:.6f} >= 0.99')

    # one layer at order 10 (2N = 882, the large route): class = functional
    gb = tp.geometry(Lx=L[0], Ly=L[1], nx=GRID, ny=GRID, edge_sharpness=500.,
                     dtype=torch.float32, device=dev)
    ob = gb.rectangle(WIDTH, WIDTH, L[0] / 2., L[1] / 2.)
    eps_b = ob * EPS_HI + (1. - ob)
    inc = math.radians(WELL_POSED_DEG)
    ek.reset_launch_counts()
    sim = tp.rcwa(freq=1 / LAM_L[0], order=list(CLASS_ORDER_L), L=L,
                  device=dev)
    sim.add_input_layer(eps=EPS_SUB)
    sim.set_incident_angle(inc, 0.)
    sim.add_layer(thickness=THICK, eps=eps_b)
    sim.solve_global_smatrix()
    t_cls = class_txx(sim).item()
    torch.cuda.synchronize()
    large = {k: ek.LAUNCHES[k] for k in LARGE}
    out['launches_large'] = large
    t_fn = float(slice_loss(torch, tp, eps_b, LAM_L, CLASS_ORDER_L, inc,
                            'kernels')[0])
    print(f'  order 10, one layer: |t_xx|^2 class {t_cls:.8f}, functional '
          f'{t_fn:.8f}; large-route launches of the class {large}')
    check(all(v > 0 for v in large.values()),
          'class API at order 10 takes the large route')
    check(abs(t_cls - t_fn) <= 1e-5, f'class API = solve_stack_pair at order '
          f'10: {abs(t_cls - t_fn):.2e} <= 1e-5')

    # times, profile
    def fwd():
        return class_txx(solve(occ))

    def fwd_bwd():
        o = occ.clone().requires_grad_(True)
        class_txx(solve(o)).backward()

    ms_f = cuda_ms(torch, fwd, reps=3)
    ms_fb = cuda_ms(torch, fwd_bwd, reps=3)
    out['ms'] = (ms_f, ms_fb)
    print(f'  order-6 class solve (3 layers, 2 patterned): forward '
          f'{ms_f:.3f} ms, fwd+bwd {ms_fb:.3f} ms (CUDA events, median of 3) '
          f'[{smi}]')
    t0 = time.perf_counter()
    for _ in range(3):
        fwd_bwd()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    kern = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    shown = {k for k, ps in STAGE_KERNELS.items()
             if any(p in e.key for e in kern for p in ps)}
    library = sorted({e.key for e in ka if 'linalg_eig' in e.key})
    print(f'  fwd+bwd wall (no profiler, mean of 3) {wall_ms:.3f} ms; device '
          f'kernels {busy:.3f} ms (idle {1 - busy / wall_ms:.3f} of the wall) '
          f'[{smi}]')
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        print(f'  {e.self_device_time_total / 1e3:10.3f} ms x{e.count:5d}  '
              f'{e.key[:100]}')
    check(shown == set(SMALL), 'the class solve\'s profile shows '
          'hessenberg, schur_qr and tri_vectors by name')
    check(not library, f'no library eig in the class solve ({library})')
    out['device_ms'], out['idle'] = busy, 1 - busy / wall_ms

    n_f, n_b, pinned, back = pin_check(
        torch, lambda o: class_txx(solve(o)), occ)
    print(f'  with TF32 on outside: {n_f} products/solves/inverses forward, '
          f'{n_b} backward; all IEEE f32: {pinned}; TF32 setting back: {back}')
    check(n_f > 0 and n_b > 0 and pinned and back,
          'the class pins IEEE f32 forward and backward and restores the '
          'caller\'s TF32 setting')


def load_example(name):
    """The port's example script examples/torch/<name>.py as a module."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'examples', 'torch', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'torch_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def adam_run(torch, tp, fom, p0, kw, steps, state=None):
    """maximize_adam for `steps` steps: (params, (m, v, step), history,
    ms of each step between CUDA events recorded at its callback)."""
    ev = [torch.cuda.Event(enable_timing=True)]
    ev[0].record()

    def mark(rec):
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()

    params, opt, hist = tp.optim.maximize_adam(fom, p0, steps, callback=mark,
                                               state=state, **kw)
    torch.cuda.synchronize()
    return params, opt, hist, [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def layer_matrix(torch, tp, spec, eps, lam, inc=0., n_ref=1.):
    """A = P Q of one float32 raster layer at `inc` radians (azimuth 0) in
    a cladding of index n_ref, (n, n)."""
    from torcwa_tpu_torch.ops.fourier import material_conv
    freq = torch.tensor([1. / lam], dtype=torch.float32, device=eps.device)
    kx, ky = tp.kvectors_real(freq, inc, 0., n_ref, spec.order, spec.L,
                              torch.float32)
    P, Q = tp.pq_pair(material_conv(eps, spec.order), kx, ky)
    return (P @ Q)[0].contiguous()


def op_names_mode():
    """A dispatch mode class that collects the names of the operators run
    inside it (``names``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpNames(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    return OpNames


def example_phase(torch, tp, ek, smi, dev, name, out):
    """Phases 16 and 17: an optimisation example at its published
    configuration through maximize_adam and the eig kernels (the large
    route), EX_STEPS ADAM steps: finite FoMs and gradients, the FoM up,
    step 0 against the complex128 torch.linalg.eig oracle, the kernels by
    name in a profiled step and no library eig; at 10 degrees the gradient
    against the oracle's; s/iter beside the same loop through
    torch.linalg.eig (complex64), device time, idle share, peak memory;
    the large route's stages alone on the layer's matrix, kept for
    phase 18."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torcwa_tpu_torch.ops import (eig_qr as eq, schur_ms as sm,
                                      vec_blocked as vb)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    OpNames = op_names_mode()
    ex = load_example(name)
    label = name.split('_')[0]
    n = 2 * (2 * ex.ORDER[0] + 1) * (2 * ex.ORDER[1] + 1)
    kw = ex.loop_kwargs()
    args = kw.get('fom_args_schedule', lambda step: ())
    p0 = ex.initial_params(ex.GRID, dev)
    print(f'  {label}: order {ex.ORDER} (n = {n}), grid {ex.GRID}, float32, '
          f'{EX_STEPS} ADAM steps through maximize_adam')
    fom = ex.make_fom(ex.ORDER, ex.GRID, dev)
    stamps = [('start', time.perf_counter())]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # what earlier phases hold
    ek.reset_launch_counts()
    params, opt, hist, ms = adam_run(torch, tp, fom, p0, kw, EX_STEPS)
    launches = dict(ek.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    # one more step under the profiler, from the state the loop left: its
    # FoM is the FoM after step EX_STEPS.  Device activity only (the host
    # side's ~1e5 operator events of a step take longer to record and sum
    # than the step); the operators' names from a dispatch mode instead
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            OpNames() as ops:
        f_end = tp.optim.maximize_adam(fom, None, 1, state=(params, *opt),
                                       **kw)[2][0][0]
        torch.cuda.synchronize()
    stamps.append(('loop', time.perf_counter()))
    fom_o = ex.make_fom(ex.ORDER, ex.GRID, dev, torch.float64, 'torch')
    with torch.no_grad():
        f_o = float(fom_o(p0.double(), *args(0)))
    stamps.append(('oracle', time.perf_counter()))
    foms = [h[0] for h in hist]
    print(f'  FoM per step {foms}, after step {EX_STEPS} {f_end:.8g}; '
          f'gradient norms {[h[1] for h in hist]}')
    print(f'  step 0: kernels {foms[0]:.8g}, complex128 torch.linalg.eig '
          f'oracle {f_o:.8g}; launches {launches}')
    check(all(math.isfinite(x) for h in hist for x in h)
          and math.isfinite(f_end), f'{label}: every FoM and gradient finite')
    check(f_end > foms[0], f'{label}: FoM after step {EX_STEPS} '
          f'{f_end:.8g} above step 0\'s {foms[0]:.8g}')
    rel_o = abs(foms[0] - f_o) / abs(f_o)
    check(rel_o <= 1e-4, f'{label}: step 0 FoM vs complex128 oracle, '
          f'relative {rel_o:.2e} <= 1e-4')
    check(all(launches[k] > 0 for k in LARGE_ROUTE) and
          not any(v for k, v in launches.items() if k not in LARGE_ROUTE),
          f'{label}: the large route\'s kernels launched, no other')

    ka = prof.key_averages()
    kern = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    ms_k = sum(e.self_device_time_total for e in kern
               if '::ms_' in e.key) / 1e3
    vec_k = sum(e.self_device_time_total for e in kern
                if 'tri_vectors_block_kernel' in e.key) / 1e3
    library = sorted(k for k in ops.names if 'linalg_eig' in k)
    s_iter = statistics.median(ms[1:])
    print(f'  s/iter through the kernels {s_iter / 1e3:.6f} (CUDA events, '
          f'median of steps 2-{EX_STEPS}; steps {[round(x, 1) for x in ms]} '
          f'ms) [{smi}]')
    print(f'  profiled step: device kernels {busy:.1f} ms (idle '
          f'{1 - busy / s_iter:.3f} of the unprofiled step), the schur_ms '
          f'functions {ms_k:.1f} ms in {launches["schur_ms"] / EX_STEPS:.0f} '
          f'launches a step, tri_vectors_block_kernel {vec_k:.2f} ms in '
          f'{launches["tri_vectors_blocked"] / EX_STEPS:.0f}; peak memory '
          f'of the loop {peak:.3f} GB above what was held before it '
          f'[{smi}]')
    for e in sorted(kern, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        print(f'  {e.self_device_time_total / 1e3:10.3f} ms x{e.count:5d}  '
              f'{e.key[:100]}')
    check(ms_k > 0 and vec_k > 0, f'{label}: the profile shows schur_ms\'s '
          'and tri_vectors_blocked\'s kernels')
    check(not library, f'{label}: no library eig in the kernels\' run '
          f'({library})')

    fom_l = ex.make_fom(ex.ORDER, ex.GRID, dev, eig_backend='torch')
    _, _, hist_l, ms_l = adam_run(torch, tp, fom_l, p0, kw, EX_STEPS)
    s_lib = statistics.median(ms_l[1:])
    stamps.append(('library', time.perf_counter()))
    print(f'  s/iter through torch.linalg.eig (complex64) '
          f'{s_lib / 1e3:.6f} (steps {[round(x, 1) for x in ms_l]} ms; '
          f'step 0 FoM {hist_l[0][0]:.8g}) [{smi}]')

    # the gradient at 10 degrees against the oracle's (FoM and gradient at
    # a tilt: at normal incidence a symmetric cell's degenerate mode pairs
    # leave the eig's gradient ill posed in any precision)
    grads = []
    for dtype, backend in ((torch.float32, 'kernels'),
                           (torch.float64, 'torch')):
        f = ex.make_fom(ex.ORDER, ex.GRID, dev, dtype, backend,
                        inc_deg=WELL_POSED_DEG, azi_deg=EX_AZI_DEG[label])
        p = p0.to(dtype).requires_grad_(True)
        grads.append(torch.autograd.grad(f(p, *args(0)), p)[0])
    if label == 'example5':
        err = float((grads[0].double() - grads[1]).norm() / grads[1].norm())
        print(f'  10 deg: dFoM/dW kernels {grads[0].tolist()}, oracle '
              f'{grads[1].tolist()}: relative error {err:.2e}')
        check(err <= 1e-2, f'{label}: 10-degree gradient vs complex128 '
              f'oracle {err:.2e} <= 1e-2')
    else:
        cos = cosine(grads[0], grads[1])
        print(f'  10 deg: whole-density gradient cosine {cos:.6f}')
        check(cos >= 0.99, f'{label}: 10-degree density gradient cosine '
              f'{cos:.6f} >= 0.99')

    stamps.append(('tilt', time.perf_counter()))

    # the large route on the layer's matrix at step 0, stage by stage, one
    # run each (the loop above warmed every kernel)
    spec, eps_of = ex.make_layer(ex.ORDER, ex.GRID, dev)
    with torch.no_grad():
        A = layer_matrix(torch, tp, spec, eps_of(p0, *args(0)), ex.LAMB0)
    H, Q = hessenberg_blocked(A)
    cfg = dict(m=eq.large_shifts(n), defl_mult=eq.LARGE_DEFL_MULT)
    T, Z, st = sm.schur_ms(H, Q, return_stats=True, **cfg)
    t = {'eig_qr': once_ms(torch, lambda: eq.eig_qr(A)),
         'hessenberg_blocked': once_ms(torch, lambda: hessenberg_blocked(A)),
         'schur_ms': once_ms(torch, lambda: sm.schur_ms(H, Q, **cfg)),
         'tri_vectors_blocked': once_ms(torch,
                                        lambda: vb.tri_vectors_blocked(T)),
         'torch.linalg.eig': once_ms(torch, lambda: torch.linalg.eig(A))}
    b_ms = bound(4 * n * n * C64, st[5])
    b_vec = bound(2 * n * n * C64, n ** 3 / 6 * 8)
    print(f'  the large route at n = {n}: ' + ', '.join(
        f'{k} {v:.1f} ms' for k, v in t.items()) + f' (schur_ms stats (hi, '
        f'sweeps, aed, skipped) {tuple(int(x) for x in st[:4])}, bound '
        f'{b_ms[0]:.4f} ms by {b_ms[1]}; tri_vectors_blocked bound '
        f'{b_vec[0]:.4f} ms by {b_vec[1]}); eig_qr is '
        f'{t["eig_qr"] / s_iter:.3f} of a step [{smi}]')
    stamps.append(('route', time.perf_counter()))
    print('  seconds by part: ' + ', '.join(
        f'{k} {b - a:.1f}' for (_, a), (k, b) in zip(stamps, stamps[1:])))
    out[label] = dict(
        n=n, s_iter=s_iter, s_iter_library=s_lib, device_ms=busy,
        idle=1 - busy / s_iter, peak_gb=peak, route_ms=t,
        launches_per_step={k: launches[k] / EX_STEPS for k in LARGE},
        schur_ms_profile_ms=ms_k, schur_ms_bound=b_ms, vectors_bound=b_vec,
        route=dict(A=A, H=H, Q=Q, T=T, Z=Z, st=st, cfg=cfg))


def example_plain_checks(torch, exs):
    """Phase 18: on each example's step-0 matrix (phases 16-17), schur_ms
    and tri_vectors_blocked against their plain versions from the step's
    own H, Q and T at phase 6's tolerances, and the whole Schur form
    against complex128 LAPACK's eigenvalues, as phases 4 and 6 hold it."""
    from torcwa_tpu_torch.ops import schur_ms as sm, vec_blocked as vb
    for label, e in exs.items():
        r = e.pop('route')
        A, T, Z, st = r['A'], r['T'], r['Z'], r['st']
        t0 = time.perf_counter()
        w_ref = torch.linalg.eigvals(A.to(torch.complex128))
        rho = float(w_ref.abs().max())
        w = torch.diagonal(T).to(torch.complex128)
        d = max(nearest_err(w, w_ref), nearest_err(w_ref, w)) / rho
        res, orth, tri = schur_quality(torch, A, T, Z)
        print(f'  {label}, schur_ms at n = {e["n"]}: eigenvalues vs complex128 '
              f'{d:.2e} of the spectral radius; Schur residual {res:.2e}, '
              f'unitarity {orth:.2e}')
        check(st[0] == 0 and tri and d <= 1e-4 and res <= 1e-4 and
              orth <= 1e-4, f'{label}: schur_ms converged, eigenvalues <= '
              '1e-4, Schur residual and unitarity <= 1e-4')
        ms2, _, err_ms = two_sweeps_check(torch, sm, A, r['H'], r['Q'],
                                          r['cfg'], rho, label)
        err_vec, vec_plain, vec_res, vec_res_p = blocked_vectors_check(
            torch, vb, T, vb.tri_vectors_blocked(T), label)
        print(f'  {label}: {time.perf_counter() - t0:.1f} s')
        e['checks'] = {
            'schur_ms': dict(max_abs_err=err_ms, two_sweeps_ms=ms2[0],
                             two_sweeps_plain_ms=ms2[1],
                             eig_err_vs_complex128=d),
            'tri_vectors_blocked': dict(
                max_abs_err=err_vec, plain_ms=vec_plain,
                eigen_residual=vec_res, plain_eigen_residual=vec_res_p)}


def small_route_hold(torch, ek, A, label):
    """A new size of the small route (phases 19-21) against the plain
    versions, on a matrix of the path: hessenberg's reconstruction beside
    its plain version's (1e-5 ||A||_F; Q unitary within 1e-5); the whole
    schur_qr against complex128 eigenvalues (1e-4 of the spectral radius)
    with its Schur residual (1e-5); tri_vectors against its plain version
    on the same T (1e-4 relative on separated columns, the eigen-residual
    on par); and, from n = 8, schur_qr after QR_MODEL_BUDGET sweeps of a
    random batch of this n against the plain model of its schedule
    (qr_window_check).  Returns the errors."""
    from torcwa_tpu_torch.ops.eig_kernels import (hessenberg_plain,
                                                  tri_vectors_plain)
    A = A[None] if A.dim() == 2 else A
    n = A.shape[-1]
    t0 = time.perf_counter()
    afro = torch.linalg.matrix_norm(A)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    H, Q = ek.hessenberg(A)
    Hp, Qp = hessenberg_plain(A)
    drec = float(((Q @ H @ Q.mH - Qp @ Hp @ Qp.mH).abs().amax((-2, -1))
                  / afro).max())
    orth = float((Q.mH @ Q - eye).abs().max())
    T, Z, (hi, _, _) = ek.schur_qr(H, Q, return_stats=True)
    w = torch.diagonal(T, dim1=-2, dim2=-1)
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    ew = nearest_err(w.to(torch.complex128), w_ref) / float(w_ref.abs().max())
    rz = float((torch.linalg.matrix_norm(Z @ T @ Z.mH - A) / afro).max())
    Y, Yp = ek.tri_vectors(T), tri_vectors_plain(T)
    V, Vp = (Z @ X for X in (Y, Yp))
    V, Vp = (X / torch.linalg.vector_norm(X, dim=-2, keepdim=True)
             for X in (V, Vp))
    gap = (w[..., :, None] - w[..., None, :]).abs() + \
        torch.eye(n, device=w.device) * 1e30
    sep = gap.amin(-1) > 1e-3 * w.abs().amax(-1, keepdim=True)
    ev = float(((V - Vp).abs().amax(-2) * sep).max()) if n > 1 else 0.
    r_k, r_p = (float(((A @ X - X * w[..., None, :]).abs().amax((-2, -1))
                       / A.abs().amax((-2, -1))).max()) for X in (V, Vp))
    print(f'  {label}, small route at n = {n}: hessenberg reconstruction vs '
          f'plain {drec:.2e} ||A||_F, Q unitary {orth:.2e}; schur_qr '
          f'eigenvalues vs complex128 {ew:.2e}, residual {rz:.2e}; '
          f'tri_vectors vs plain {ev:.2e} on {int(sep.sum())} separated '
          f'columns, eigen-residual {r_k:.2e} (plain {r_p:.2e})')
    check(drec <= 1e-5 and orth <= 1e-5, f'{label}: hessenberg == plain '
          'within 1e-5 ||A||_F, Q unitary within 1e-5')
    check(bool((hi == 0).all()) and ew <= 1e-4 and rz <= 1e-5,
          f'{label}: schur_qr converged, eigenvalues within 1e-4, residual '
          '<= 1e-5')
    check(ev <= 1e-4 and r_k <= 10 * r_p + 1e-6, f'{label}: tri_vectors == '
          'plain within 1e-4 on separated columns, eigen-residual on par')
    out = dict(n=n, hessenberg=drec, schur_qr=ew, tri_vectors=ev)
    if n >= 8:
        out['schur_qr_model'] = qr_window_check(torch, ek, A.device, n, 2)
    print(f'  {label}: {time.perf_counter() - t0:.1f} s')
    return out


def large_route_hold(torch, A, label):
    """A new size of the large route (phases 20-21) against the plain
    versions, as phase 18 holds the examples' matrices: two schur_ms
    sweeps kernel and plain from the lane's own H, Q; tri_vectors_blocked
    on its own T; the whole Schur form against complex128 eigenvalues.
    Returns the errors."""
    from torcwa_tpu_torch.ops import (eig_qr as eq, schur_ms as sm,
                                      vec_blocked as vb)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    t0 = time.perf_counter()
    n = A.shape[-1]
    cfg = dict(m=eq.large_shifts(n), defl_mult=eq.LARGE_DEFL_MULT)
    H, Q = hessenberg_blocked(A)
    T, Z, st = sm.schur_ms(H, Q, return_stats=True, **cfg)
    w_ref = torch.linalg.eigvals(A.to(torch.complex128))
    rho = float(w_ref.abs().max())
    d = set_dist(torch.diagonal(T).to(torch.complex128), w_ref) / rho
    res, orth, tri = schur_quality(torch, A, T, Z)
    print(f'  {label}, schur_ms at n = {n}: eigenvalues vs complex128 '
          f'{d:.2e} of the spectral radius; Schur residual {res:.2e}, '
          f'unitarity {orth:.2e}')
    check(st[0] == 0 and tri and d <= 1e-4 and res <= 1e-4 and orth <= 1e-4,
          f'{label}: schur_ms converged, eigenvalues <= 1e-4, Schur residual '
          'and unitarity <= 1e-4')
    ms2, need2, err_ms = two_sweeps_check(torch, sm, A, H, Q, cfg, rho,
                                          label)
    err_vec, vec_plain, _, _ = blocked_vectors_check(
        torch, vb, T, vb.tri_vectors_blocked(T), label)
    # one run each, the kernels warm from the path: the whole Schur form,
    # the blocked vectors, the library's whole eig on the same matrix and
    # its eig of T (tri_vectors_blocked's library figure), beside the bounds
    # of phases 7 and 16-17
    t = {'schur_ms': once_ms(torch, lambda: sm.schur_ms(H, Q, **cfg)),
         'tri_vectors_blocked': once_ms(torch,
                                        lambda: vb.tri_vectors_blocked(T)),
         'torch.linalg.eig': once_ms(torch, lambda: torch.linalg.eig(A)),
         'torch.linalg.eig(T)': once_ms(torch, lambda: torch.linalg.eig(T))}
    b = {'schur_ms': bound(4 * n * n * C64, st[5]),
         'two_sweeps': bound(4 * n * n * C64, need2),
         'tri_vectors_blocked': bound(2 * n * n * C64, n ** 3 / 6 * 8)}
    print(f'  {label}: schur_ms {t["schur_ms"]:.1f} ms (bound '
          f'{b["schur_ms"][0]:.4f} by {b["schur_ms"][1]}; two sweeps '
          f'{ms2[0]:.1f}, plain {ms2[1]:.1f}, bound {b["two_sweeps"][0]:.4f}'
          f'), tri_vectors_blocked {t["tri_vectors_blocked"]:.2f} ms (bound '
          f'{b["tri_vectors_blocked"][0]:.4f} by '
          f'{b["tri_vectors_blocked"][1]}, plain {vec_plain:.1f}, '
          f'torch.linalg.eig(T) {t["torch.linalg.eig(T)"]:.1f}), '
          f'torch.linalg.eig {t["torch.linalg.eig"]:.1f} ms; '
          f'{time.perf_counter() - t0:.1f} s')
    return dict(n=n, schur_ms=err_ms, tri_vectors_blocked=err_vec,
                ms=t, bound_ms={k: v[0] for k, v in b.items()},
                schur_ms_two_sweeps_ms=ms2, vectors_plain_ms=vec_plain,
                eig_err_vs_complex128=d)


def lanes_hold(torch, ek, A, label):
    """The large route's Schur stage on a batch A (B, n, n) as the route
    calls it, its lanes in lock step, against each lane alone: every
    lane's T, Z and stats bit for bit, the AED rotations summed over the
    lanes, and LAUNCHES['schur_ms'] against the profiler's count of the
    schur_ms kernels.  Returns the record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torcwa_tpu_torch.ops import eig_qr as eq, schur_ms as sm
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    from torcwa_tpu_torch.utils import timing
    n, B = A.shape[-1], A.shape[0]
    cfg = dict(m=eq.large_shifts(n), defl_mult=eq.LARGE_DEFL_MULT)
    lanes = [hessenberg_blocked(a) for a in A]
    H = torch.stack([h for h, _ in lanes])
    Q = torch.stack([q for _, q in lanes])

    def traced(fn):
        with timing.tracing() as tr:
            got = fn()
            torch.cuda.synchronize()
            c, = [s.counters for s in tr.collect() if s.name == 'eig.schur']
        return got, {k: int(v) for k, v in c.items()}

    alone = [traced(lambda: sm.schur_ms(H[l], Q[l], return_stats=True,
                                        **cfg)) for l in range(B)]
    before = ek.LAUNCHES['schur_ms']
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (T, Z, st), c = traced(lambda: sm.schur_ms(H, Q, return_stats=True,
                                                   **cfg))
    launches = ek.LAUNCHES['schur_ms'] - before
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and '::ms_' in e.key)
    same = [bool(torch.equal(torch.view_as_real(T[l]),
                             torch.view_as_real(Tl))
                 and torch.equal(torch.view_as_real(Z[l]),
                                 torch.view_as_real(Zl))
                 and tuple(st[l]) == tuple(stl))
            for l, ((Tl, Zl, stl), _) in enumerate(alone)]
    rot = sum(cl['aed_rotations'] for _, cl in alone)
    print(f'  {label}, schur_ms on B = {B} in lock step at n = {n}: lanes '
          f'equal the lone calls bit for bit {same}, stats '
          f'{[tuple(int(x) for x in s) for s in st]}; AED rotations '
          f'{c["aed_rotations"]} (lone calls {rot}); sweeps {c["sweeps"]} '
          f'over {c["lockstep_sweeps"]} loop sweeps; {launches} launches '
          f'counted, {kernels} in the profile')
    check(all(same) and c['aed_rotations'] == rot
          and all(s[0] == 0 for s in st),
          f'{label}: lock-step lanes == lone calls bit for bit (T, Z, '
          'stats, AED rotations), converged')
    check(launches == kernels, f'{label}: LAUNCHES counts the schur_ms '
          'kernels the profiler sees')
    return dict(n=n, lanes=B, bits_equal=same,
                aed_rotations=c['aed_rotations'], aed_rotations_alone=rot,
                sweeps=c['sweeps'], lockstep_sweeps=c['lockstep_sweeps'],
                launches=launches, profiled_kernels=kernels)


def launched(torch, ek, label, kernels, out):
    """Read the launch counts after a path; check that the route's
    kernels ran and no other eig kernel did; keep them under `label`."""
    torch.cuda.synchronize()
    got = {k: v for k, v in ek.LAUNCHES.items() if v}
    print(f'  launches, {label}: {got}')
    check(all(got.get(k) for k in kernels) and set(got) <= set(kernels),
          f'{label}: {", ".join(kernels)} launched, no other eig kernel')
    out.setdefault('launches', {})[label] = got
    return got


def class_examples_phase(torch, tp, ek, smi, dev, out):
    """Phase 19: Examples 0, 2 and 4 (examples/torch/) through the class
    API on the card."""
    t0 = time.perf_counter()
    ex0 = load_example('example0_fresnel')
    worst = 0.
    for ang in range(0, 90, 10):
        got, want = ex0.rcwa_reflection(ang, dev), ex0.fresnel(ang)
        worst = max(worst, *(abs(a - b) / max(2e-3, 0.01 * b)
                             for a, b in zip(got, want)))
    print(f'  example0: R_TM, R_TE at 0-80 deg, the largest error '
          f'{worst:.3f} of the tolerance max(2e-3, 1%)')
    check(worst < 1, 'example0: R_TM and R_TE match Fresnel within '
          'max(2e-3, 1%), 0-80 deg')

    ex2 = load_example('example2_fields')
    n2 = 2 * (2 * ex2.ORDER[0] + 1) * (2 * ex2.ORDER[1] + 1)
    ek.reset_launch_counts()
    sim = ex2.simulate(ex2.ORDER, dev)
    maps = ex2.field_maps(sim)
    launched(torch, ek, f'example2 (n = {n2})', SMALL, out)
    ang = ex2.diffraction_angles(sim)
    sim_o = ex2.simulate(ex2.ORDER, dev, torch.complex128, 'torch')
    maps_o = ex2.field_maps(sim_o)
    ang_o = ex2.diffraction_angles(sim_o)
    errs = [float((a.double() - b).abs().max() / b.abs().max())
            for a, b in zip(maps, maps_o)]
    dang = max(float(np.abs(a - b).max()) for a, b in zip(ang, ang_o))
    print(f'  example2: order {ex2.ORDER}, |E|^2 on the xz plane and the xy '
          f'cut vs the complex128 torch.linalg.eig class: {errs[0]:.2e}, '
          f'{errs[1]:.2e} of max|E|^2 (max {float(maps[0].max()):.4f}, '
          f'{float(maps[1].max()):.4f}); diffraction angles within '
          f'{dang:.1e} deg')
    check(max(errs) <= 1e-4, 'example2: |E|^2 on both planes within 1e-4 '
          'of max|E|^2 of the complex128 oracle')
    try:
        ex2.check_envelope(*maps)
        envelope = True
    except AssertionError as e:
        envelope = str(e)
    check(envelope is True, f'example2: the twin\'s envelope ({envelope})')
    g = tp.geometry(Lx=ex2.L[0], Ly=ex2.L[1], nx=ex2.GRID, ny=ex2.GRID,
                    edge_sharpness=1000., device=dev)
    sq = g.square(W=300., Cx=ex2.L[0] / 2., Cy=ex2.L[1] / 2.)
    spec = tp.StackSpec(order=ex2.ORDER, L=tuple(ex2.L), n_layers=1)
    A2 = layer_matrix(torch, tp, spec, sq * 3.5 ** 2 + (1. - sq), 600.,
                      math.radians(20.), 1.46)
    del sim, sim_o, maps_o
    t1 = time.perf_counter()

    ex4 = load_example('example4_gradient_check')
    n4 = 2 * (2 * ex4.ORDER[0] + 1) * (2 * ex4.ORDER[1] + 1)
    ek.reset_launch_counts()
    rows = ex4.gradient_rows(ex4.ORDER, dev)
    launched(torch, ek, f'example4 float32 (n = {n4})', SMALL, out)
    fd_ok = all(np.isclose(r[4], r[2], rtol=5e-2, atol=2e-5) for r in rows)
    f32_ok = all(np.isclose(r[6], r[4], rtol=5e-2, atol=2e-5) for r in rows)
    for R, T, fd, exact, broad, T32, broad32 in rows:
        print(f'  example4 R = {R}: T {T:.6f} (float32 kernels {T32:.6f}); '
              f'dT/dR fd {fd:.4e}, exact {exact:.4e}, broadened {broad:.4e}, '
              f'float32 kernels {broad32:.4e}')
    check(fd_ok, 'example4: float64 broadened dT/dR within rtol 5e-2, atol '
          '2e-5 of the finite difference')
    check(f32_ok, 'example4: float32 dT/dR through the kernels within rtol '
          '5e-2, atol 2e-5 of the float64 value')
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'tests', 'golden', 'example4.npz'))
    got = [ex4.dT_dR(float(R), True, 1e-10, device=dev, grid=400)[1]
           for R in gold['R']]
    rel = float(np.max(np.abs(np.array(got) - gold['dTdR_broad'])
                       / np.abs(gold['dTdR_broad'])))
    print(f'  example4 at the golden\'s R {gold["R"].tolist()} (grid 400): '
          f'broadened dT/dR {got}, golden {gold["dTdR_broad"].tolist()}, '
          f'relative {rel:.2e}')
    check(rel <= 1e-3, 'example4: broadened dT/dR within 1e-3 of '
          'tests/golden/example4.npz')
    g4 = tp.geometry(Lx=ex4.L[0], Ly=ex4.L[1], nx=ex4.GRID, ny=ex4.GRID,
                     edge_sharpness=500., device=dev)
    cyl = g4.circle(90., ex4.L[0] / 2., ex4.L[1] / 2.)
    A4 = layer_matrix(torch, tp, tp.StackSpec(ex4.ORDER, tuple(ex4.L), 1),
                      cyl * 2.0709 ** 2 + (1. - cyl), 473.)
    t2 = time.perf_counter()
    out['holds'] = [small_route_hold(torch, ek, A2, f'example2 n = {n2}'),
                    small_route_hold(torch, ek, A4, f'example4 n = {n4}')]
    print(f'  seconds: example 0 and 2 {t1 - t0:.1f}, example 4 '
          f'{t2 - t1:.1f}, holds {time.perf_counter() - t2:.1f} [{smi}]')


def sweep_phase(torch, tp, ek, smi, dev, out):
    """Phase 20: Example 1 (examples/torch/example1_wavelength_sweep.py),
    one raster a wavelength: order 4 at 31 wavelengths (the small route,
    B = 31) and order 15 at 3 (n = 1922, the large route), each against
    the complex128 oracle; shard_sweep and sweep_and_grad at order 4 on a
    mesh of the card and of the card twice; the large route's kernels
    against their plain versions at n = 1922, and its Schur stage on two
    wavelengths in lock step against each alone."""
    from torcwa_tpu_torch.parallel import (shard_sweep, sweep_and_grad,
                                           sweep_mesh)
    ex1 = load_example('example1_wavelength_sweep')
    t0 = time.perf_counter()
    geom = ex1.build_geom(ex1.GRID, dev)
    geom64 = geom.double()
    lams = np.linspace(400., 700., 31)
    freqs = torch.as_tensor(1. / lams, dtype=torch.float32, device=dev)
    o4 = (4, 4)
    ex1.t00(freqs, geom, o4)                  # first launches at B = 31
    ek.reset_launch_counts()
    T4 = ex1.t00(freqs, geom, o4)
    launched(torch, ek, 'example1 order 4, B = 31 (n = 162)', SMALL, out)
    T4o = ex1.t00(freqs.double(), geom64, o4, 'torch')
    d4 = float((T4.double() - T4o).abs().max())
    ms4 = once_ms(torch, lambda: ex1.t00(freqs, geom, o4))
    ms4l = once_ms(torch, lambda: ex1.t00(freqs, geom, o4, 'torch'))
    print(f'  example1 order 4, 31 wavelengths: |t_xx|^2 vs complex128 '
          f'oracle {d4:.2e}; {ms4 / 31e3:.6f} s/solve through the kernels, '
          f'{ms4l / 31e3:.6f} through torch.linalg.eig complex64 (one '
          f'batch, CUDA events) [{smi}]')
    check(d4 <= 1e-4, f'example1 order 4: |t_xx|^2 vs oracle {d4:.2e} <= '
          '1e-4')

    # the sweep primitives: five wavelengths, the raster scale as theta
    xs = freqs[::7][:5].contiguous()
    fn = lambda f: ex1.t00(f, geom, o4)
    loss = lambda f, s: ex1.t00(f, geom * s, o4)
    s0 = torch.tensor(1., device=dev)
    direct = fn(xs)
    s = s0.clone().requires_grad_(True)
    mean_d = loss(xs, s).mean()
    grad_d = torch.autograd.grad(mean_d, s)[0]
    mean_d = mean_d.detach()
    for mesh in (sweep_mesh(), sweep_mesh([dev] * 2)):
        got = shard_sweep(fn, mesh)(xs)
        m, gr = sweep_and_grad(loss, mesh)(xs, s0)
        e = (float((got - direct).abs().max()),
             abs(float(m) - float(mean_d)) / abs(float(mean_d)),
             abs(float(gr) - float(grad_d)) / abs(float(grad_d)))
        print(f'  mesh of {len(mesh.devices)}: shard_sweep vs direct '
              f'{e[0]:.2e}; sweep_and_grad mean {float(m):.8f} vs '
              f'{float(mean_d):.8f} ({e[1]:.2e}), d/ds {float(gr):.6e} vs '
              f'{float(grad_d):.6e} ({e[2]:.2e})')
        check(max(e) <= 1e-6, f'shard_sweep and sweep_and_grad on a mesh of '
              f'{len(mesh.devices)} equal the direct batched call (1e-6)')
    t1 = time.perf_counter()

    o15 = (15, 15)
    n15 = 2 * 31 ** 2
    geom300 = ex1.build_geom(300, dev)
    f3 = torch.as_tensor(1. / np.array([400., 550., 700.]),
                         dtype=torch.float32, device=dev)
    ek.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    T15 = ex1.t00(f3, geom300, o15)
    ev[1].record()
    launched(torch, ek, f'example1 order 15, B = 3 (n = {n15})', LARGE_ROUTE,
             out)
    ms15 = ev[0].elapsed_time(ev[1])
    ms15l = once_ms(torch, lambda: ex1.t00(f3, geom300, o15, 'torch'))
    T15o = ex1.t00(f3.double(), geom300.double(), o15, 'torch')
    d15 = float((T15.double() - T15o).abs().max())
    print(f'  example1 order 15 (n = {n15}) at 400, 550, 700 nm: |t_xx|^2 '
          f'{T15.tolist()}, oracle {T15o.tolist()}: {d15:.2e}; '
          f'{ms15 / 3e3:.6f} s/solve through the kernels, {ms15l / 3e3:.6f} '
          f'through torch.linalg.eig complex64 (one batch of 3) [{smi}]')
    check(d15 <= 1e-4, f'example1 order 15: |t_xx|^2 vs oracle {d15:.2e} '
          '<= 1e-4')
    t2 = time.perf_counter()
    spec = tp.StackSpec(order=o15, L=ex1.L, n_layers=1)
    with torch.no_grad():
        eps550 = geom300 * ex1.a_si(str(dev)).eps(550.).to(torch.complex64) \
            + (1. - geom300)
        A = layer_matrix(torch, tp, spec, eps550, 550.)
    hold = large_route_hold(torch, A, f'example1 n = {n15}')
    with torch.no_grad():
        A2 = torch.stack([layer_matrix(
            torch, tp, spec, geom300 * ex1.a_si(str(dev)).eps(lam).to(
                torch.complex64) + (1. - geom300), lam)
            for lam in (400., 700.)])
    out['lanes'] = lanes_hold(torch, ek, A2, f'example1 n = {n15}')
    A4 = layer_matrix(torch, tp, tp.StackSpec(o4, ex1.L, 1),
                      geom * ex1.a_si(str(dev)).eps(550.)
                      .to(torch.complex64) + (1. - geom), 550.)
    out['holds'] = [small_route_hold(torch, ek, A4, 'example1 n = 162'),
                    hold]
    out['s_solve'] = dict(order4=(ms4 / 31e3, ms4l / 31e3),
                          order15=(ms15 / 3e3, ms15l / 3e3))
    print(f'  seconds: order 4 and the sweep primitives {t1 - t0:.1f}, order '
          f'15 {t2 - t1:.1f}, holds {time.perf_counter() - t2:.1f} [{smi}]')


def multilayer_and_grid_phase(torch, tp, ek, smi, dev, out):
    """Phase 21: Example 1-1 (three patterned layers a solve) at orders 0,
    3, 6, 9 and 12, and Example 3 at order 20 at two points of the 11 x 11
    grid, its stages timed with utils.StageTimer."""
    from torcwa_tpu_torch.utils import StageTimer
    t0 = time.perf_counter()
    ex11 = load_example('example1_1_multilayer')
    mats = {}
    for order_n in (0, 3, 6, 9, 12):
        n = 2 * (2 * order_n + 1) ** 2
        ek.reset_launch_counts()
        t = ex11.t_elements(order_n, dev)
        launched(torch, ek, f'example1_1 order {order_n} (n = {n})',
                 LARGE_ROUTE if n >= 512 else SMALL, out)
        tot = sum(ex11.circular(*t))
        print(f'  example1_1 order {order_n}: TRR + TLR + TRL + TLL '
              f'{tot:.6f}')
        check(tot <= 1 + 1e-4, f'example1_1 order {order_n}: TRR + TLR + '
              f'TRL + TLL {tot:.6f} <= 1 + 1e-4')
        if order_n in (0, 3):
            spec = tp.StackSpec(order=(order_n,) * 2, L=ex11.L, n_layers=1)
            mats[n] = layer_matrix(torch, tp, spec, ex11.layers(dev)[1],
                                   ex11.LAMB0)
    t_o = ex11.t_elements(12, dev, torch.float64, 'torch')
    d = max(abs(a - b) for a, b in zip(t, t_o))
    print(f'  example1_1 order 12: (txx, tyx, txy, tyy) vs the complex128 '
          f'oracle {d:.2e}')
    check(d <= 1e-4, f'example1_1 order 12: each t within 1e-4 of the '
          f'complex128 oracle ({d:.2e})')
    t1 = time.perf_counter()

    ex3 = load_example('example3_parameter_sweep')
    _, pts = ex3.grid_points(ex3.NW)
    ek.reset_launch_counts()
    ex3.sweep(pts, device=dev)                        # its default, order 4
    launched(torch, ek, f'example3 order {ex3.ORDER[0]}, B = {len(pts)} '
             f'(n = 162)', SMALL, out)
    o20 = (20, 20)
    n20 = 2 * 41 ** 2
    _, pts = ex3.grid_points(11)
    pts = pts[[0, 60]]                     # (50, 50) and (150, 150) nm
    stages, whole = StageTimer(), StageTimer()
    ek.reset_launch_counts()
    with timed_eig_stages(torch, stages, whole):
        t3 = ex3.t00_of_wxwy(pts[:, 0], pts[:, 1], o20, device=dev)
    launched(torch, ek, f'example3 order 20, B = 2 (n = {n20})', LARGE_ROUTE,
             out)
    t3o = ex3.t00_of_wxwy(pts[1:, 0], pts[1:, 1], o20, device=dev,
                          dtype=torch.float64, eig_backend='torch')
    d3 = float((t3[1:].abs() ** 2 - t3o.abs() ** 2).abs().max())
    print(f'  example3 order 20 at (Wx, Wy) {pts.tolist()}: |t|^2 '
          f'{(t3.abs() ** 2).tolist()}; at {pts[1].tolist()} vs the '
          f'complex128 oracle {d3:.2e}')
    print(f'  its eig forward {whole.totals["eig"]:.3f} s, its stages '
          f'(StageTimer, two lanes):\n    ' +
          stages.report().replace('\n', '\n    '))
    check(d3 <= 1e-4, f'example3 order 20: |t|^2 vs oracle {d3:.2e} <= 1e-4')
    t2 = time.perf_counter()
    # the large route's new sizes here, n = 722 and 1250, are held by
    # qr_compare.py --stage gates: their plain versions take ~16 s
    out['holds'] = [small_route_hold(torch, ek, mats[n], f'example1_1 n = {n}')
                    for n in (2, 98)]
    print(f'  seconds: example 1-1 {t1 - t0:.1f}, example 3 {t2 - t1:.1f}, '
          f'holds {time.perf_counter() - t2:.1f} [{smi}]')


def hess_panel_phase(torch, ek, smi, dev):
    """Phase 22: hessenberg_blocked through the panel kernel against the
    plain column loop on the same random A at the large route's main sizes:
    Q H Q^H = A and Q unitary at float32 level, each within 2x of the plain
    loop's own figure (in complex128 arithmetic); the stage's time both
    ways (CUDA events), hess_panel's device time (torch.profiler) and
    launches, beside the stage's bound.  Returns the record."""
    from torch.profiler import ProfilerActivity, profile
    from torcwa_tpu_torch.ops import hess_blocked as hb
    out = {}
    for n in (882, 1922):
        A = rand_c64(torch, n, 22000 + n, dev)
        A64 = A.to(torch.complex128)
        eye = torch.eye(n, dtype=torch.complex128, device=dev)

        def quality(H, Q):
            H, Q = H.to(torch.complex128), Q.to(torch.complex128)
            return (float(torch.linalg.matrix_norm(Q @ H @ Q.mH - A64)
                          / torch.linalg.matrix_norm(A64)),
                    float((Q.mH @ Q - eye).abs().max()))

        ek.reset_launch_counts()
        rec, orth = quality(*hb.hessenberg_blocked(A))
        launches = ek.LAUNCHES['hess_panel']
        ms = cuda_ms(torch, lambda: hb.hessenberg_blocked(A), reps=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            hb.hessenberg_blocked(A)
            torch.cuda.synchronize()
        kern = sum(e.self_device_time_total for e in prof.key_averages()
                   if 'hess_panel_kernel' in e.key) / 1e3
        keep = hb.hess_panel
        hb.hess_panel = hb._columns
        try:
            rec_p, orth_p = quality(*hb.hessenberg_blocked(A))
            ms_p = once_ms(torch, lambda: hb.hessenberg_blocked(A))
        finally:
            hb.hess_panel = keep
        b = bound(3 * n * n * C64, 7 / 3 * n ** 3 * 8)
        grid = hb.hess_panel_info(n, 128)
        print(f'  n = {n}: hessenberg_blocked {ms:.2f} ms through hess_panel '
              f'({launches} launches, {kern:.2f} ms of hess_panel_kernel; '
              f'grid {grid}), {ms_p:.1f} ms through the plain column loop; '
              f'bound {b[0]:.4f} ms by {b[1]}; Q H Q^H - A {rec:.2e} ||A||_F '
              f'(plain {rec_p:.2e}), Q^H Q - I {orth:.2e} (plain '
              f'{orth_p:.2e}) [{smi}]')
        check(launches == len(range(0, n - 2, 128)),
              f'hess_panel n={n}: one launch a panel')
        check(rec <= 2 * rec_p and orth <= max(2 * orth_p, 1e-6),
              f'hess_panel n={n}: reconstruction and unitarity within 2x of '
              'the plain column loop\'s')
        out[n] = dict(ms=ms, kernel_ms=kern, plain_ms=ms_p, bound_ms=b[0],
                      bound_by=b[1], launches=launches, reconstruction=rec,
                      plain_reconstruction=rec_p, unitarity=orth)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    from torcwa_tpu_torch._constants import f32_pinned
    # the script's own products (the plain versions, the checks) in IEEE
    # f32 too; each entry point pins and restores on its own
    with f32_pinned():
        return run(torch)


def run(torch):
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch._constants import f32_precision_pinned
    from torcwa_tpu_torch.ops import (_build, eig_kernels as ek,
                                      eig_qr as eq, schur_ms as sm,
                                      vec_blocked as vb)
    from torcwa_tpu_torch.ops.eig_kernels import (hessenberg_plain,
                                                  tri_vectors_plain)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
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

    phase('3. small-route kernels against their plain versions')
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
    T1, _, (hi1, _, _) = ek.schur_qr(H, Q, max_iter_factor=1,
                                     return_stats=True)
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
    qr_model_err = qr_window_check(torch, ek, dev)

    phase('4. large-route kernels against their plain versions')
    large_kernel_checks(torch, ek, dev)

    phase('5. the order-6 slice (8 wavelengths, grid 256, float32)')
    eps32, _ = wave_matrices(torch, tp, (6, 6), LAMS[:1], 0., torch.float32,
                             dev)
    eps64 = eps32.double()
    ek.reset_launch_counts()
    T_k, g_k = fwd_grad(torch, tp, eps32, LAMS, (6, 6), 0., 'kernels')
    torch.cuda.synchronize()
    launches = dict(ek.LAUNCHES)
    print(f'  launches on the order-6 path: {launches}')
    for k in SMALL:
        check(launches[k] > 0, f'{k} kernel launched on the order-6 path '
              f'({launches[k]})')
    T_o, _ = fwd_grad(torch, tp, eps64, LAMS, (6, 6), 0., 'torch')
    dT = float((T_k.double() - T_o).abs().max())
    print(f'  |t_xx|^2 kernels {T_k.tolist()}')
    print(f'  |t_xx|^2 oracle  {T_o.tolist()}')
    check(dT <= 1e-4, f'|t_xx|^2 vs complex128 oracle: {dT:.2e} <= 1e-4')
    check(bool(torch.isfinite(g_k).all()), 'raster gradient finite')
    for tilt_deg in (0.2, WELL_POSED_DEG):
        grad_checks(torch, tp, eps32, LAMS, (6, 6), tilt_deg)
    grad_checks(torch, tp, eps32, LAMS[3:4], (10, 10), WELL_POSED_DEG)
    check(f32_precision_pinned(), 'the script\'s IEEE f32 setting '
          'holds after the slice')

    phase('6. the order-20 slice (2N = 3362, one wavelength, grid 256, '
          'float32, 10 deg)')
    o20 = {}
    order20_slice(torch, tp, ek, dev, o20)
    launches.update({k: o20['launches'][k] for k in LARGE})
    check(f32_precision_pinned(), 'the script\'s IEEE f32 setting '
          'holds after order 20')

    phase('7. times (CUDA events, median after one warm-up)')
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
    B6, n6 = A6c.shape[0], A6c.shape[-1]
    lib6 = cuda_ms(torch, lambda: torch.linalg.eig(A6c), reps=3)
    times, bounds = {}, {}
    times['hessenberg'] = (cuda_ms(torch, lambda: ek.hessenberg(A6c)),
                           cuda_ms(torch, lambda: hessenberg_plain(A6c)),
                           'B=8 n=338')
    # A read, H and Q written; zgehrd + zunghr: (5/3 + 2/3) n^3 complex
    # multiply-adds of 8 flops
    def hess_bound(B, n):
        return bound(3 * B * n * n * C64, B * (7 / 3) * n ** 3 * 8)

    bounds['hessenberg'] = hess_bound(B6, n6)
    # the order-7 batch at 10 deg (n = 450), with the path each size takes
    _, A7 = wave_matrices(torch, tp, (7, 7), LAMS,
                          math.radians(WELL_POSED_DEG), torch.float32, dev)
    A7 = A7.contiguous()
    n7 = A7.shape[-1]
    hess = {'n450_ms': cuda_ms(torch, lambda: ek.hessenberg(A7)),
            'n450_bound_ms': hess_bound(B6, n7)[0]}
    for nh in (n6, n7):
        info = ek.hessenberg_cluster_info(nh)
        hess[f'n{nh}_cluster'] = info and info['cluster']
        hess[f'n{nh}_active_clusters'] = info and info['active_clusters']
    print(f'  hessenberg B=8: n = {n6} {times["hessenberg"][0]:.3f} ms on '
          f'{hessenberg_path(ek, n6)}; n = {n7} {hess["n450_ms"]:.3f} ms on '
          f'{hessenberg_path(ek, n7)} (bound {hess["n450_bound_ms"]:.4f} '
          f'ms) [{smi}]')
    times['schur_qr'] = (cuda_ms(torch, lambda: ek.schur_qr(H6, Q6)),
                         rec_main['qr_plain_ms'],
                         'B=8 n=338; plain: one run, in phase 3')
    print(f'  schur_qr {times["schur_qr"][0]:.3f} ms; the per-rotation kernel '
          f'it replaced {QR_MS_PER_ROTATION["schur_qr"]} ms (PERF.md) [{smi}]')
    # H, Q read, T, Z written; this run's sweeps per lane, a sweep chasing
    # a window that shrinks from n to 0 (n/2 rotations on average), a
    # rotation updating ~2n element pairs (rows of H, columns of H and Z)
    # of 20 flops
    bounds['schur_qr'] = bound(4 * B6 * n6 * n6 * C64,
                               sum(rec_main['sweeps']) * (n6 / 2) * 2 * n6
                               * 20)
    times['tri_vectors'] = (cuda_ms(torch, lambda: ek.tri_vectors(T6)),
                            cuda_ms(torch, lambda: tri_vectors_plain(T6)),
                            'B=8 n=338')
    # one PyTorch call for the function of each triangular-vectors kernel:
    # torch.linalg.eig of the triangular factor gives the same eigenvectors
    # up to column scaling (timed here, never on the path)
    library = {'tri_vectors': cuda_ms(torch, lambda: torch.linalg.eig(T6),
                                      reps=3)}
    # T read, Y written; n^3/6 complex multiply-adds
    bounds['tri_vectors'] = bound(2 * B6 * n6 * n6 * C64,
                                  B6 * n6 ** 3 / 6 * 8)

    nL, cfgL = o20['n'], o20['cfg']
    A20, H20, Q20, T20 = o20['A'], o20['H'], o20['Q'], o20['T']
    inc = math.radians(WELL_POSED_DEG)
    ms_20f, ms_20b = fwd_bwd_ms(torch, tp, o20['eps'], LAM_L, ORDER_L, inc,
                                'kernels')
    ms_20 = ms_20f + ms_20b
    ms_eig = cuda_ms(torch, lambda: eq.eig_qr(A20), reps=1)
    ms_hess = cuda_ms(torch, lambda: hessenberg_blocked(A20), reps=1)
    ms_ms = cuda_ms(torch, lambda: sm.schur_ms(H20, Q20, **cfgL), reps=3)
    ms_vecs = cuda_ms(torch, lambda: vb.tri_vectors_blocked(T20), reps=3)
    wv = torch.diagonal(T20)[None]
    Vv = (o20['Z'] @ vb.tri_vectors_blocked(T20))[None]
    Vv = Vv / torch.linalg.vector_norm(Vv, dim=-2, keepdim=True)
    ms_ref = cuda_ms(torch, lambda: eq._refine(A20[None], wv, Vv,
                                               eq.REFINE[1]), reps=3)
    lib20 = cuda_ms(torch, lambda: torch.linalg.eig(A20), reps=1)
    library['tri_vectors_blocked'] = cuda_ms(
        torch, lambda: torch.linalg.eig(T20), reps=1)
    print(f'  library figure per stage: torch.linalg.eig of the triangular '
          f'factor, B = 8, n = {n6}: {library["tri_vectors"]:.1f} ms; n = '
          f'{T20.shape[-1]}: {library["tri_vectors_blocked"]:.1f} ms [{smi}]')
    ms_20l = cuda_ms(torch, lambda: fwd_grad(torch, tp, o20['eps'], LAM_L,
                                             ORDER_L, inc, 'torch'), reps=1)
    print(f'  order-20 fwd+grad, eig kernels: {ms_20 / 1e3:.6f} s/solve '
          f'(medians of 3 after the check run: forward {ms_20f / 1e3:.6f} '
          f's, backward {ms_20b / 1e3:.6f} s; eig_qr alone, one run, '
          f'{ms_eig / 1e3:.6f} s, which leaves '
          f'{(ms_20f - ms_eig) / 1e3:.6f} s for conv + tail + Redheffer, a '
          f'difference of two host-paced medians) [{smi}]')
    print(f'  order-20 eig stages at n = {nL}: hessenberg_blocked '
          f'{ms_hess:.1f} ms, schur_ms {ms_ms:.1f} ms, tri_vectors_blocked '
          f'(27 kernels + 27 GEMMs) {ms_vecs:.1f} ms, one refinement step '
          f'{ms_ref:.1f} ms [{smi}]')
    print(f'  order-20 library figure: torch.linalg.eig complex64 on the '
          f'same matrix {lib20:.1f} ms (covers all three stages); fwd+grad '
          f'with it {ms_20l / 1e3:.6f} s/solve; order-6: torch.linalg.eig '
          f'complex64 on the (8, 338, 338) batch {lib6:.1f} ms (covers all '
          f'three stages) [{smi}]')
    print(f'  order-20 fwd+grad peak memory {o20["peak_gb"]:.3f} GB [{smi}]')
    # the record holds one piece of work throughout: the first two sweeps
    # from the same H, Q (phase 6), which the plain version can be timed
    # on; the whole Schur form stands beside it.  H and Z read and written;
    # the operations are schur_ms's flops needed: this run's rotations
    # applied directly and its AED transforms, whatever the windowing
    times['schur_ms'] = (o20['ms2'][0], o20['ms2'][1],
                         f'n={nL}, the first two sweeps')
    bounds['schur_ms'] = bound(4 * nL * nL * C64, o20['need2'])
    full_bound = bound(4 * nL * nL * C64, o20['need'])
    print(f'  schur_ms, the whole Schur form at n = {nL}: kernel {ms_ms:.3f} '
          f'ms, bound {full_bound[0]:.4f} ms by {full_bound[1]} '
          f'({o20["need"]:.3e} flops needed), plain not run [{smi}]')
    print(f'  schur_ms before this redesign, not measured here (PR 5\'s final '
          f'run, PERF.md): the whole Schur form {MS_MS_PR5[1]} ms, the first '
          f'two sweeps {MS_MS_PR5[0]} ms')
    split = schur_ms_split(torch, sm, H20, Q20, cfgL)
    print(f'  schur_ms split at n = {nL} (torch.profiler, device time by '
          f'kernel over one call): ' + '; '.join(
              f'{k} {v[0]:.1f} ms in {v[1]} launches ({v[0] / v[1]:.4f} ms '
              f'each)' for k, v in split.items() if v[1]) + f' [{smi}]')
    # the in-block kernel alone over all row blocks, S precomputed
    dmin = vb.pivot_floor(T20)
    blocks = [(max(r1 - vb.MAX_BLOCK, 0), r1)
              for r1 in range(nL, 0, -vb.MAX_BLOCK)]
    Yv = vb.tri_vectors_blocked(T20)
    Ss = [(T20[r0:r1, r1:] @ Yv[r1:]).contiguous() for r0, r1 in blocks]

    def all_blocks(fn):
        Y = torch.eye(nL, dtype=T20.dtype, device=dev)
        for (r0, r1), S in zip(blocks, Ss):
            fn(T20, S, dmin, Y, r0, r1)

    times['tri_vectors_blocked'] = (
        cuda_ms(torch, lambda: all_blocks(vb.tri_vectors_block), reps=3),
        cuda_ms(torch, lambda: all_blocks(vb.tri_vectors_block_plain),
                reps=1), f'n={nL}, the {len(blocks)} in-block launches')
    # per block: the p x p triangle of T and S read, the rows of Y right
    # of the diagonal written; p^2/2 multiply-adds per column
    vb_bytes = sum(((r1 - r0) ** 2 + (r1 - r0) * nL + (r1 - r0) * (nL - r0))
                   * C64 for r0, r1 in blocks)
    vb_flops = sum((r1 - r0) ** 2 / 2 * (nL - r0) * 8 for r0, r1 in blocks)
    bounds['tri_vectors_blocked'] = bound(vb_bytes, vb_flops)
    for k, (tk, tpl, shape) in times.items():
        print(f'  {k}: kernel {tk:.3f} ms, plain {tpl:.3f} ms, bound '
              f'{bounds[k][0]:.4f} ms by {bounds[k][1]} ({shape}) [{smi}]')

    print('  the two routes of eig_qr on one wave matrix (500 nm, 10 deg), '
          'one run after a warm-up:')
    keep = eq.LARGE_MIN_N
    for order in (6, 7, 8, 10):
        _, Ao = wave_matrices(torch, tp, (order, order), LAM_L, inc,
                              torch.float32, dev)
        Ao = Ao.contiguous()
        eq.LARGE_MIN_N = 10 ** 9
        t_small = cuda_ms(torch, lambda: eq.eig_qr(Ao), reps=1)
        eq.LARGE_MIN_N = 0
        t_large = cuda_ms(torch, lambda: eq.eig_qr(Ao), reps=1)
        eq.LARGE_MIN_N = keep
        print(f'    n = {Ao.shape[-1]}: small route {t_small:.1f} ms, large '
              f'route {t_large:.1f} ms [{smi}]')

    phase('8. profiles (torch.profiler)')
    profile_sweep(torch, tp, eps32)
    profile_order20(torch, tp, o20['eps'])

    phase('9. the stand-alone Schur stages against their plain versions')
    alt = {}
    alt_kernel_checks(torch, ek, dev, A_rand, alt)

    phase('10. the composed eig through the stand-alone stages (orders 6 to '
          '8) and one order-7 solve through schur_qr_ms')
    alt_path(torch, tp, ek, dev, A6c, H6, Q6, eps32, alt)
    launches.update(alt['launches'])
    check(f32_precision_pinned(), 'the script\'s IEEE f32 setting holds '
          'after the stand-alone stages')

    phase('11. times of the stand-alone stages (CUDA events, median of 3)')
    print(f'card: {smi}')
    alt_times(torch, ek, smi, H6, Q6, alt, times, bounds)
    for k in ALT:
        tk, tpl, shape = times[k]
        print(f'  {k}: kernel {tk:.3f} ms, plain {tpl:.3f} ms, bound '
              f'{bounds[k][0]:.4f} ms by {bounds[k][1]} ({shape}) [{smi}]')

    phase('12. schur_qr_baed and schur_qr_packed against their plain '
          'versions')
    balt = {}
    batched_alt_checks(torch, ek, dev, balt)

    phase('13. the order-6 and order-7 sweeps through schur_qr_baed and '
          'schur_qr_packed')
    batched_alt_path(torch, tp, ek, dev, eps32, balt)
    launches.update(balt['launches'])
    check(f32_precision_pinned(), 'the script\'s IEEE f32 setting holds '
          'after the batched stages')

    phase('14. times of the two batched stages (CUDA events, median of 3)')
    print(f'card: {smi}')
    batched_alt_times(torch, tp, ek, smi, eps32, balt, times, bounds)
    for k in BATCHED_ALT:
        tk, tpl, shape = times[k]
        print(f'  {k}: kernel {tk:.3f} ms, plain {tpl:.3f} ms, bound '
              f'{bounds[k][0]:.4f} ms by {bounds[k][1]} ({shape}) [{smi}]')

    phase('15. the class API (rcwa) on the card, order 6 through the eig '
          'kernels, and order 10 against the functional path')
    cls = {}
    class_api_phase(torch, tp, ek, smi, dev, cls)
    check(f32_precision_pinned(), 'the script\'s IEEE f32 setting holds '
          'after the class API')

    exs = {}
    for i, ex_name in enumerate(EX_NAMES):
        phase(f'{16 + i}. {ex_name} at its published configuration, '
              f'{EX_STEPS} ADAM steps through the eig kernels')
        example_phase(torch, tp, ek, smi, dev, ex_name, exs)
        check(f32_precision_pinned(), 'the script\'s IEEE f32 setting holds '
              f'after {ex_name}')
    phase('18. the large route\'s kernels against their plain versions on '
          'the examples\' matrices (n = 882, 1054)')
    example_plain_checks(torch, exs)

    phase('19. Examples 0, 2 and 4 on the card (the class API)')
    sw = {19: {}, 20: {}, 21: {}}
    class_examples_phase(torch, tp, ek, smi, dev, sw[19])
    phase('20. Example 1, one raster a wavelength (orders 4 and 15), and the '
          'sweep primitives')
    sweep_phase(torch, tp, ek, smi, dev, sw[20])
    phase('21. Example 1-1 (orders 0 to 12) and Example 3 at order 20')
    multilayer_and_grid_phase(torch, tp, ek, smi, dev, sw[21])
    check(f32_precision_pinned(), 'the script\'s IEEE f32 setting holds '
          'after the sweep path')
    phase('22. hessenberg_blocked: hess_panel against the plain column loop '
          '(n = 882, 1922)')
    hess_large = hess_panel_phase(torch, ek, smi, dev)

    if FAILURES:
        print(f'\n{len(FAILURES)} check(s) failed:', *FAILURES, sep='\n  ')
        return 1
    errs = {'hessenberg': rec_main['hess'], 'schur_qr': rec_main['qr'],
            'tri_vectors': rec_main['vec_sep'], 'schur_ms': o20['err_ms'],
            'tri_vectors_blocked': o20['err_vec'], 'schur_qr_v2': alt['err_v2'],
            'schur_qr_ms': alt['err_ms'], 'schur_qr_baed': balt['err_baed'],
            'schur_qr_packed': balt['err_packed']}
    kernels = [{'name': k, 'route': 'cuda', 'source': SOURCES[k],
                'replaces': REPLACES[k], 'launches': launches[k],
                'max_abs_err': errs[k], 'ms': times[k][0],
                'plain_ms': times[k][1], 'bound_ms': bounds[k][0],
                'bound_by': bounds[k][1], 'library_ms': library.get(k)}
               for k in REPLACES]
    for k, n in list(cls['launches'].items()) + list(
            cls['launches_large'].items()):
        kernels[list(REPLACES).index(k)].update(class_launches=n)
    kernels[list(REPLACES).index('hessenberg')].update(hess)
    for k in LARGE:
        kernels[list(REPLACES).index(k)].update(examples={
            lab: dict(n=e['n'], launches_per_step=e['launches_per_step'][k],
                      ms=e['route_ms'][k], **e['checks'][k])
            for lab, e in exs.items()})
    kernels[list(REPLACES).index('schur_qr')].update(
        model_max_rel_err=qr_model_err)
    kernels[list(REPLACES).index('schur_ms')].update(
        work='the first two sweeps at n = 3362', full_ms=ms_ms,
        full_bound_ms=full_bound[0], full_bound_by=full_bound[1],
        split_ms={k: v[0] for k, v in split.items()})
    kernels[list(REPLACES).index('schur_qr_v2')].update(
        work=f'the first {V2_BUDGET} sweeps at B = 8, n = 338',
        full_ms=alt['v2_full'][0], full_bound_ms=alt['v2_full'][1][0],
        full_bound_by=alt['v2_full'][1][1])
    for k, budget in (('schur_qr_baed', BAED_BUDGET),
                      ('schur_qr_packed', PACKED_BUDGET)):
        t_full, b_full = balt['full'][k]
        kernels[list(REPLACES).index(k)].update(
            work=f'the first {budget} sweeps at B = 8, n = 338',
            full_ms=t_full, full_bound_ms=b_full[0], full_bound_by=b_full[1])
    # the sweep path (phases 19-21): each kernel's launches on each of its
    # paths, and its plain-version error at each new size
    for k in SMALL + LARGE:
        kernels[list(REPLACES).index(k)].update(sweep_path=dict(
            launches={label: got[k] for p in sw.values()
                      for label, got in p['launches'].items() if k in got},
            held={f'n={h["n"]}': h[k] for p in sw.values()
                  for h in p['holds'] if k in h}))
    kernels.append({'name': 'hess_panel', 'route': 'cuda',
                    'source': 'torcwa_tpu_torch/csrc/hess_panel.cu',
                    'replaces': None, 'library_ms': None,
                    'sizes': {f'n={n}': r for n, r in hess_large.items()}})
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
