"""One kernel stage of one or more checkouts, on the same inputs, in one
call on the card: the batched single-shift Schur QR (csrc/schur_qr.cu;
the default), the batched Hessenberg reduction (csrc/hessenberg.cu), the
batched triangular eigenvectors (csrc/tri_vectors.cu), the one-launch
multishift QR (csrc/schur_qr_ms.cu), the blocked triangular eigenvectors
(csrc/tri_vectors_blocked.cu) or the two batched Schur stages on no route
(csrc/schur_qr_packed.cu, csrc/schur_qr_baed.cu), or the large route's
windowed multishift QR (csrc/schur_ms.cu).

    python3 qr_compare.py [--stage schur_qr|hessenberg|tri_vectors|
                                   schur_qr_ms|tri_vectors_blocked|
                                   schur_qr_packed|schur_qr_baed|
                                   schur_ms|unitarity|gates]
                          [--fmad=false] [DIR ...]
                          (default: this checkout)

Each DIR is the root of a checkout of this repository (an older commit's
made with ``git archive``).  Each runs in a process of its own that builds
its kernels from its own csrc/, in the order given, so two versions
compare on one card as DIR_A DIR_B DIR_B DIR_A.  The inputs are those of
chip_smoke.py, built by the checkout's own code.  Prints, per DIR, one
JSON line with the median of 3 CUDA-event times after a warm-up and the
card's name and power limit.

* schur_qr: the order-6 wave matrices at 0 degrees (B = 8, n = 338; phase
  3) and the 10-degree batches at orders 6, 7, 8 (n = 338, 450, 578; phase
  14), each in two Hessenberg forms: the checkout's ek.hessenberg
  ("routed", what its path feeds the stage) and the float64 plain
  reduction rounded to complex64 ("common", the same input for every
  checkout); both entry points (schur_qr, schur_qr_v2), whose C signature
  every checkout so far shares; per-lane (hi, sweeps, rotations) read
  through the C entry point.  With --fmad=false each checkout's
  csrc/schur_qr.cu is built alone without FMA contraction and only the
  stats are read: two kernels that apply the same operations in the same
  order then agree bit for bit.
* hessenberg: ek.hessenberg on the B = 8 wave matrices at n = 162 and 242
  (orders 4 and 5, 0 degrees), n = 338 (order 6, 0 degrees) and n = 450
  (order 7, 10 degrees), with the cluster size, shared memory and
  clusters the card runs at once where the checkout reports them.
* tri_vectors: ek.tri_vectors on the Schur factors of the B = 8 wave
  matrices at n = 338 (0 degrees), 450 and 578 (10 degrees), and of the
  first of them alone (B = 1), T from ek.hessenberg and ek.schur_qr (the
  same kernels in every checkout so far; the checksums of T show it),
  with torch.linalg.eig(T) beside them and the register slots where the
  checkout reports them.
* schur_qr_ms: sq.schur_qr_ms (m = 16) on one wave matrix at 500 nm and
  10 degrees at orders 6, 7 and 8 (n = 338, 450, 578; chip_smoke.py phase
  10), H and Q from ek.hessenberg, with (hi, sweeps, rotations), the
  kernel the checkout launches (cluster size and Z's placement where it
  reports them) and one torch.linalg.eig complex64 call on the same A.
* tri_vectors_blocked: the in-block kernel over all row blocks of the
  order-20 Schur factor (phase 6's T, 2N = 3362, S precomputed, as
  chip_smoke.py phase 7), the whole tri_vectors_blocked with its GEMMs
  and torch.linalg.eig(T) beside them, with checksums of T and Y.
* schur_qr_packed: sp.schur_qr_packed on phase 14's 10-degree batches (B =
  8, n = 338, 450, 578), H and Q from ek.hessenberg, with per-lane (hi,
  sweeps, rotations), the worst lane's residual and unitarity, ek.schur_qr
  on the same H, and the composed eig through each beside one
  torch.linalg.eig complex64 call.  With --fmad=false the checkout's
  csrc/schur_qr_packed.cu is built alone without FMA contraction and only
  the stats are read, as for schur_qr.
* schur_qr_baed: sb.schur_qr_baed on the same batches at m = 8 and 16,
  B = 1, 2, 4, 8 (the first B lanes), with ek.schur_qr at each B beside it,
  per-lane (hi, sweeps, rotations, rows AED deflated, AED multiply-adds) at
  B = 8, the kernel the checkout launches (cluster size, shared memory,
  clusters the card runs at once, where it reports them), the AED pass's
  cycles by part at B = 8, m = 8 (a build of csrc/schur_qr_baed.cu alone
  with clock64() probes: TORCWA_AED_CLOCKS in aed_warp.cuh, or, for a
  checkout whose AED is ms_aed.cuh's aed_window, probes inserted into a
  copy of it at the same parts; thread 0 of the AED threads sums the cycles
  of the window QR's scan and shift, a rotation's forming, row update,
  barriers and column update, and the rest of the pass, and the sweep
  loop by phase: AED, transform, chase), and the composed
  eig through it and through ek.schur_qr beside one torch.linalg.eig
  complex64 call.  --fmad=false as for schur_qr_packed.
* schur_ms: sm.schur_ms as the route calls it (m = large_shifts(n), the
  route's deflation multiplier) on one wave matrix at 500 nm and 10
  degrees at orders (10, 10), (8, 15) and (15, 15) (n = 882, 1054, 1922:
  Example 5's, Example 6's and Example 1's sizes), H and Q from
  hessenberg_blocked (the same code and bits in every checkout so far; a
  checksum of H shows it), with the stats tuple (hi, sweeps, AED-deflated,
  skipped chases, flops done, flops needed), the whole Schur form's ms, the
  eig.schur span's aed_rotations where the checkout counts them, and the AED
  pass's cycles by part with the window QR's rotations from a build of
  csrc/schur_ms.cu alone with clock64() probes (as for schur_qr_baed; the
  kernels launched through that library).  With --fmad=false the probed
  build is made without FMA contraction and only the stats, the rotations
  and aed_rotations are read: two checkouts that apply the same operations
  in the same order then agree bit for bit.
* unitarity: max|Z^H Z - I| of the multishift Schur stages where their
  float32 round-off meets chip_smoke.py's 1e-5 gates: schur_qr_ms (m = 16)
  on the order-6 wave matrix at 500 nm (phase 10) and schur_qr_baed on the
  order-7 batch (phase 13), each from the Hessenberg form of the routed
  reduction, the plain float32 reduction and the float64 one rounded to
  complex64; schur_ms as the route calls it on random matrices at n = 640,
  seeds 640 to 651 (phase 4 takes seed 640), and on the order-20 matrix
  (phase 6) with the device time of its AED launches (torch.profiler).
* gates: residual and unitarity of a Schur stage and of its plain float32
  version, run in full, on the inputs of three gates that read them:
  schur_ms as the route calls it on the random matrix of seed 640 at
  n = 640, H and Q from hessenberg_blocked (chip_smoke.py phase 4); and
  schur_qr_ms (m = 16) on those of the two card tests
  (tests/test_torch_cuda.py): the random matrix of seed 510 at n = 450, H
  and Q from the plain reduction (the cluster kernel,
  test_schur_qr_ms_cluster_kernel_matches_plain), and that of seed 7 at
  n = 700, H and Q from ek.hessenberg (the one-block kernel,
  test_schur_qr_ms_one_block_kernel_above_the_cluster); with the stats
  and each run's seconds.  The plain versions take minutes at n = 640 and
  700.  Then the large route's kernels on the sizes of chip_smoke.py phase
  21 whose plain versions do not fit the phase: Example 1-1's 30-degree
  layer at orders 9 and 12 (n = 722, 1250), held as phase 18 holds the
  examples' matrices (two schur_ms sweeps and tri_vectors_blocked against
  their plain versions, the whole Schur form against complex128
  eigenvalues); exits non-zero if one of those checks fails.

Needs a CUDA card; exits non-zero without one.
"""

import ctypes
import json
import math
import os
import subprocess
import sys

CASES = (('0 deg', 6, 0.), ('10 deg', 6, 10.), ('10 deg', 7, 10.),
         ('10 deg', 8, 10.))


def _alone_library(_build, source, names, flags=('-fmad=false',),
                   src_dir=None):
    """The checkout's csrc/<source> alone (from src_dir when given), built
    with `flags` (default: without contraction), its entry points `names`
    bound."""
    out = _build.BUILD_ROOT / 'qr_compare_alone' / f'lib{source[:-3]}.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), '-gencode',
                    'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                    '-Xcompiler', '-fPIC', '-shared', *flags, '-o',
                    str(out), str((src_dir or _build.CSRC) / source)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES.get(name, [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _no_fma_library(_build):
    """The checkout's csrc/schur_qr.cu alone, built without contraction."""
    return _alone_library(_build, 'schur_qr.cu',
                          ('torcwa_schur_qr_c64', 'torcwa_schur_qr_v2_c64'))


# The AED pass's parts, in the order of csrc/aed_warp.cuh's Clk slots: the
# cycles of the whole pass, of the window QR, of its scans and shifts, of a
# rotation's forming, row update, barriers (none a rotation in
# aed_warp.cuh) and column update, of the rest
# (spike, shifts, Householder, write-back), and the counts of rotations,
# QR sweeps (scans) and passes; then the kernel's sweep loop by phase (the
# whole loop, the AED phase with its barriers, the transform, the chase)
# and its sweeps
AED_CLK_SLOTS = ('total', 'qr', 'scan', 'form', 'rows', 'barrier', 'cols',
                 'after', 'rotations', 'sweeps', 'passes', 'loop',
                 'aed_phase', 'transform', 'chase', 'loop_sweeps')
# The same probes inserted into the AED of a checkout that has no
# aed_warp.cuh (csrc/ms_aed.cuh's aed_window): (anchor, replacement) in
# order, thread 0's cycles summed into torcwa_aed_clk
_MS_AED_PROBES = (
    ('#include "common.cuh"\n',
     '#include "common.cuh"\n'
     '__device__ unsigned long long torcwa_aed_clk[16];\n'),
    ('  const int tid = threadIdx.x;\n'
     '  const int s = max(hi - kw + 1, lo + 1);\n',
     '  const int tid = threadIdx.x;\n'
     '  const int s = max(hi - kw + 1, lo + 1);\n'
     '  const long long clk_t0 = clock64();\n'
     '  unsigned long long clk[11] = {};\n'),
    ('  int it = 0, mhi = kwe - 1;\n  while (true) {\n',
     '  int it = 0, mhi = kwe - 1;\n  const long long clk_q0 = clock64();\n'
     '  while (true) {\n    long long clk_a = clock64();\n'),
    ('    aed_sync<kNT, kBar>();\n    mhi = s_mhi;\n',
     '    aed_sync<kNT, kBar>();\n    clk[2] += clock64() - clk_a;\n'
     '    ++clk[9];\n    mhi = s_mhi;\n'),
    ('      const Givens g = givens_rounded(s_x, s_y);\n'
     '      const float c = g.c;\n      const float2 sg = g.s;\n',
     '      long long clk_b = clock64();\n'
     '      const Givens g = givens_rounded(s_x, s_y);\n'
     '      const float c = g.c;\n      const float2 sg = g.s;\n'
     '      asm volatile("" ::"f"(c), "f"(sg.x), "f"(sg.y));\n'
     '      { const long long t = clock64(); clk[3] += t - clk_b; '
     'clk_b = t; }\n'),
    ('      aed_sync<kNT, kBar>();\n      // columns k, k+1 of W',
     '      { const long long t = clock64(); clk[4] += t - clk_b; '
     'clk_b = t; }\n      aed_sync<kNT, kBar>();\n'
     '      { const long long t = clock64(); clk[5] += t - clk_b; '
     'clk_b = t; }\n      // columns k, k+1 of W'),
    ('      aed_sync<kNT, kBar>();\n    }\n    ++it;\n  }\n',
     '      { const long long t = clock64(); clk[6] += t - clk_b; '
     'clk_b = t; }\n      aed_sync<kNT, kBar>();\n'
     '      clk[5] += clock64() - clk_b;\n      ++clk[8];\n    }\n'
     '    ++it;\n  }\n  clk[1] = clock64() - clk_q0;\n'
     '  const long long clk_c0 = clock64();\n'),
    ('  AedResult res;\n',
     '  if (tid == 0) {\n    const long long t = clock64();\n'
     '    clk[7] = t - clk_c0;\n    clk[0] = t - clk_t0;\n    clk[10] = 1;\n'
     '    for (int i = 0; i < 11; ++i) atomicAdd(&torcwa_aed_clk[i], clk[i]);\n'
     '  }\n  AedResult res;\n'),
)
# and into its schur_qr_baed.cu's sweep loop, thread 0's phases
_BAED_PROBES = (
    ('  long long deflated = 0, aed_cmacs = 0;\n',
     '  long long deflated = 0, aed_cmacs = 0;\n'
     '  const long long clk_l0 = clock64();\n'
     '  unsigned long long clk[3] = {};\n'),
    ('      // ---- AED in the first warps; the shifts come with it ----\n',
     '      const long long clk_a = clock64();\n'),
    ('      const int s = s_aed.s, kwe = s_aed.kwe;\n',
     '      const long long clk_b = clock64();\n      clk[0] += clk_b - clk_a;\n'
     '      const int s = s_aed.s, kwe = s_aed.kwe;\n'),
    ('      // ---- chase over the whole active block (ms_chase.cuh) ----\n',
     '      const long long clk_c = clock64();\n      clk[1] += clk_c - clk_b;\n'),
    ('        chase_whole_block<kThreads>(H, Zt, n, lo, hi, m, s_shift, cc, '
     '&s_rot);\n',
     '        chase_whole_block<kThreads>(H, Zt, n, lo, hi, m, s_shift, cc, '
     '&s_rot);\n      clk[2] += clock64() - clk_c;\n'),
    ('  if (tid == 0) {\n    stats[0] = hi;\n',
     '  if (tid == 0) {\n'
     '    atomicAdd(&torcwa_aed_clk[11], clock64() - clk_l0);\n'
     '    for (int i = 0; i < 3; ++i) atomicAdd(&torcwa_aed_clk[12 + i], '
     'clk[i]);\n'
     '    atomicAdd(&torcwa_aed_clk[15], (unsigned long long)it);\n'
     '  }\n  if (tid == 0) {\n    stats[0] = hi;\n'),
)
# reads the slots and sets them to 0 again
_CLK_READER = """
extern "C" int torcwa_aed_clocks(void* out) {
  static const unsigned long long zero[16] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, SYMBOL, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(SYMBOL, zero, sizeof(zero));
  return (int)e;
}
"""


def probed_sources(csrc, dst, source='schur_qr_baed.cu'):
    """A copy of csrc in dst whose `source` sums the AED pass's cycles by
    part and exports torcwa_aed_clocks; returns the -D flags its build
    needs."""
    import shutil
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    warp = dst / 'aed_warp.cuh'
    if (warp.exists() and 'TORCWA_AED_CLOCKS' in warp.read_text()
            and '"aed_warp.cuh"' in (dst / source).read_text()):
        symbol, flags = 'aed_warp::torcwa_aed_clk', ['-DTORCWA_AED_CLOCKS']
    else:
        probes = [('ms_aed.cuh', _MS_AED_PROBES)]
        if source == 'schur_qr_baed.cu':
            probes.append(('schur_qr_baed.cu', _BAED_PROBES))
        for name, probes in probes:
            text = (dst / name).read_text()
            for anchor, new in probes:
                if text.count(anchor) != 1:
                    raise RuntimeError(f'{name}: probe anchor {anchor!r} '
                                       'not found once')
                text = text.replace(anchor, new)
            (dst / name).write_text(text)
        symbol, flags = 'torcwa_aed_clk', []
    src = dst / source
    src.write_text(src.read_text() + _CLK_READER.replace('SYMBOL', symbol))
    return flags


def _clk_parts(buf):
    """The AED passes' cycles by part from the probe's slots: per pass, per
    QR sweep (the scan and shift) and per rotation, with the counts."""
    v = dict(zip(AED_CLK_SLOTS, buf))
    p, r, w = max(v['passes'], 1), max(v['rotations'], 1), max(v['sweeps'], 1)
    return dict(passes=v['passes'], rotations=v['rotations'],
                sweeps=v['sweeps'],
                per_pass={k: v[k] / p for k in ('total', 'qr', 'after')},
                per_sweep={'scan': v['scan'] / w},
                per_rotation={k: v[k] / r for k in ('form', 'rows', 'barrier',
                                                      'cols')}), v


def aed_cycles(torch, clk, H, Q, m, kw, budget):
    """One launch of the probed schur_qr_baed on (H, Q): the AED pass's
    cycles by part, per pass, per QR sweep and per rotation."""
    B, n = H.shape[0], H.shape[-1]
    T, Zt = H.clone(), Q.mT.contiguous()
    st = torch.zeros(B, 5, dtype=torch.int64, device=H.device)
    buf = (ctypes.c_ulonglong * len(AED_CLK_SLOTS))()
    clk.torcwa_aed_clocks(buf)
    torch.cuda.synchronize()
    err = clk.torcwa_schur_qr_baed_c64(
        T.data_ptr(), Zt.data_ptr(), st.data_ptr(), B, n, m, kw, budget,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err or clk.torcwa_aed_clocks(buf):
        raise RuntimeError(f'probed schur_qr_baed n={n}: launch failed')
    parts, v = _clk_parts(buf)
    return dict(parts, sweeps_kernel=st[:, 1].tolist(),
                loop_per_matrix={k: v[k] / B for k in (
                    'loop', 'aed_phase', 'transform', 'chase',
                    'loop_sweeps')})


def one(label, no_fma):
    """Run in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import _build, eig_kernels as ek
    dev = torch.device('cuda', 0)
    lib = _no_fma_library(_build) if no_fma else _build.load()
    out = dict(dir=label, card=cs.smi_line(), fmad=not no_fma, stats={},
               ms={})
    for inc_name, order, inc_deg in CASES:
        _, A = cs.wave_matrices(torch, tp, (order, order), cs.LAMS,
                                math.radians(inc_deg), torch.float32, dev)
        A = A.contiguous()
        H64, Q64 = ek.hessenberg_plain(A.to(torch.complex128))
        forms = (('routed', ek.hessenberg(A)),
                 ('common', (H64.to(A.dtype), Q64.to(A.dtype))))
        for form, (H, Q) in forms:
            B, n = H.shape[0], H.shape[-1]
            for entry in ('schur_qr', 'schur_qr_v2'):
                fn = getattr(ek, entry)
                key = f'{entry} n={n} {inc_name} {form} H'
                T = torch.empty_like(H)
                Z = torch.empty_like(H)
                st = torch.empty(B, 3, dtype=torch.int32, device=dev)
                err = getattr(lib, f'torcwa_{entry}_c64')(
                    H.data_ptr(), Q.data_ptr(), T.data_ptr(), Z.data_ptr(),
                    st.data_ptr(), B, n, ek.MAX_ITER_FACTOR * n,
                    torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f'{key}: launch failed ({err})')
                out['stats'][key] = st.tolist()
                # the 0-degree batch is the stats' input only
                if not no_fma and (inc_name == '10 deg' or n == 338):
                    out['ms'][key] = cs.cuda_ms(torch, lambda: fn(H, Q),
                                                reps=3)
    print(json.dumps(out), flush=True)


def one_hessenberg(label):
    """--stage hessenberg in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import eig_kernels as ek
    dev = torch.device('cuda', 0)
    out = dict(dir=label, card=cs.smi_line(), stage='hessenberg', ms={},
               clusters={}, residual={})
    for inc_name, order, inc_deg in (('0 deg', 4, 0.), ('0 deg', 5, 0.),
                                     *CASES[:3:2]):
        _, A = cs.wave_matrices(torch, tp, (order, order), cs.LAMS,
                                math.radians(inc_deg), torch.float32, dev)
        A = A.contiguous()
        n = A.shape[-1]
        H, Q = ek.hessenberg(A)
        res = torch.linalg.matrix_norm(Q @ H @ Q.mH - A) \
            / torch.linalg.matrix_norm(A)
        out['residual'][f'n={n}'] = float(res.max())
        out['ms'][f'n={n} {inc_name}'] = cs.cuda_ms(
            torch, lambda: ek.hessenberg(A), reps=3)
        if hasattr(ek, 'hessenberg_cluster_info'):
            out['clusters'][f'n={n}'] = ek.hessenberg_cluster_info(n)
    print(json.dumps(out), flush=True)


def one_tri_vectors_blocked(label):
    """--stage tri_vectors_blocked in the checkout that is the working
    directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import (eig_qr as eq, schur_ms as sm,
                                      vec_blocked as vb)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    dev = torch.device('cuda', 0)
    _, A = cs.wave_matrices(torch, tp, cs.ORDER_L, cs.LAM_L,
                            math.radians(cs.WELL_POSED_DEG), torch.float32,
                            dev)
    A = A[0].contiguous()
    n = A.shape[-1]
    H, Q = hessenberg_blocked(A)
    T, _ = sm.schur_ms(H, Q, m=eq.large_shifts(n),
                       defl_mult=eq.LARGE_DEFL_MULT)
    dmin = vb.pivot_floor(T)
    blocks = [(max(r1 - vb.MAX_BLOCK, 0), r1)
              for r1 in range(n, 0, -vb.MAX_BLOCK)]
    Y = vb.tri_vectors_blocked(T)
    Ss = [(T[r0:r1, r1:] @ Y[r1:]).contiguous() for r0, r1 in blocks]

    def all_blocks():
        Yb = torch.eye(n, dtype=T.dtype, device=dev)
        for (r0, r1), S in zip(blocks, Ss):
            vb.tri_vectors_block(T, S, dmin, Yb, r0, r1)

    out = dict(dir=label, card=cs.smi_line(), stage='tri_vectors_blocked',
               n=n, launches=len(blocks),
               T_checksum=float(T.abs().double().sum()),
               Y_checksum=float(Y.abs().double().sum()))
    out['ms'] = {'in-block kernels': cs.cuda_ms(torch, all_blocks, reps=3),
                 'tri_vectors_blocked with GEMMs': cs.cuda_ms(
                     torch, lambda: vb.tri_vectors_blocked(T), reps=3),
                 'torch.linalg.eig(T)': cs.cuda_ms(
                     torch, lambda: torch.linalg.eig(T), reps=1)}
    print(json.dumps(out), flush=True)


def one_tri_vectors(label):
    """--stage tri_vectors in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import eig_kernels as ek
    dev = torch.device('cuda', 0)
    out = dict(dir=label, card=cs.smi_line(), stage='tri_vectors', ms={},
               library_ms={}, T_checksum={}, Y_err={}, slots={})
    for inc_name, order, inc_deg in CASES:
        _, A = cs.wave_matrices(torch, tp, (order, order), cs.LAMS,
                                math.radians(inc_deg), torch.float32, dev)
        H, Q = ek.hessenberg(A.contiguous())
        T = ek.schur_qr(H, Q)[0].contiguous()
        n = T.shape[-1]
        if hasattr(ek, 'tri_vectors_slots'):
            out['slots'][f'n={n}'] = ek.tri_vectors_slots(n)
        for B in ((8, 1) if n == 338 else (8,)):
            Tb = T[:B].contiguous()
            key = f'B={B} n={n} {inc_name}'
            out['T_checksum'][key] = float(Tb.abs().double().sum())
            Y, Yp = ek.tri_vectors(Tb), ek.tri_vectors_plain(Tb)
            out['Y_err'][key] = float(((Y - Yp).abs().amax((-2, -1))
                                       / Yp.abs().amax((-2, -1))).max())
            out['ms'][key] = cs.cuda_ms(torch, lambda: ek.tri_vectors(Tb),
                                        reps=3)
            out['library_ms'][key] = cs.cuda_ms(
                torch, lambda: torch.linalg.eig(Tb), reps=1)
    print(json.dumps(out), flush=True)


def one_schur_qr_ms(label):
    """--stage schur_qr_ms in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import eig_kernels as ek, schur_qr_ms as sq
    dev = torch.device('cuda', 0)
    inc = math.radians(cs.WELL_POSED_DEG)
    out = dict(dir=label, card=cs.smi_line(), stage='schur_qr_ms', m=cs.MS_M,
               ms={}, stats={}, library_ms={}, kernel={}, unitarity={})
    for order in (6, 7, 8):
        _, A = cs.wave_matrices(torch, tp, (order, order), cs.LAM_L, inc,
                                torch.float32, dev)
        A = A.contiguous()
        n = A.shape[-1]
        H, Q = ek.hessenberg(A)
        H, Q = H[0], Q[0]
        key = f'n={n}'
        T, Z, st = sq.schur_qr_ms(H, Q, m=cs.MS_M, return_stats=True)
        out['stats'][key] = [int(x) for x in st]
        out['unitarity'][key] = cs.schur_quality(torch, A[0], T, Z)[1]
        if hasattr(sq, 'schur_qr_ms_cluster_info'):
            out['kernel'][key] = sq.schur_qr_ms_cluster_info(n, cs.MS_M)
        out['ms'][key] = cs.cuda_ms(
            torch, lambda: sq.schur_qr_ms(H, Q, m=cs.MS_M), reps=3)
        out['library_ms'][key] = cs.cuda_ms(
            torch, lambda: torch.linalg.eig(A[0]), reps=3)
    print(json.dumps(out), flush=True)


def one_unitarity(label):
    """--stage unitarity in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import (eig_kernels as ek, eig_qr as eq,
                                      schur_ms as sm, schur_qr_baed as sb,
                                      schur_qr_ms as sq)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    dev = torch.device('cuda', 0)
    inc = math.radians(cs.WELL_POSED_DEG)
    out = dict(dir=label, card=cs.smi_line(), stage='unitarity')

    def forms(A):
        f = {'routed': ek.hessenberg(A)}
        f['plain float32'] = ek.hessenberg_plain(A)
        H, Q = ek.hessenberg_plain(A.to(torch.complex128))
        f['float64 rounded'] = (H.to(A.dtype), Q.to(A.dtype))
        return f

    _, A = cs.wave_matrices(torch, tp, (6, 6), cs.LAM_L, inc, torch.float32,
                            dev)
    A = A.contiguous()
    out['schur_qr_ms order 6'] = {
        k: cs.schur_quality(torch, A[0], *sq.schur_qr_ms(
            H[0], Q[0], m=cs.MS_M))[1] for k, (H, Q) in forms(A).items()}
    _, A = cs.wave_matrices(torch, tp, (7, 7), cs.LAMS, inc, torch.float32,
                            dev)
    A = A.contiguous()
    out['schur_qr_baed order 7, worst lane'] = {}
    for k, (H, Q) in forms(A).items():
        T, Z = sb.schur_qr_baed(H, Q)
        out['schur_qr_baed order 7, worst lane'][k] = max(
            cs.schur_quality(torch, A[b], T[b], Z[b])[1]
            for b in range(A.shape[0]))
    per_seed = []
    for seed in range(640, 652):
        A = cs.rand_c64(torch, 640, seed, dev)
        H, Q = hessenberg_blocked(A)
        T, Z = sm.schur_ms(H, Q, m=eq.large_shifts(640),
                           defl_mult=eq.LARGE_DEFL_MULT)
        per_seed.append(cs.schur_quality(torch, A, T, Z)[1])
    out['schur_ms n=640, seeds 640-651'] = per_seed
    _, A = cs.wave_matrices(torch, tp, cs.ORDER_L, cs.LAM_L, inc,
                            torch.float32, dev)
    A = A[0].contiguous()
    H, Q = hessenberg_blocked(A)
    cfg = dict(m=eq.large_shifts(A.shape[-1]), defl_mult=eq.LARGE_DEFL_MULT)
    T, Z = sm.schur_ms(H, Q, **cfg)
    out['schur_ms order 20'] = cs.schur_quality(torch, A, T, Z)[1]
    ms, launches = cs.schur_ms_split(torch, sm, H, Q, cfg)['AED']
    out['AED order 20'] = dict(ms=ms, launches=launches,
                               ms_per_sweep=ms / launches)
    print(json.dumps(out), flush=True)


def one_gates(label):
    """--stage gates in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import time
    import numpy as np
    import torch
    import chip_smoke as cs
    from torcwa_tpu_torch.ops import (eig_kernels as ek, eig_qr as eq,
                                      schur_ms as sm, schur_qr_ms as sq)
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    dev = torch.device('cuda', 0)
    out = dict(dir=label, card=cs.smi_line(), stage='gates', m=16)
    # chip_smoke.py phase 4: schur_ms as the route calls it at n = 640
    A = cs.rand_c64(torch, cs.N_BIG, 640, dev)
    H, Q = hessenberg_blocked(A)
    cfg = dict(m=eq.large_shifts(cs.N_BIG), defl_mult=eq.LARGE_DEFL_MULT)
    rec = dict(seed=640, **cfg)
    for key, fn in (('kernel', sm.schur_ms),
                    ('plain float32', sm.schur_ms_plain)):
        t0 = time.perf_counter()
        T, Z, st = fn(H, Q, return_stats=True, **cfg)
        torch.cuda.synchronize()
        res, orth, tri = cs.schur_quality(torch, A, T, Z)
        rec[key] = dict(residual=res, unitarity=orth, triangular=tri,
                        stats=[int(x) for x in st[:4]],
                        seconds=time.perf_counter() - t0)
    out[f'schur_ms n={cs.N_BIG}'] = rec
    print(json.dumps(out), flush=True)
    for n, seed, hess in ((450, 510, ek.hessenberg_plain),
                          (700, 7, ek.hessenberg)):
        # tests/test_torch_cuda.py::_rand1
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        A = torch.as_tensor((0.3 * a).astype(np.complex64), device=dev)
        H, Q = hess(A[None].contiguous())
        rec = dict(seed=seed, cluster=sq.schur_qr_ms_cluster(n, 16))
        for key, fn in (('kernel', sq.schur_qr_ms),
                        ('plain float32', sq.schur_qr_ms_plain)):
            t0 = time.perf_counter()
            T, Z, st = fn(H[0], Q[0], m=16, return_stats=True)
            torch.cuda.synchronize()
            res, orth, tri = cs.schur_quality(torch, A, T, Z)
            rec[key] = dict(residual=res, unitarity=orth, triangular=tri,
                            stats=[int(x) for x in st],
                            seconds=time.perf_counter() - t0)
        out[f'n={n}'] = rec
        print(json.dumps(out), flush=True)
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch._constants import f32_pinned
    ex11 = cs.load_example('example1_1_multilayer')
    with f32_pinned():
        for order_n in (9, 12):
            spec = tp.StackSpec(order=(order_n,) * 2, L=ex11.L, n_layers=1)
            A = cs.layer_matrix(torch, tp, spec, ex11.layers(dev)[1],
                                ex11.LAMB0)
            n = A.shape[-1]
            out[f'example1_1 n={n}'] = cs.large_route_hold(
                torch, A, f'example1_1 n = {n}')
            print(json.dumps(out), flush=True)
    if cs.FAILURES:
        sys.exit(1)


# phase 14's 10-degree batches: B = 8 at n = 338, 450, 578
BATCHED_CASES = CASES[1:]


def one_schur_qr_packed(label, no_fma):
    """--stage schur_qr_packed in the checkout that is the working
    directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import (_build, eig_kernels as ek, eig_qr as eq,
                                      schur_qr_packed as sp)
    dev = torch.device('cuda', 0)
    lib = _alone_library(_build, 'schur_qr_packed.cu',
                         ('torcwa_schur_qr_packed_f32',)) if no_fma else None
    out = dict(dir=label, card=cs.smi_line(), stage='schur_qr_packed',
               fmad=not no_fma, stats={}, ms={}, schur_qr_ms={}, quality={},
               eig_ms={}, library_ms={})
    for inc_name, order, inc_deg in BATCHED_CASES:
        _, A = cs.wave_matrices(torch, tp, (order, order), cs.LAMS,
                                math.radians(inc_deg), torch.float32, dev)
        A = A.contiguous()
        H, Q = ek.hessenberg(A)
        B, n = H.shape[0], H.shape[-1]
        key = f'n={n}'
        if no_fma:
            Hp, Ztp = sp.pack_planar(H), sp.pack_planar(Q.mT)
            st = torch.zeros(B, 3, dtype=torch.int32, device=dev)
            err = lib.torcwa_schur_qr_packed_f32(
                Hp.data_ptr(), Ztp.data_ptr(), st.data_ptr(), B, n,
                sp.padded(n), ek.MAX_ITER_FACTOR * n,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f'{key}: launch failed ({err})')
            out['stats'][key] = st.tolist()
            continue
        T, Z, st = sp.schur_qr_packed(H, Q, return_stats=True)
        out['stats'][key] = torch.stack(st, 1).tolist()
        q = [cs.schur_quality(torch, A[b], T[b], Z[b]) for b in range(B)]
        out['quality'][key] = dict(residual=max(x[0] for x in q),
                                   unitarity=max(x[1] for x in q),
                                   triangular=all(x[2] for x in q))
        out['ms'][key] = cs.cuda_ms(torch, lambda: sp.schur_qr_packed(H, Q),
                                    reps=3)
        out['schur_qr_ms'][key] = cs.cuda_ms(torch, lambda: ek.schur_qr(H, Q),
                                             reps=3)
        out['eig_ms'][key] = {
            k: cs.cuda_ms(torch, lambda f=f: eq.eig_small(A, f), reps=3)
            for k, f in (('schur_qr', ek.schur_qr),
                         ('schur_qr_packed', sp.schur_qr_packed))}
        out['library_ms'][key] = cs.cuda_ms(
            torch, lambda: torch.linalg.eig(A), reps=1)
        print(json.dumps(dict(out, partial=True)), flush=True)
    print(json.dumps(out), flush=True)


def one_schur_qr_baed(label, no_fma):
    """--stage schur_qr_baed in the checkout that is the working
    directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import (_build, eig_kernels as ek, eig_qr as eq,
                                      schur_qr_baed as sb)
    from torcwa_tpu_torch.ops.schur_ms import AED_KW, max_sweeps
    dev = torch.device('cuda', 0)
    entry = ('torcwa_schur_qr_baed_c64',)
    if no_fma:
        lib = _alone_library(_build, 'schur_qr_baed.cu', entry)
    else:
        src = _build.BUILD_ROOT / 'qr_compare_probed'
        flags = probed_sources(_build.CSRC, src)
        clk = _alone_library(_build, 'schur_qr_baed.cu',
                             entry + ('torcwa_aed_clocks',), flags, src)
    out = dict(dir=label, card=cs.smi_line(), stage='schur_qr_baed',
               fmad=not no_fma, stats={}, ms={}, schur_qr_ms={}, kernel={},
               aed_cycles={}, eig_ms={}, library_ms={})
    stream = torch.cuda.current_stream().cuda_stream
    for inc_name, order, inc_deg in BATCHED_CASES:
        _, A = cs.wave_matrices(torch, tp, (order, order), cs.LAMS,
                                math.radians(inc_deg), torch.float32, dev)
        A = A.contiguous()
        H, Q = ek.hessenberg(A)
        n = H.shape[-1]
        for m in (8, 16):
            key = f'n={n} m={m}'
            if no_fma:
                T, Zt = H.clone(), Q.mT.contiguous()
                st = torch.zeros(H.shape[0], 5, dtype=torch.int64, device=dev)
                err = lib.torcwa_schur_qr_baed_c64(
                    T.data_ptr(), Zt.data_ptr(), st.data_ptr(), H.shape[0], n,
                    m, AED_KW, max_sweeps(n, m, 40), stream)
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f'{key}: launch failed ({err})')
                out['stats'][key] = st.tolist()
                continue
            st = sb.schur_qr_baed(H, Q, m=m, return_stats=True)[2]
            out['stats'][key] = torch.stack(st, 1).tolist()
            if hasattr(sb, 'schur_qr_baed_cluster_info'):
                out['kernel'][key] = sb.schur_qr_baed_cluster_info(n, m)
            for B in (1, 2, 4, 8):
                Hb, Qb = H[:B].contiguous(), Q[:B].contiguous()
                out['ms'][f'B={B} {key}'] = cs.cuda_ms(
                    torch, lambda: sb.schur_qr_baed(Hb, Qb, m=m), reps=3)
                if m == 8:
                    out['schur_qr_ms'][f'B={B} n={n}'] = cs.cuda_ms(
                        torch, lambda: ek.schur_qr(Hb, Qb), reps=3)
        if no_fma:
            continue
        out['aed_cycles'][f'n={n}'] = aed_cycles(
            torch, clk, H, Q, 8, AED_KW, max_sweeps(n, 8, 40))
        out['eig_ms'][f'n={n}'] = {
            k: cs.cuda_ms(torch, lambda f=f: eq.eig_small(A, f), reps=3)
            for k, f in (('schur_qr', ek.schur_qr),
                         ('schur_qr_baed', sb.schur_qr_baed))}
        out['library_ms'][f'n={n}'] = cs.cuda_ms(
            torch, lambda: torch.linalg.eig(A), reps=1)
        print(json.dumps(dict(out, partial=True)), flush=True)
    print(json.dumps(out), flush=True)


SCHUR_MS_ORDERS = ((10, 10), (8, 15), (15, 15))


def one_schur_ms(label, no_fma):
    """--stage schur_ms in the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import contextlib
    import types
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import _build, eig_qr as eq, schur_ms as sm
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked
    from torcwa_tpu_torch.utils import timing
    dev = torch.device('cuda', 0)
    names = tuple(k for k in _build._SIGNATURES if k.startswith('torcwa_ms_'))
    src = _build.BUILD_ROOT / 'qr_compare_probed'
    flags = probed_sources(_build.CSRC, src, 'schur_ms.cu')
    clk = _alone_library(_build, 'schur_ms.cu', names + ('torcwa_aed_clocks',),
                         flags + (['-fmad=false'] if no_fma else []), src)

    @contextlib.contextmanager
    def probed():
        """schur_ms's launches through the probed library."""
        built = sm._build
        sm._build = types.SimpleNamespace(load=lambda: clk)
        try:
            yield
        finally:
            sm._build = built

    out = dict(dir=label, card=cs.smi_line(), stage='schur_ms',
               fmad=not no_fma, h_sum={}, stats={}, ms={}, aed_rotations={},
               probed_stats={}, aed_cycles={})
    buf = (ctypes.c_ulonglong * len(AED_CLK_SLOTS))()
    for order in SCHUR_MS_ORDERS:
        _, A = cs.wave_matrices(torch, tp, order, cs.LAM_L,
                                math.radians(cs.WELL_POSED_DEG),
                                torch.float32, dev)
        H, Q = hessenberg_blocked(A[0].contiguous())
        n = H.shape[-1]
        key = f'n={n}'
        out['h_sum'][key] = [float(H.real.double().sum()),
                             float(H.imag.double().sum())]

        def run():
            return sm.schur_ms(H, Q, m=eq.large_shifts(n),
                               defl_mult=eq.LARGE_DEFL_MULT,
                               return_stats=True)[2]
        if not no_fma:
            out['stats'][key] = list(run())
            out['ms'][key] = cs.cuda_ms(torch, run, reps=3)
        with timing.tracing() as tr:
            with contextlib.ExitStack() as stack:
                if no_fma:
                    stack.enter_context(probed())
                st = run()
            torch.cuda.synchronize()
            rec = [r for r in tr.collect() if r.name == 'eig.schur']
        if no_fma:
            out['stats'][key] = list(st)
        out['aed_rotations'][key] = rec[0].counters.get('aed_rotations')
        clk.torcwa_aed_clocks(buf)
        with probed():
            out['probed_stats'][key] = list(run())
        torch.cuda.synchronize()
        if clk.torcwa_aed_clocks(buf):
            raise RuntimeError(f'{key}: reading the probes failed')
        out['aed_cycles'][key] = _clk_parts(buf)[0]
        print(json.dumps(dict(out, partial=True)), flush=True)
    print(json.dumps(out), flush=True)


def main(args):
    import torch
    if not torch.cuda.is_available():
        print('qr_compare: CUDA is not available', file=sys.stderr)
        return 2
    stage = 'schur_qr'
    if '--stage' in args:
        i = args.index('--stage')
        stage = args[i + 1]
        args = args[:i] + args[i + 2:]
    if stage not in STAGES:
        print(f'qr_compare: unknown stage {stage!r}', file=sys.stderr)
        return 2
    flags = [a for a in args if a == '--fmad=false']
    me = os.path.abspath(__file__)
    for d in [a for a in args if a not in flags] or ['.']:
        res = subprocess.run([sys.executable, me, '--one', d, stage, *flags],
                             cwd=os.path.abspath(d))
        if res.returncode:
            return res.returncode
    return 0


STAGES = ('schur_qr', 'hessenberg', 'tri_vectors', 'schur_qr_ms',
          'tri_vectors_blocked', 'schur_qr_packed', 'schur_qr_baed',
          'schur_ms', 'unitarity', 'gates')

if __name__ == '__main__':
    if sys.argv[1:2] == ['--one']:
        label, stage = sys.argv[2], sys.argv[3]
        if stage == 'hessenberg':
            one_hessenberg(label)
        elif stage == 'tri_vectors':
            one_tri_vectors(label)
        elif stage == 'schur_qr_ms':
            one_schur_qr_ms(label)
        elif stage == 'tri_vectors_blocked':
            one_tri_vectors_blocked(label)
        elif stage == 'schur_qr_packed':
            one_schur_qr_packed(label, '--fmad=false' in sys.argv[4:])
        elif stage == 'schur_qr_baed':
            one_schur_qr_baed(label, '--fmad=false' in sys.argv[4:])
        elif stage == 'schur_ms':
            one_schur_ms(label, '--fmad=false' in sys.argv[4:])
        elif stage == 'unitarity':
            one_unitarity(label)
        elif stage == 'gates':
            one_gates(label)
        else:
            one(label, '--fmad=false' in sys.argv[4:])
    else:
        sys.exit(main(sys.argv[1:]))
