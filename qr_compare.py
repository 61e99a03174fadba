"""The batched single-shift Schur QR kernel (csrc/schur_qr.cu) of one or
more checkouts, on the same inputs, in one call on the card: per-lane
stats and times.

    python3 qr_compare.py [--fmad=false] [DIR ...]   (default: this checkout)

Each DIR is the root of a checkout of this repository (an older commit's
made with ``git archive``).  Each runs in a process of its own that builds
its kernels from its own csrc/, in the order given, so two versions
compare on one card as DIR_A DIR_B DIR_B DIR_A.  The inputs are those of
chip_smoke.py, built by the checkout's own wave_matrices and hessenberg
(the same code in every checkout so far): the order-6 wave matrices at 0
degrees (B = 8, n = 338; phase 3) and the 10-degree batches at orders 6,
7, 8 (n = 338, 450, 578; phase 14).  Both entry points (schur_qr,
schur_qr_v2), whose C signature every checkout so far shares.  Prints,
per DIR, one JSON line: per-lane (hi, sweeps, rotations) read through the
C entry point, and the median of 3 CUDA-event times after a warm-up, with
the card's name and power limit.  With --fmad=false each checkout's
csrc/schur_qr.cu is built alone without FMA contraction and only the stats
are read: two kernels that apply the same operations in the same order
then agree bit for bit.  Needs a CUDA card; exits non-zero without one.
"""

import ctypes
import json
import math
import os
import subprocess
import sys

CASES = (('0 deg', 6, 0.), ('10 deg', 6, 10.), ('10 deg', 7, 10.),
         ('10 deg', 8, 10.))


def _no_fma_library(_build):
    """The checkout's csrc/schur_qr.cu alone, built without contraction."""
    out = _build.BUILD_ROOT / 'qr_compare_nofma' / 'libschur_qr.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), '-gencode',
                    'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                    '-Xcompiler', '-fPIC', '-shared', '-fmad=false', '-o',
                    str(out), str(_build.CSRC / 'schur_qr.cu')], check=True)
    lib = ctypes.CDLL(str(out))
    for name in ('torcwa_schur_qr_c64', 'torcwa_schur_qr_v2_c64'):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


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
        H, Q = ek.hessenberg(A.contiguous())
        B, n = H.shape[0], H.shape[-1]
        for entry in ('schur_qr', 'schur_qr_v2'):
            fn = getattr(ek, entry)
            key = f'{entry} n={n} {inc_name}'
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
                out['ms'][key] = cs.cuda_ms(torch, lambda: fn(H, Q), reps=3)
    print(json.dumps(out), flush=True)


def main(args):
    import torch
    if not torch.cuda.is_available():
        print('qr_compare: CUDA is not available', file=sys.stderr)
        return 2
    flags = [a for a in args if a == '--fmad=false']
    me = os.path.abspath(__file__)
    for d in [a for a in args if a not in flags] or ['.']:
        res = subprocess.run([sys.executable, me, '--one', d, *flags],
                             cwd=os.path.abspath(d))
        if res.returncode:
            return res.returncode
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--one']:
        one(sys.argv[2], '--fmad=false' in sys.argv[3:])
    else:
        sys.exit(main(sys.argv[1:]))
