"""The large route's Schur stage on a batch, its lanes in lock step, timed
beside each lane alone, on the card.

    python3 scripts/schur_lanes_times.py [--single-only] [--out FILE]

From the root of a checkout, on a machine with a CUDA card.  At n = 882
and 1922 (orders 10 and 15 of chip_smoke.py's layer, two wavelengths at
10 degrees) it reduces each wavelength's matrix with ``hessenberg_blocked``
and times ``schur_ms`` as the route calls it: B = 1 (one lane), two B = 1
calls one after the other, and B = 2 in lock step (CUDA events, median of
3 after a warm-up), with the kernel launches of each call.  Each lone
call's T and Z are printed as a digest, so that two checkouts' bits
compare; ``--single-only`` leaves out the batch, as a checkout whose
``schur_ms`` takes no batch needs.  chip_smoke.py phase 20 holds the lanes
to the lone calls bit for bit.  Prints one JSON record (also to
``--out``).
"""

import argparse
import hashlib
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ORDERS = ((10, 10), (15, 15))
LAMS = (500., 600.)


def digest(torch, *xs):
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for x in xs:
        h.update(torch.view_as_real(x.contiguous()).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--single-only', action='store_true')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import chip_smoke as cs
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import eig_kernels as ek
    from torcwa_tpu_torch.ops import eig_qr as eq
    from torcwa_tpu_torch.ops import schur_ms as sm
    from torcwa_tpu_torch.ops.hess_blocked import hessenberg_blocked

    if not torch.cuda.is_available():
        print('schur_lanes_times: no CUDA card', file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    out = dict(card=cs.smi_line(), device=torch.cuda.get_device_name(0),
               checkout=os.getcwd(), cases={})

    def launches(fn):
        before = ek.LAUNCHES['schur_ms']
        got = fn()
        torch.cuda.synchronize()
        return got, ek.LAUNCHES['schur_ms'] - before

    for order in ORDERS:
        _, A = cs.wave_matrices(torch, tp, order, np.array(LAMS),
                                math.radians(cs.WELL_POSED_DEG),
                                torch.float32, dev)
        lanes = [hessenberg_blocked(a.contiguous()) for a in A]
        H = torch.stack([h for h, _ in lanes])
        Q = torch.stack([q for _, q in lanes])
        n = H.shape[-1]
        cfg = dict(m=eq.large_shifts(n), defl_mult=eq.LARGE_DEFL_MULT)
        rec = dict(n=n, lams=list(LAMS), alone=[])

        def alone(l):
            return sm.schur_ms(H[l], Q[l], return_stats=True, **cfg)
        for l in range(len(LAMS)):
            (T1, Z1, st1), k = launches(lambda: alone(l))
            rec['alone'].append(dict(stats=[int(x) for x in st1],
                                     launches=k, digest=digest(torch, T1, Z1)))
        rec['ms_b1'] = cs.cuda_ms(torch, lambda: alone(0), reps=3)
        rec['ms_two_b1'] = cs.cuda_ms(
            torch, lambda: [alone(l) for l in range(len(LAMS))], reps=3)
        line = (f'n={n}: Schur form B=1 {rec["ms_b1"]:.1f} ms, two B=1 '
                f'{rec["ms_two_b1"]:.1f} ms')
        if not args.single_only:
            _, rec['launches_b2'] = launches(lambda: sm.schur_ms(H, Q, **cfg))
            rec['ms_b2'] = cs.cuda_ms(torch, lambda: sm.schur_ms(H, Q, **cfg),
                                      reps=3)
            line += f', B=2 lock step {rec["ms_b2"]:.1f} ms'
        print(line, flush=True)
        out['cases'][f'n={n}'] = rec
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
