"""The measurement behind the refinement setting of torcwa_tpu_torch's
eig_qr (REFINE = (steps, gap)), on one CUDA card:

    python3 refine_scenes.py

Large route, order (20, 20) (2N = 3362, one wavelength, grid 256, float32):
the |t_xx|^2 error and the raster-gradient cosine against a complex128
torch.linalg.eig oracle at five (wavelength, tilt) scenes, for each
(steps, gap) setting of LARGE_SETTINGS, with torch.linalg.eig complex64
beside them.  At 0 degrees (the wave matrix exactly real, degenerate pairs)
the gradient is ill posed in any eigensolver, so only |t_xx|^2 counts there.

Small route, order (6, 6) (2N = 338, 8 wavelengths): the same two numbers
and the derivative along the pillar's own raster at 0, 0.2 and 10 degrees
for each setting of SMALL_SETTINGS.

It shares the scene and the helpers of chip_smoke.py, prints one line per
reading and checks nothing.  Needs no JAX and no network.
"""

import math
import sys

import numpy as np

import chip_smoke as cs

SCENES = ((500., 10.), (620., 10.), (450., 4.), (700., 20.), (500., 0.))
LARGE_SETTINGS = ((2, 0.1), (3, 1.0), (4, 0.5), (4, 1.0), (6, 1.0))
SMALL_SETTINGS = ((1, 0.1), (1, 1.0), (4, 1.0))


def readings(torch, T, g, T_o, g_o, occ):
    d, d_o = (float((x.double() * occ).sum()) for x in (g, g_o))
    return (f'|t_xx|^2 off by {float((T.double() - T_o).abs().max()):.2e}, '
            f'cosine {cs.cosine(g, g_o):.6f}, pillar-direction derivative '
            f'{abs(d - d_o) / abs(d_o):.2e} rel')


def main():
    import torch
    if not torch.cuda.is_available():
        print('refine_scenes: CUDA is not available', file=sys.stderr)
        return 2
    from torcwa_tpu_torch._constants import f32_pinned
    # the script's own products in IEEE f32 too
    with f32_pinned():
        return run(torch)


def run(torch):
    import torcwa_tpu_torch as tp
    from torcwa_tpu_torch.ops import eig_qr as eq
    dev = torch.device('cuda', 0)
    print(f'card: {cs.smi_line()}')
    eps, _ = cs.wave_matrices(torch, tp, (6, 6), cs.LAMS[:1], 0.,
                              torch.float32, dev)
    occ = (eps.double() - 1.) / (cs.EPS_HI - 1.)
    keep = eq.REFINE

    for lam0, deg in SCENES:
        lam, inc = np.array([lam0]), math.radians(deg)
        ref = cs.fwd_grad(torch, tp, eps.double(), lam, cs.ORDER_L, inc,
                          'torch')
        lap = cs.fwd_grad(torch, tp, eps, lam, cs.ORDER_L, inc, 'torch')
        print(f'order 20, {lam0:.0f} nm, {deg:.0f} deg: oracle |t_xx|^2 '
              f'{ref[0].tolist()}; torch.linalg.eig complex64 '
              f'{readings(torch, *lap, *ref, occ)}', flush=True)
        for setting in LARGE_SETTINGS:
            eq.REFINE = setting
            got = cs.fwd_grad(torch, tp, eps, lam, cs.ORDER_L, inc, 'kernels')
            print(f'  (steps, gap) = {setting}: '
                  f'{readings(torch, *got, *ref, occ)}', flush=True)
        del ref, lap, got

    for deg in (0., 0.2, 10.):
        inc = math.radians(deg)
        ref = cs.fwd_grad(torch, tp, eps.double(), cs.LAMS, (6, 6), inc,
                          'torch')
        lap = cs.fwd_grad(torch, tp, eps, cs.LAMS, (6, 6), inc, 'torch')
        print(f'order 6, 8 wavelengths, {deg} deg: torch.linalg.eig '
              f'complex64 {readings(torch, *lap, *ref, occ)}', flush=True)
        for setting in SMALL_SETTINGS:
            eq.REFINE = setting
            got = cs.fwd_grad(torch, tp, eps, cs.LAMS, (6, 6), inc, 'kernels')
            ms = cs.cuda_ms(torch, lambda: cs.fwd_grad(
                torch, tp, eps, cs.LAMS, (6, 6), inc, 'kernels'), reps=3)
            print(f'  (steps, gap) = {setting}: '
                  f'{readings(torch, *got, *ref, occ)}; fwd+grad {ms:.1f} ms '
                  f'per sweep', flush=True)
    eq.REFINE = keep
    return 0


if __name__ == '__main__':
    sys.exit(main())
