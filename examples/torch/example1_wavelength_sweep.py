"""Example 1 on the PyTorch port: a rectangular meta-atom's wavelength
sweep (the reference's example/Example1.ipynb, exact configuration; twin
of examples/example1_wavelength_sweep.py).

A 180 x 100 nm a-Si:H rectangle on a 1.46^2 substrate, 300 x 300 nm
cell rasterized 300 x 300 (edge sharpness 1000), 300 nm thick, order
[15, 15] (2N = 1922), 61 wavelengths 400..700 nm, with the dispersive
a-Si:H permittivity re-evaluated at every wavelength, where the reference
loops wavelengths in Python and rebuilds the solver each time.

Here the permittivity is evaluated on the batch of wavelengths at once
and makes one raster a wavelength, [B, 1, nx, ny], for one batched
``solve_stack_pair``: at small order the whole sweep is one batch through
the eig kernels' small route; from order 15 (2N = 1922, the large route,
whose Schur stage runs a chunk's lanes in lock step) it runs in chunks of
2 wavelengths, as the twin does.

    python3 examples/torch/example1_wavelength_sweep.py

Environment knobs (the twin's):
  EX1_ORDER   Fourier order (default 4; 15 is the reference's)
  EX1_NLAM    wavelengths (default 31; 61 is the reference's)
  EX1_GRID    raster (default 256; 300 is the reference's)
  EX1_GOLDEN  an .npz of a complex128 host run ('lambs', 'txx') to hold
              |t_xx|^2 against at matching wavelengths
  ASIH_TABLE  another a-Si:H (n, k) table than the vendored one
and the port's:
  EX1_DEVICE  'cuda' (default) or 'cpu'
"""
import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

import time

import numpy as np
import torch

import torcwa_tpu_torch as tp

L = (300., 300.)
ORDER_N = int(os.environ.get('EX1_ORDER', '4'))
ORDER = (ORDER_N, ORDER_N)
GRID = int(os.environ.get('EX1_GRID', '256'))
N_LAM = int(os.environ.get('EX1_NLAM', '31'))
LAMBDAS = np.linspace(400., 700., N_LAM)
SUB_EPS = 1.46 ** 2
THICK = 300.
# wavelengths per batched solve from order 15 on (the twin's chunk)
CHUNK = 2


@functools.lru_cache(maxsize=None)
def a_si(device):
    """The a-Si:H material on ``device``: the vendored Tauc-Lorentz table,
    or ASIH_TABLE's (the reference's measured table for parity runs)."""
    return tp.aSiH(os.environ.get('ASIH_TABLE'), device=device)


def build_geom(grid=GRID, device='cuda', dtype=torch.float32):
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=grid, ny=grid,
                    edge_sharpness=1000., dtype=dtype, device=device)
    return g.rectangle(180., 100., L[0] / 2., L[1] / 2.)


def t00(freqs, geom, order=ORDER, eig_backend='kernels'):
    """|t_xx(0,0)|^2 at the (B,) frequencies: eps(lambda) of a-Si:H on the
    batch makes one raster a wavelength (geom's precision and device)."""
    cdt = torch.complex64 if geom.dtype == torch.float32 else \
        torch.complex128
    freqs = torch.as_tensor(freqs, dtype=geom.dtype, device=geom.device)
    eps_si = a_si(str(geom.device)).eps(1.0 / freqs).to(cdt)
    eps = geom * eps_si[:, None, None] + (1. - geom)       # (B, nx, ny)
    spec = tp.StackSpec(order=tuple(order), L=L, n_layers=1, has_input=True)
    S, intr = tp.solve_stack_pair(spec, freqs, 0., 0., eps[:, None], [THICK],
                                  eps_in=SUB_EPS, eig_backend=eig_backend)
    t = tp.sparam_xy_pair(S, intr['kx'], intr['ky'], SUB_EPS, 1., spec.order,
                          [0, 0], [0, 0], 'xx')
    return (t.real ** 2 + t.imag ** 2)[..., 0]


def sweep(freqs, geom, order=ORDER, eig_backend='kernels', chunk=None):
    """|t_xx(0,0)|^2 over the sweep as a numpy array, in batches of
    ``chunk`` wavelengths (None: one batch)."""
    chunk = chunk or len(freqs)
    return np.concatenate([
        t00(freqs[c0:c0 + chunk], geom, order, eig_backend).cpu().numpy()
        for c0 in range(0, len(freqs), chunk)])


def main():
    device = os.environ.get('EX1_DEVICE', 'cuda')
    geom = build_geom(GRID, device)
    freqs = torch.as_tensor(1.0 / LAMBDAS, dtype=torch.float32,
                            device=device)
    chunk = CHUNK if ORDER_N >= 15 else None
    # warm-up (the kernels' build and first launches) on perturbed inputs
    sweep(freqs[:chunk or len(freqs)] * 1.0003, geom, ORDER)
    t0 = time.time()
    T = sweep(freqs, geom, ORDER, chunk=chunk)
    dt = time.time() - t0

    for lam, t in zip(LAMBDAS, T):
        print(f'lambda={lam:6.1f} nm   T00={t:.5f}')
    where = torch.cuda.get_device_name(0) if geom.is_cuda else 'cpu'
    print(f'\norder {list(ORDER)}, grid {GRID}, dispersive a-Si:H in-sweep: '
          f'{N_LAM} wavelengths in {dt:.2f} s '
          f'({dt / N_LAM:.4f} s/solve) on {where}')

    golden = os.environ.get('EX1_GOLDEN')
    if golden:
        ref = np.load(golden)
        lam_ref = ref['lambs']
        t_ref = np.abs(ref['txx']) ** 2
        idx = [int(np.argmin(np.abs(LAMBDAS - l))) for l in lam_ref]
        ours = T[idx]
        ok = np.allclose(LAMBDAS[idx], lam_ref)
        rel = np.abs(ours - t_ref) / np.maximum(np.abs(t_ref), 1e-3)
        print(f'golden cross-check ({golden}): lambda match={ok}, '
              f'max |dT|={np.abs(ours - t_ref).max():.2e}, '
              f'max rel={rel.max():.2e}')
        for l, a, b in zip(lam_ref, ours, t_ref):
            print(f'  lambda={l:6.1f}  ours={a:.5f}  ref_f64={b:.5f}')
    return T


if __name__ == '__main__':
    main()
