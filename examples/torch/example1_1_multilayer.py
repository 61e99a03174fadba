"""Example 1-1 on the PyTorch port: a multi-layered meta-atom (the
reference's example/Example1-1.ipynb; twin of
examples/example1_1_multilayer.py).

A 6-layer twisted stack: three a-Si:H rectangles (180 x 100 nm, 200 nm)
rotated 0/30/60 degrees in SU-8, interleaved with homogeneous SU-8 spacers
(100 nm), on a SiO2 substrate at 650 nm, 300 x 300 nm cell on a 300 x 300
raster.  The reference re-solves the structure at orders 0..22 and
exports the circular-polarization transmissions (TRR/TLR/TRL/TLL from
txx/tyx/txy/tyy, Example1-1.ipynb cell 2): an order-convergence study.

As in the twin, the spacers take the O(N) homogeneous path
(``StackSpec.homogeneous``) instead of a dense eig, and all four
polarization transfer elements come from one solve; the three patterned
layers' eigs run as one batch of three matrices through the eig kernels
(2N = 2, 98, 338, 722, 1250 at orders 0, 3, 6, 9, 12: the small route
below 2N = 512, the large route above).

    python3 examples/torch/example1_1_multilayer.py

Environment knobs:
  EX11_ORDERS  comma list, or the highest order (default '0,3,6,9,12';
               22 is the reference's full sweep)
  ASIH_TABLE   another a-Si:H (n, k) table than the vendored one
  EX11_DEVICE  'cuda' (default) or 'cpu'
Writes example1_1_data_order_<N>.mat per order like the notebook.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

import time

import numpy as np
import torch

import torcwa_tpu_torch as tp
from torcwa_tpu_torch.utils import save_mat

LAMB0 = 650.
L = (300., 300.)
NX = NY = 300
SUB_EPS = 1.46 ** 2
SU8_EPS = 1.6 ** 2
W_X, W_Y = 180., 100.
THICKS = [200., 100., 200., 100., 200., 100.]
HOMOGENEOUS = (False, True, False, True, False, True)

_spec_orders = os.environ.get('EX11_ORDERS', '0,3,6,9,12')
if ',' in _spec_orders:
    ORDERS = [int(s) for s in _spec_orders.split(',')]
else:
    ORDERS = list(range(int(_spec_orders) + 1))

# a-Si:H at 650 nm from the library material, in float64 on the host: the
# vendored Tauc-Lorentz table unless ASIH_TABLE names the reference's
SI_EPS = complex(tp.aSiH(os.environ.get('ASIH_TABLE'), device='cpu')
                 .eps(LAMB0))


def layers(device='cuda', dtype=torch.float32, grid=(NX, NY)):
    """The three patterned layers' permittivity rasters, (3, nx, ny)."""
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=grid[0], ny=grid[1],
                    edge_sharpness=1000., dtype=dtype, device=device)
    rects = [g.rectangle(W_X, W_Y, L[0] / 2., L[1] / 2., theta=th)
             for th in (0., np.deg2rad(30.), np.deg2rad(60.))]
    si = torch.tensor(SI_EPS, dtype=cdt, device=device)
    return torch.stack([r * si + (1. - r) * SU8_EPS for r in rects])


def t_elements(order_n, device='cuda', dtype=torch.float32,
               eig_backend='kernels', grid=(NX, NY)):
    """(txx, tyx, txy, tyy) of the (0, 0) order at order_n, complex
    numbers, from one solve."""
    spec = tp.StackSpec(order=(order_n, order_n), L=L, n_layers=6,
                        has_input=True, homogeneous=HOMOGENEOUS)
    thick = torch.as_tensor(THICKS, dtype=dtype, device=device)
    S, intr = tp.solve_stack_pair(
        spec, 1. / LAMB0, 0., 0., layers(device, dtype, grid), thick,
        eps_in=SUB_EPS, eps_scalars=[SU8_EPS] * 3, eig_backend=eig_backend)
    return tuple(complex(tp.sparam_xy_pair(
        S, intr['kx'], intr['ky'], SUB_EPS, 1., spec.order, [0, 0], [0, 0],
        pol)[0]) for pol in ('xx', 'yx', 'xy', 'yy'))


def circular(txx, tyx, txy, tyy):
    """RCP/LCP transmissions from the xy basis (Example1-1 cell 2)."""
    return tuple(abs(v) ** 2 / 4. for v in (
        txx + tyy + 1j * (txy - tyx), txx - tyy + 1j * (txy + tyx),
        txx - tyy - 1j * (txy + tyx), txx + tyy - 1j * (txy - tyx)))


def main():
    device = os.environ.get('EX11_DEVICE', 'cuda')
    print(f'{"order":>6} {"TRR":>9} {"TLR":>9} {"TRL":>9} {"TLL":>9}'
          f' {"sum":>9}')
    rows = []
    t0 = time.time()
    for order_n in ORDERS:
        txx, tyx, txy, tyy = t_elements(order_n, device)
        TRR, TLR, TRL, TLL = circular(txx, tyx, txy, tyy)
        print(f'{order_n:6d} {TRR:9.5f} {TLR:9.5f} {TRL:9.5f} {TLL:9.5f}'
              f' {TRR + TLR + TRL + TLL:9.5f}', flush=True)
        save_mat(f'example1_1_data_order_{order_n}.mat',
                 {'txx': np.asarray(txx), 'tyx': np.asarray(tyx),
                  'txy': np.asarray(txy), 'tyy': np.asarray(tyy),
                  'TRR': TRR, 'TLR': TLR, 'TRL': TRL, 'TLL': TLL})
        rows.append((order_n, TRR, TLR, TRL, TLL))
    dt = time.time() - t0
    where = torch.cuda.get_device_name(0) if device != 'cpu' else 'cpu'
    print(f'{len(ORDERS)} orders in {dt:.1f} s on {where}')
    return rows


if __name__ == '__main__':
    main()
