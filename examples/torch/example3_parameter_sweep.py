"""Example 3 on the PyTorch port: a geometry (Wx, Wy) parameter sweep with
.mat export (the reference's example/Example3.ipynb, exact configuration;
twin of examples/example3_parameter_sweep.py).

532 nm, an a-Si:H meta-atom on a 1.46^2 substrate, 300 x 300 nm cell on a
300 x 300 raster (edge sharpness 1000), 300 nm thick, an 11 x 11 grid of
rectangle widths Wx, Wy in [50, 250] nm, order [20, 20] (2N = 3362),
forward t_xx(0, 0).  The reference runs the double loop one point at a
time: 18939 s in all, 156.5 s/solve on its CPU baseline (Example3.ipynb
cell 1; Xeon Gold 5118).

Here each point's raster goes into one batch, [B, 1, nx, ny], for one
batched ``solve_stack_pair``: at small order the whole grid is one batch
through the eig kernels' small route; from order 15 it runs in chunks of
4 points through the large route, as the twin does.

    python3 examples/torch/example3_parameter_sweep.py

Environment knobs (the twin's):
  EX3_ORDER   Fourier order (default 4; 20 is the reference's)
  EX3_NW      widths per axis (default 5; 11 is the reference's)
  EX3_GRID    raster (default 300)
  ASIH_TABLE  another a-Si:H (n, k) table than the vendored one
and the port's:
  EX3_DEVICE  'cuda' (default) or 'cpu'
Writes example3_sweep.mat.
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

LAMB0 = 532.
L = (300., 300.)
ORDER_N = int(os.environ.get('EX3_ORDER', '4'))
ORDER = (ORDER_N, ORDER_N)
GRID = int(os.environ.get('EX3_GRID', '300'))
NW = int(os.environ.get('EX3_NW', '5'))    # reference: 11
SUB_EPS = 1.46 ** 2
THICK = 300.
# points per batched solve from order 15 on (the twin's chunk)
CHUNK = 4

# a-Si:H at 532 nm from the library material, in float64 on the host: the
# vendored Tauc-Lorentz table unless ASIH_TABLE names the reference's
SI_EPS = complex(tp.aSiH(os.environ.get('ASIH_TABLE'), device='cpu')
                 .eps(float(np.float32(LAMB0))))


def rasters(wx, wy, grid=GRID, device='cuda', dtype=torch.float32):
    """Permittivity rasters of the (B,) widths' rectangles, (B, nx, ny)."""
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=grid, ny=grid,
                    edge_sharpness=1000., dtype=dtype, device=device)
    as_w = lambda w: torch.as_tensor(w, dtype=dtype,
                                     device=device).reshape(-1, 1, 1)
    geom = g.rectangle(as_w(wx), as_w(wy), L[0] / 2., L[1] / 2.)
    return geom * torch.tensor(SI_EPS, dtype=cdt, device=device) + (1. - geom)


def t00_of_wxwy(wx, wy, order=ORDER, grid=GRID, device='cuda',
                dtype=torch.float32, eig_backend='kernels'):
    """t_xx(0, 0) at the (B,) widths (nm), complex (B,): one raster a
    point in one batched solve."""
    spec = tp.StackSpec(order=tuple(order), L=L, n_layers=1, has_input=True)
    eps = rasters(wx, wy, grid, device, dtype)
    thick = torch.tensor([THICK], dtype=dtype, device=device)
    S, intr = tp.solve_stack_pair(spec, 1 / LAMB0, 0., 0., eps[:, None],
                                  thick, eps_in=SUB_EPS,
                                  eig_backend=eig_backend)
    return tp.sparam_xy_pair(S, intr['kx'], intr['ky'], SUB_EPS, 1.,
                             spec.order, [0, 0], [0, 0], 'xx')[..., 0]


def grid_points(nw=NW):
    """The widths and the (nw * nw, 2) points of the (Wx, Wy) grid."""
    w = np.linspace(50., 250., nw).astype(np.float32)
    Wx, Wy = np.meshgrid(w, w, indexing='ij')
    return w, np.stack([Wx.ravel(), Wy.ravel()], 1)


def sweep(pts, chunk=None, progress=False, **kw):
    """t_xx(0, 0) at the points, complex numpy, in batches of ``chunk``
    points (None: one batch)."""
    chunk = chunk or len(pts)
    out = []
    for c0 in range(0, len(pts), chunk):
        p = pts[c0:c0 + chunk]
        out.append(t00_of_wxwy(p[:, 0], p[:, 1], **kw).cpu().numpy())
        if progress:
            print(f'  {c0 + len(p)} / {len(pts)} solves', flush=True)
    return np.concatenate(out)


def main():
    device = os.environ.get('EX3_DEVICE', 'cuda')
    kw = dict(order=ORDER, grid=GRID, device=device)
    w, pts = grid_points(NW)
    chunk = CHUNK if ORDER_N >= 15 else None
    # warm-up (the kernels' build and first launches) on perturbed inputs
    sweep(pts[:chunk or len(pts)] + 0.01, **kw)
    t0 = time.time()
    t = sweep(pts, chunk, progress=chunk is not None, **kw).reshape(NW, NW)
    dt = time.time() - t0
    print('|t00|^2 over the (Wx, Wy) grid:')
    print(np.round(np.abs(t) ** 2, 4))
    where = torch.cuda.get_device_name(0) if device != 'cpu' else 'cpu'
    print(f'order {ORDER_N}: {NW * NW} solves in {dt:.2f} s '
          f'({dt / (NW * NW):.3f} s/solve) on {where}')
    save_mat('example3_sweep.mat', {'Wx': w, 'Wy': w, 'txx': t,
                                    'elapsed_time': dt})
    print('saved example3_sweep.mat')
    return t


if __name__ == '__main__':
    main()
