"""Example 4 on the PyTorch port: gradient validation (the reference's
example/Example4.ipynb; twin of examples/example4_gradient_check.py).

Three-way comparison of dT/dR for a cylindrical meta-atom (R = 90 and
100 nm, 600 nm of eps 2.0709^2 on glass, 473 nm, order [4, 4], grid
200 x 200): a central difference (dR = 0.05) against the exact backward
and the broadening-stabilized eig backward.  The comparison needs float64;
the eig kernels take complex64 only, so the float64 runs name
``eig_backend='torch'`` (``torch.linalg.eig``) on every device, and a
float32 run through the kernels is printed beside them.

    python3 examples/torch/example4_gradient_check.py

Environment knobs:
  EX4_ORDER   Fourier order, 'ox,oy' (default '4,4')
  EX4_DEVICE  'cuda' (default) or 'cpu'
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

import numpy as np
import torch

import torcwa_tpu_torch as tp

L = [300., 300.]
ORDER = (4, 4)
GRID = 200
RADII = (90., 100.)
DR = 0.05


def T_of_R(R, stable=True, broadening=1e-10, order=ORDER, device='cuda',
           dtype=torch.float64, eig_backend='torch', grid=GRID):
    """|t_xx(0, 0)|^2 of the cylinder of radius R (a float or a real
    tensor, which keeps its graph).  ``dtype`` is the real precision;
    ``broadening`` is set as ``Eig.broadening_parameter`` for the solve
    and restored after it."""
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=grid, ny=grid, edge_sharpness=500.,
                    dtype=dtype, device=device)
    geom = g.circle(R, L[0] / 2., L[1] / 2.)
    eps = geom * (2.0709 ** 2) + (1. - geom)
    saved = tp.Eig.broadening_parameter
    tp.Eig.broadening_parameter = broadening
    try:
        sim = tp.rcwa(freq=1 / 473., order=list(order), L=L, dtype=cdt,
                      device=device, stable_eig_grad=stable,
                      eig_backend=eig_backend)
        sim.add_input_layer(eps=1.46 ** 2)
        sim.set_incident_angle(inc_ang=0., azi_ang=0.)
        sim.add_layer(thickness=600., eps=eps)
        sim.solve_global_smatrix()
        txx = sim.S_parameters(orders=[0, 0], direction='forward',
                               port='transmission', polarization='xx',
                               ref_order=[0, 0])
    finally:
        tp.Eig.broadening_parameter = saved
    return txx.abs()[0] ** 2


def dT_dR(R, stable=True, broadening=1e-10, **kw):
    """(T, dT/dR) at R by the backward of the solve."""
    r = torch.tensor(R, dtype=kw.get('dtype', torch.float64),
                     device=kw.get('device', 'cuda'), requires_grad=True)
    T = T_of_R(r, stable, broadening, **kw)
    return float(T.detach()), float(torch.autograd.grad(T, r)[0])


def gradient_rows(order=ORDER, device='cuda', radii=RADII, grid=GRID):
    """Per radius: (R, T, finite difference, exact, broadened) in float64
    through torch.linalg.eig, and (T, broadened) in float32 through the
    eig kernels."""
    f64 = dict(order=order, device=device, grid=grid)
    f32 = dict(f64, dtype=torch.float32, eig_backend='kernels')
    rows = []
    for R in radii:
        T = float(T_of_R(R, **f64))
        fd = (float(T_of_R(R + DR, **f64))
              - float(T_of_R(R - DR, **f64))) / (2 * DR)
        exact = dT_dR(R, stable=False, **f64)[1]
        broad = dT_dR(R, stable=True, broadening=1e-10, **f64)[1]
        T32, broad32 = dT_dR(R, stable=True, broadening=1e-10, **f32)
        rows.append((R, T, fd, exact, broad, T32, broad32))
    return rows


def main():
    order = tuple(int(v) for v in
                  os.environ.get('EX4_ORDER', '%d,%d' % ORDER).split(','))
    device = os.environ.get('EX4_DEVICE', 'cuda')
    print(f'{"R":>6} {"T":>9} {"dT/dR fd":>12} {"exact":>12} '
          f'{"broadened":>12} {"f32 kernels":>12}')
    rows = gradient_rows(order, device)
    for R, T, fd, exact, broad, T32, broad32 in rows:
        print(f'{R:6.1f} {T:9.5f} {fd:12.3e} {exact:12.3e} {broad:12.3e} '
              f'{broad32:12.3e}')
        # the unstabilized backward can be NaN at exact degeneracies, as
        # the reference's Example4 shows; the broadened backward is the
        # production path
        assert np.isclose(broad, fd, rtol=5e-2, atol=2e-5)
    print('broadened autodiff matches finite differences.')
    return rows


if __name__ == '__main__':
    main()
