"""Example 2 on the PyTorch port: oblique incidence and field reconstruction
(the reference's example/Example2.ipynb; twin of examples/example2_fields.py).

A 300 nm square of eps 3.5^2, 400 nm thick, in a 500 x 500 nm cell (grid
200 x 200) between glass (1.46^2) and air, 600 nm, 20 degrees, order
[5, 5] (2N = 242: the eig kernels' small route).  Prints the diffraction
angles of the (0, 0) and (+-1, 0) orders, reconstructs |E|^2 on the xz
plane (101 x 101 points) and on an xy cut at mid-layer, and checks that
both are finite and within a plausible envelope.

    python3 examples/torch/example2_fields.py

Environment knobs:
  EX2_ORDER   Fourier order, 'ox,oy' (default '5,5')
  EX2_DEVICE  'cuda' (default) or 'cpu'
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

import numpy as np
import torch

import torcwa_tpu_torch as tp

L = [500., 500.]
ORDER = (5, 5)
GRID = 200
ORDERS = [[0, 0], [1, 0], [-1, 0]]


def simulate(order=ORDER, device='cuda', dtype=torch.complex64,
             eig_backend='auto', grid=GRID):
    """The solved class: the square on glass under 20 degrees."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=grid, ny=grid, edge_sharpness=1000.,
                    dtype=rdt, device=device)
    sq = g.square(W=300., Cx=L[0] / 2., Cy=L[1] / 2.)
    eps = sq * (3.5 ** 2) + (1. - sq)

    sim = tp.rcwa(freq=1 / 600., order=list(order), L=L, dtype=dtype,
                  device=device, eig_backend=eig_backend)
    sim.add_input_layer(eps=1.46 ** 2)
    sim.add_output_layer(eps=1.)
    sim.set_incident_angle(inc_ang=np.deg2rad(20.), azi_ang=0.)
    sim.add_layer(thickness=400., eps=eps)
    sim.solve_global_smatrix()
    return sim


def diffraction_angles(sim):
    """(inclination, azimuth) in degrees of ORDERS in the output layer."""
    inc, azi = sim.diffraction_angle(orders=ORDERS, layer='output',
                                     unit='degree')
    return (np.atleast_1d(inc.detach().cpu().numpy()),
            np.atleast_1d(azi.detach().cpu().numpy()))


def field_maps(sim):
    """|E|^2 on the xz plane through the cell's centre (x in [0, 500],
    z in [-300, 700], 101 points each) and on the xy cut at mid-layer,
    for a unit x-polarized plane wave from the input side."""
    sim.source_planewave(amplitude=[1., 0.], direction='forward')
    x = np.linspace(0., L[0], 101)
    z = np.linspace(-300., 700., 101)
    (Ex, Ey, Ez), _ = sim.field_xz(x, z, y=L[1] / 2.)
    I_xz = Ex.abs() ** 2 + Ey.abs() ** 2 + Ez.abs() ** 2
    (Exs, Eys, Ezs), _ = sim.field_xy(layer_num=0, x_axis=x, y_axis=x,
                                      z_prop=200.)
    I_xy = Exs.abs() ** 2 + Eys.abs() ** 2 + Ezs.abs() ** 2
    return I_xz, I_xy


def check_envelope(I_xz, I_xy):
    """The twin's checks: fields finite and within a physically plausible
    envelope for a unit-amplitude plane-wave source (the reference's
    Example2.ipynb |E| maps peak at a few units)."""
    for name, arr in [('I_xz', I_xz), ('I_xy', I_xy)]:
        arr = arr.detach().cpu().numpy()
        assert np.isfinite(arr).all(), f'{name} has non-finite entries'
        assert 0.05 < float(arr.max()) < 100., \
            f'{name} max {float(arr.max()):.3g} implausible'


def main():
    order = tuple(int(v) for v in
                  os.environ.get('EX2_ORDER', '%d,%d' % ORDER).split(','))
    sim = simulate(order, os.environ.get('EX2_DEVICE', 'cuda'))
    inc, azi = diffraction_angles(sim)
    print('diffraction angles (deg):')
    for (m, n), a, b in zip(ORDERS, inc, azi):
        print(f'  order ({m:+d},{n:+d}): inclination {float(a):7.2f}'
              f'  azimuth {float(b):7.2f}')
    I_xz, I_xy = field_maps(sim)
    print(f'\n|E|^2 over the xz plane: min {float(I_xz.min()):.4f} '
          f'max {float(I_xz.max()):.4f}')
    print(f'|E|^2 at mid-layer xy cut: min {float(I_xy.min()):.4f} '
          f'max {float(I_xy.max()):.4f}')
    check_envelope(I_xz, I_xy)
    print('EXAMPLE2 FIELD CHECKS PASS')
    return I_xz, I_xy


if __name__ == '__main__':
    main()
