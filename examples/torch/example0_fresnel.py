"""Example 0 on the PyTorch port: the Fresnel equations (the reference's
example/Example0.ipynb; twin of examples/example0_fresnel.py).

A bare interface between vacuum and a dielectric: RCWA with no internal
layer (so no eig) must reproduce the analytic Fresnel reflection
coefficients for TM and TE polarization from 0 to 80 degrees, through the
class API at order [1, 1].

    python3 examples/torch/example0_fresnel.py

Environment knobs:
  EX0_DEVICE  'cuda' (default) or 'cpu'
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

import numpy as np
import torch

import torcwa_tpu_torch as tp

N_SUB = 2.0


def rcwa_reflection(inc_deg, device='cuda', dtype=torch.complex64):
    """(|r_pp|^2, |r_ss|^2) of the (0, 0) order at ``inc_deg`` degrees."""
    sim = tp.rcwa(freq=1 / 500., order=[1, 1], L=[300., 300.], dtype=dtype,
                  device=device)
    sim.add_output_layer(eps=N_SUB ** 2)
    sim.set_incident_angle(inc_ang=np.deg2rad(inc_deg), azi_ang=0.)
    sim.solve_global_smatrix()
    r = [sim.S_parameters(orders=[0, 0], direction='forward',
                          port='reflection', polarization=pol,
                          ref_order=[0, 0])
         for pol in ('pp', 'ss')]
    return tuple(float(x.abs()[0] ** 2) for x in r)


def fresnel(inc_deg, n2=N_SUB):
    th = np.deg2rad(inc_deg)
    ct = np.cos(th)
    st = np.sin(th)
    kz2 = np.sqrt(n2 ** 2 - st ** 2 + 0j)
    r_tm = (n2 ** 2 * ct - kz2) / (n2 ** 2 * ct + kz2)
    r_te = (ct - kz2) / (ct + kz2)
    return abs(r_tm) ** 2, abs(r_te) ** 2


def main():
    device = os.environ.get('EX0_DEVICE', 'cuda')
    print(f'{"angle":>6} {"R_TM rcwa":>10} {"R_TM exact":>10}'
          f' {"R_TE rcwa":>10} {"R_TE exact":>10}')
    rows = []
    for ang in range(0, 90, 10):
        rp, rs = rcwa_reflection(ang, device)
        fp, fs = fresnel(ang)
        print(f'{ang:6d} {rp:10.5f} {fp:10.5f} {rs:10.5f} {fs:10.5f}')
        # mixed tolerance: 2e-3 absolute, 1% relative (float32 loses
        # ~0.8% near grazing incidence where kz -> 0)
        tol = lambda f: max(2e-3, 0.01 * f)
        assert abs(rp - fp) < tol(fp) and abs(rs - fs) < tol(fs), 'mismatch!'
        rows.append((ang, rp, fp, rs, fs))
    print('RCWA matches Fresnel.')
    return rows


if __name__ == '__main__':
    main()
