"""Example 1's meta-atom in the plain reference: its raster and its
t_xx(0, 0) at a batch of wavelengths, for the comparisons of every driver
that runs this configuration (``compare/sweep.py``, ``compare/band_grad.py``).
"""

import numpy as np
import torch

from rcwa_bench.reference import rcwa_ref as R


def occupancy(cfg, prec, device):
    """The configuration's rectangle on its raster, in ``prec``'s dtype."""
    nx, ny = cfg['grid']
    wx, wy = cfg['rectangle_nm']
    return R.rectangle(nx, ny, *cfg['period_nm'], wx, wy,
                       float(cfg['edge_sharpness']), prec.rdt, device)


def t_xx(cfg, traffic, prec, occ, lam, device):
    """t_xx(0, 0) of the raster ``occ`` at the wavelengths ``lam`` (nm), at
    the traffic's order and incidence; (B,) complex."""
    eps_si = torch.as_tensor(R.asih_eps(lam), dtype=prec.cdt, device=device)
    eps = occ * eps_si[:, None, None] + (1. - occ)
    o = int(traffic['order'])
    return R.transmission(
        prec, eps, np.asarray(lam), (o, o), tuple(cfg['period_nm']),
        cfg['thickness_nm'], cfg['substrate_eps'], cfg['superstrate_eps'],
        traffic.get('inc_deg', cfg['inc_deg']), cfg['azi_deg'])['xx']
