"""Example 5's figure of merit in the plain reference: |t_yy - t_xx| of the
(0, 0) transmission of a W = (width, height) rectangle, and its gradient in
W, for the comparison of the ADAM loop (``compare/adam.py``)."""

import numpy as np
import torch

from rcwa_bench.reference import rcwa_ref as R


def fom_and_grad(cfg, prec, W, device):
    """(FoM, dFoM/dW) at W (nm), a float and a float64 numpy pair."""
    W = torch.as_tensor(W, dtype=prec.rdt, device=device).requires_grad_(True)
    nx, ny = cfg['grid']
    L = cfg['period_nm']
    occ = R.rectangle(nx, ny, L[0], L[1], W[0], W[1],
                      float(cfg['edge_sharpness']), prec.rdt, device)
    si = complex(R.asih_eps([cfg['wavelength_nm']])[0])
    eps = occ * si + (1. - occ)
    t = R.transmission(prec, eps[None], [cfg['wavelength_nm']],
                       tuple(cfg['order']), tuple(L), cfg['thickness_nm'],
                       cfg['substrate_eps'], cfg['superstrate_eps'],
                       cfg['inc_deg'], cfg['azi_deg'], pols=('xx', 'yy'))
    f = (t['yy'] - t['xx']).abs()[0]
    g, = torch.autograd.grad(f, W)
    return float(f.detach()), g.detach().cpu().numpy().astype(np.float64)
