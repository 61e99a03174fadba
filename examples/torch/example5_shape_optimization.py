"""Example 5 on the PyTorch port: a shape derivative that maximizes the
polarization anisotropy of a meta-atom (the reference's
example/Example5.ipynb, exact configuration; twin of
examples/example5_shape_optimization.py).

Optimizes the width and height of a rectangular a-Si:H meta-atom at 532 nm,
order (10, 10) (2N = 882), grid 300 x 300, 250 nm thick, on glass:
FoM = |t_yy - t_xx| of the (0, 0) transmission, 400 ADAM iterations with
the notebook's learning rate decaying linearly from 1 to 0, the
denominator sqrt(v_hat + eps), W clamped to [50, 250] nm.  float32, the
eig through the port's CUDA kernels (one matrix at n = 882: the large
route, hessenberg_blocked -> schur_ms -> tri_vectors_blocked).

    python3 examples/torch/example5_shape_optimization.py

Environment knobs:
  EX5_ITERS   iterations to run (default 20; 400 is the notebook's run)
  EX5_CKPT    checkpoint file (default example5_state.npz), saved every 50
              iterations and at the last; an existing one is resumed
  EX5_ORDER   Fourier order, 'ox,oy' (default '10,10')
  EX5_GRID    raster, 'nx,ny' (default '300,300')
  EX5_DEVICE  'cuda' (default) or 'cpu'
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

import numpy as np
import torch

import torcwa_tpu_torch as tp
from torcwa_tpu_torch.optim import maximize_adam
from torcwa_tpu_torch.utils import load_state, save_state

LAMB0 = 532.
L = (300., 300.)
THICK = 250.
SUB_EPS = 1.46 ** 2
ORDER = (10, 10)
GRID = (300, 300)
ITER_MAX = 400          # the length of the notebook's lr schedule


def _pair(name, default):
    return tuple(int(v) for v in os.environ.get(name, default).split(','))


def config():
    """The run's settings from the environment."""
    return dict(iters=int(os.environ.get('EX5_ITERS', '20')),
                ckpt=os.environ.get('EX5_CKPT', 'example5_state.npz'),
                order=_pair('EX5_ORDER', '%d,%d' % ORDER),
                grid=_pair('EX5_GRID', '%d,%d' % GRID),
                device=os.environ.get('EX5_DEVICE', 'cuda'))


def initial_params(grid, device):
    """W = (100, 50) nm, the notebook's start."""
    return torch.tensor([100., 50.], device=device)


def loop_kwargs():
    """maximize_adam's settings: the notebook's learning rate 1 -> 0 over
    400 iterations, W clamped to [50, 250] nm, sqrt(v_hat + eps)."""
    return dict(lr_schedule=lambda step: 1. * (1. - step / ITER_MAX),
                lower=50., upper=250., eps_in_sqrt=True)


def make_layer(order=ORDER, grid=GRID, device='cuda',
               dtype=torch.float32):
    """(spec, eps_of): the stack, and W = (width, height) in nm -> the
    a-Si:H rectangle's permittivity raster in air (Example5.ipynb cell 1).
    ``dtype`` is the real precision of the raster and the solve."""
    spec = tp.StackSpec(order=tuple(order), L=L, n_layers=1, has_input=True)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    si = tp.aSiH(device=device).eps(LAMB0).to(cdt)
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=grid[0], ny=grid[1],
                    edge_sharpness=500., dtype=dtype, device=device)

    def eps_of(W):
        W = W.to(dtype)
        geom = g.rectangle(W[0], W[1], L[0] / 2., L[1] / 2.)
        return geom * si + (1. - geom)

    return spec, eps_of


def make_fom(order=ORDER, grid=GRID, device='cuda',
             dtype=torch.float32, eig_backend='kernels', inc_deg=0.,
             azi_deg=0.):
    """FoM(W) = |t_yy - t_xx| of the (0, 0) transmission (Example5.ipynb
    cell 1); ``inc_deg`` and ``azi_deg`` tilt the incidence."""
    spec, eps_of = make_layer(order, grid, device, dtype)
    inc, azi = float(np.deg2rad(inc_deg)), float(np.deg2rad(azi_deg))

    def fom(W):
        S, intr = tp.solve_stack_pair(
            spec, 1. / LAMB0, inc, azi, eps_of(W)[None], [THICK],
            eps_in=SUB_EPS, eig_backend=eig_backend)
        t = [tp.sparam_xy_pair(S, intr['kx'], intr['ky'], SUB_EPS, 1.,
                               spec.order, [0, 0], [0, 0], pol)[0]
             for pol in ('xx', 'yy')]
        return (t[1] - t[0]).abs()

    return fom


def main():
    cfg = config()
    dev = torch.device(cfg['device'])
    fom = make_fom(cfg['order'], cfg['grid'], dev)
    if os.path.exists(cfg['ckpt']):
        st = load_state(cfg['ckpt'], device=dev)
        state = (st['W'].float(), st['m'].float(), st['v'].float(),
                 int(st['step']))
        history = [tuple(map(float, h)) for h in st['history'].tolist()]
        print(f'resumed from {cfg["ckpt"]} at iteration {state[3]}')
    else:
        W0 = initial_params(cfg['grid'], dev)
        state = (W0, torch.zeros_like(W0), torch.zeros_like(W0), 0)
        history = []
    it0 = state[3]

    def callback(rec):
        W = rec.params.tolist()
        history.append((rec.fom, W[0], W[1]))
        print(f'Iteration: {rec.step - 1} / Delta: {rec.fom:.4f} / '
              f'W: [{W[0]:.2f}, {W[1]:.2f}] / '
              f'Elapsed time: {rec.elapsed_s:.0f} s', flush=True)
        if rec.step % 50 == 0 or rec.step == cfg['iters']:
            m, v, step = rec.opt_state
            save_state(cfg['ckpt'], {'W': rec.params, 'm': m, 'v': v,
                                     'step': step,
                                     'history': np.asarray(history)})

    t0 = time.time()
    n_it = max(cfg['iters'] - it0, 0)
    maximize_adam(fom, state[0], n_it, callback=callback, state=state,
                  **loop_kwargs())
    if history:
        print(f'final FoM {history[-1][0]:.4f}  '
              f'({(time.time() - t0) / max(n_it, 1):.2f} s/iter)')
    return history


if __name__ == '__main__':
    main()
