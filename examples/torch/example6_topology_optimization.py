"""Example 6 on the PyTorch port: topology optimization that maximizes
first-order diffraction (the reference's example/Example6.ipynb, exact
configuration; twin of examples/example6_topology_optimization.py).

700 x 300 nm cell, a-Si:H at 532 nm, 300 nm thick on glass, order (15, 8)
(2N = 1054), grid 700 x 300: FoM = the sum over the four polarizations of
|t(1, 0)|^2, 800 ADAM iterations with the notebook's cosine learning rate
(0.02 -> 0), its exponential binarization schedule (beta -> 1000), a 20 nm
Gaussian blur, y-mirror symmetrization, the density clamped to [0, 1].
float32, the eig through the port's CUDA kernels (one matrix at n = 1054:
the large route, hessenberg_blocked -> schur_ms -> tri_vectors_blocked).

The density starts from torch's generator seeded with 333: the same
distribution as the notebook's and the JAX twin's, each a stream of its
own, so the trajectories are not bitwise comparable; the converged FoM is
the target.  The blur is the twin's separable pair of circulant matrices
(the notebook's periodic convolution, as two matrix products).

    python3 examples/torch/example6_topology_optimization.py

Environment knobs:
  EX6_ITERS   iterations to run (default 10; 800 is the notebook's run)
  EX6_CKPT    checkpoint file (default example6_state.npz), saved every 25
              iterations and at the last; an existing one is resumed
  EX6_ORDER   Fourier order, 'ox,oy' (default '15,8')
  EX6_GRID    raster, 'nx,ny' (default '700,300')
  EX6_DEVICE  'cuda' (default) or 'cpu'
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

import numpy as np
import torch

import torcwa_tpu_torch as tp
from torcwa_tpu_torch._constants import f32_pinned
from torcwa_tpu_torch.optim import maximize_adam
from torcwa_tpu_torch.utils import load_state, save_state

LAMB0 = 532.
L = (700., 300.)
THICK = 300.
SUB_EPS = 1.46 ** 2
BLUR_RADIUS = 20.
ORDER = (15, 8)
GRID = (700, 300)
ITER_MAX = 800          # the length of the notebook's schedules
SEED = 333


def _pair(name, default):
    return tuple(int(v) for v in os.environ.get(name, default).split(','))


def config():
    """The run's settings from the environment."""
    return dict(iters=int(os.environ.get('EX6_ITERS', '10')),
                ckpt=os.environ.get('EX6_CKPT', 'example6_state.npz'),
                order=_pair('EX6_ORDER', '%d,%d' % ORDER),
                grid=_pair('EX6_GRID', '%d,%d' % GRID),
                device=os.environ.get('EX6_DEVICE', 'cuda'))


def symmetrize(rho, step):
    """The y-mirror symmetrization after each update."""
    return (rho + torch.flip(rho, (1,))) / 2.


def loop_kwargs():
    """maximize_adam's settings: the notebook's cosine learning rate
    (0.02 -> 0) and exponential binarization beta (1 -> 1000) over 800
    iterations, the density clamped to [0, 1], sqrt(v_hat + eps), the
    y-mirror symmetrization after each update."""
    it = np.arange(ITER_MAX)
    lr = 0.02 * 0.5 * (1. + np.cos(it * np.pi / ITER_MAX))
    beta = np.exp(it * np.log(1000.) / ITER_MAX)
    return dict(lr_schedule=lambda step: float(lr[step]),
                fom_args_schedule=lambda step: (float(beta[step]),),
                lower=0., upper=1., eps_in_sqrt=True, post_update=symmetrize)


def blur_matrices(grid, device, dtype=torch.float32):
    """Separable circulant factors of the notebook's periodic Gaussian blur
    (Example6.ipynb cell 2): blur(rho) = Bx @ rho @ By^T is the circular
    convolution with the centered kernel exp(-(x^2 + y^2) / r^2) / sum."""
    def circ(n, d):
        x = (np.arange(n) - (n - 1) / 2) * d
        gx = np.exp(-x ** 2 / BLUR_RADIUS ** 2)
        gx /= gx.sum()
        k = np.fft.ifftshift(gx)
        idx = (np.arange(n)[:, None] - np.arange(n)[None, :]) % n
        return torch.as_tensor(k[idx], dtype=dtype, device=device)
    return circ(grid[0], L[0] / grid[0]), circ(grid[1], L[1] / grid[1])


def initial_params(grid, device, dtype=torch.float32):
    """Uniform noise from torch's generator seeded with 333, mirrored in y
    and blurred (Example6.ipynb cell 2)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    rho = torch.rand(grid, generator=gen, device=device, dtype=dtype)
    BX, BY = blur_matrices(grid, device, dtype)
    with f32_pinned():
        return BX @ ((rho + torch.flip(rho, (1,))) / 2.) @ BY.T


def make_layer(order=ORDER, grid=GRID, device='cuda',
               dtype=torch.float32):
    """(spec, eps_of): the stack, and (rho, beta) -> the blurred, projected
    density's permittivity raster (Example6.ipynb cells 1-2).  ``dtype``
    is the real precision of the raster and the solve."""
    spec = tp.StackSpec(order=tuple(order), L=L, n_layers=1, has_input=True)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    si = tp.aSiH(device=device).eps(LAMB0).to(cdt)
    BX, BY = blur_matrices(grid, device, dtype)

    def eps_of(rho, beta):
        rho_bar = BX @ rho.to(dtype) @ BY.T
        rho_tilda = 0.5 + torch.tanh(2. * beta * rho_bar - beta) / (
            2. * np.tanh(beta))
        return rho_tilda * si + (1. - rho_tilda)

    return spec, eps_of


def make_fom(order=ORDER, grid=GRID, device='cuda',
             dtype=torch.float32, eig_backend='kernels', inc_deg=0.,
             azi_deg=0.):
    """FoM(rho, beta): the sum over the four polarizations of |t(1, 0)|^2
    (Example6.ipynb cells 1-2); ``inc_deg`` and ``azi_deg`` tilt the
    incidence (toward +x at 10 degrees the (1, 0) order turns evanescent
    in air: kx = 1.46 sin 10 deg + 532 / 700 = 1.014)."""
    spec, eps_of = make_layer(order, grid, device, dtype)
    inc, azi = float(np.deg2rad(inc_deg)), float(np.deg2rad(azi_deg))

    def fom(rho, beta):
        S, intr = tp.solve_stack_pair(
            spec, 1. / LAMB0, inc, azi, eps_of(rho, beta)[None], [THICK],
            eps_in=SUB_EPS, eig_backend=eig_backend)
        total = 0.
        for pol in ('xx', 'yy', 'xy', 'yx'):
            t = tp.sparam_xy_pair(S, intr['kx'], intr['ky'], SUB_EPS, 1.,
                                  spec.order, [1, 0], [0, 0], pol)[0]
            total = total + t.real ** 2 + t.imag ** 2
        return total

    return fom


def main():
    cfg = config()
    dev = torch.device(cfg['device'])
    fom = make_fom(cfg['order'], cfg['grid'], dev)
    if os.path.exists(cfg['ckpt']):
        st = load_state(cfg['ckpt'], device=dev)
        state = (st['rho'].float(), st['m'].float(), st['v'].float(),
                 int(st['step']))
        history = [float(h) for h in st['history'].tolist()]
        print(f'resumed from {cfg["ckpt"]} at iteration {state[3]}')
    else:
        rho = initial_params(cfg['grid'], dev)
        state = (rho, torch.zeros_like(rho), torch.zeros_like(rho), 0)
        history = []
    it0 = state[3]

    def callback(rec):
        history.append(rec.fom)
        print(f'Iteration: {rec.step - 1} / FoM: {rec.fom:.4f} / '
              f'Elapsed time: {rec.elapsed_s:.0f} s', flush=True)
        if rec.step % 25 == 0 or rec.step == cfg['iters']:
            m, v, step = rec.opt_state
            save_state(cfg['ckpt'], {'rho': rec.params, 'm': m, 'v': v,
                                     'step': step,
                                     'history': np.asarray(history)})

    t0 = time.time()
    n_it = max(cfg['iters'] - it0, 0)
    maximize_adam(fom, state[0], n_it, callback=callback, state=state,
                  **loop_kwargs())
    if history:
        print(f'final FoM {history[-1]:.4f}  '
              f'({(time.time() - t0) / max(n_it, 1):.2f} s/iter)')
    return history


if __name__ == '__main__':
    main()
