"""A shape optimisation loop as the reference's Example 5 runs it: the
width and height of an a-Si:H rectangle, FoM = |t_yy - t_xx| of the (0, 0)
transmission, ascended by ``optim.maximize_adam`` with the notebook's
schedule, clamp and sqrt(v_hat + eps).

Set-up builds the loop's state (W, m, v, step) from the seed and drives it
through its first ``traffic['setup_steps']`` steps by the window's own call
(``maximize_adam`` for one step, which reads the host once); the window
goes on from that same state.  A unit is one step.  The window keeps the
state before each of its steps (``adam_update`` makes new tensors, so this
is a reference, not a copy); after it, the record moves the state around
one of its steps, drawn from the seed, to the host for the comparison.
"""

import math

import numpy as np
import torch

import torcwa_tpu_torch as tp
from torcwa_tpu_torch.optim import maximize_adam

from rcwa_bench.inputs import adam_start, sample


def make_fom(cfg, device, spans):
    """FoM(W) through the port, W = (width, height) in nm."""
    o = tuple(cfg['order'])
    L = tuple(cfg['period_nm'])
    spec = tp.StackSpec(order=o, L=L, n_layers=1, has_input=True)
    si = tp.aSiH(device=device).eps(cfg['wavelength_nm']).to(
        torch.complex64)
    nx, ny = cfg['grid']
    g = tp.geometry(Lx=L[0], Ly=L[1], nx=nx, ny=ny,
                    edge_sharpness=float(cfg['edge_sharpness']),
                    dtype=torch.float32, device=device)
    inc, azi = math.radians(cfg['inc_deg']), math.radians(cfg['azi_deg'])
    sub = cfg['substrate_eps']

    def fom(W):
        with spans('solve'):
            W = W.to(torch.float32)
            occ = g.rectangle(W[0], W[1], L[0] / 2., L[1] / 2.)
            eps = occ * si + (1. - occ)
            S, intr = tp.solve_stack_pair(
                spec, 1. / cfg['wavelength_nm'], inc, azi, eps[None],
                [cfg['thickness_nm']], eps_in=sub)
            t = [tp.sparam_xy_pair(S, intr['kx'], intr['ky'], sub,
                                   cfg['superstrate_eps'], o, [0, 0],
                                   [0, 0], pol)[0] for pol in ('xx', 'yy')]
            return (t[1] - t[0]).abs()
    return fom


def loop_kwargs(cfg):
    a = cfg['adam']
    return dict(lr_schedule=lambda step: a['lr'] * (1. - step / a['steps']),
                beta1=a['beta1'], beta2=a['beta2'], eps=a['eps'],
                lower=a['lower_nm'], upper=a['upper_nm'],
                eps_in_sqrt=a['eps_in_sqrt'])


class Run:
    def __init__(self, cfg, traffic, seed, device, spans):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.spans = device, spans
        self.W0 = adam_start(traffic, seed)
        self.first = []         # (fom, W, m, v) after each set-up step
        self.foms = []          # the window's FoMs
        self.before = []        # the state before each window step

    def setup(self):
        self.fom = make_fom(self.cfg, self.device, self.spans)
        W = torch.as_tensor(self.W0, device=self.device)
        self.state = (W, torch.zeros_like(W), torch.zeros_like(W), 0)
        for _ in range(int(self.traffic['setup_steps'])):
            f = self._step()
            W, m, v, _ = self.state
            self.first.append((f, W.cpu().numpy(), m.cpu().numpy(),
                               v.cpu().numpy()))

    def _step(self):
        W, m, v, step = self.state
        W, (m, v, step), hist = maximize_adam(
            self.fom, W, 1, state=(W, m, v, step), **loop_kwargs(self.cfg))
        self.state = (W, m, v, step)
        return hist[0][0]

    def unit(self):
        self.before.append(self.state)
        self.foms.append(self._step())
        return 1

    def end_to_end(self, units, t0, ends):
        if not ends:
            return {}
        return {'iter_s': (ends[-1] - t0) / sum(units)}

    def counts(self):
        f = np.asarray(self.foms, np.float64)
        return int(f.size), int((~np.isfinite(f)).sum())

    def record(self):
        window = None
        if self.foms:
            k, = sample(self.seed, len(self.foms), 1)
            after = (self.before[k + 1] if k + 1 < len(self.before)
                     else self.state)
            window = {'before': _host(self.before[k]), 'fom': self.foms[k],
                      'after': _host(after)}
        return {'seed': self.seed, 'W0': self.W0, 'steps': self.first,
                'window': window}

    def release(self):
        self.fom = self.state = None
        self.before = []


def _host(state):
    W, m, v, step = state
    return (W.cpu().numpy(), m.cpu().numpy(), v.cpu().numpy(), int(step))
