"""Forward wavelength sweeps of a one-layer meta-atom, as the port's users
write them (the reference's Example 1): the permittivity of the dispersive
material on the batch of wavelengths, one raster a wavelength, one batched
``solve_stack_pair`` and ``sparam_xy_pair`` per batch.

A unit is one batch of ``traffic['batch']`` wavelengths, ended by a host
read of its |t|; its answers are the complex t_xx(0, 0) of each wavelength.
"""

import math

import numpy as np
import torch

import torcwa_tpu_torch as tp

from rcwa_bench.inputs import Sweep


class MetaAtom:
    """The port's calls for a configuration's one patterned layer on its
    substrate, at the traffic's order and incidence."""

    def __init__(self, cfg, traffic, device):
        o = int(traffic['order'])
        self.order = (o, o)
        self.L = tuple(cfg['period_nm'])
        self.spec = tp.StackSpec(order=self.order, L=self.L, n_layers=1,
                                 has_input=True)
        self.cfg = cfg
        self.inc = math.radians(traffic.get('inc_deg', cfg['inc_deg']))
        self.azi = math.radians(cfg['azi_deg'])
        self.material = tp.aSiH(device=device)
        nx, ny = cfg['grid']
        g = tp.geometry(Lx=self.L[0], Ly=self.L[1], nx=nx, ny=ny,
                        edge_sharpness=float(cfg['edge_sharpness']),
                        dtype=torch.float32, device=device)
        wx, wy = cfg['rectangle_nm']
        self.occupancy = g.rectangle(wx, wy, self.L[0] / 2., self.L[1] / 2.)
        self.device = device

    def t_xx(self, freqs, occupancy):
        """t_xx(0, 0) of each frequency, (B,) complex64."""
        freqs = torch.as_tensor(freqs, device=self.device)
        eps_si = self.material.eps(1.0 / freqs).to(torch.complex64)
        eps = occupancy * eps_si[:, None, None] + (1. - occupancy)
        sub = self.cfg['substrate_eps']
        S, intr = tp.solve_stack_pair(
            self.spec, freqs, self.inc, self.azi, eps[:, None],
            [self.cfg['thickness_nm']], eps_in=sub)
        return tp.sparam_xy_pair(S, intr['kx'], intr['ky'], sub,
                                 self.cfg['superstrate_eps'], self.order,
                                 [0, 0], [0, 0], 'xx')[..., 0]


class Run:
    def __init__(self, cfg, traffic, seed, device, spans):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.spans = device, spans
        self.sweep = Sweep(cfg, traffic, seed)
        self.freqs, self.t = [], []
        self.missing = 0

    def setup(self):
        self.atom = MetaAtom(self.cfg, self.traffic, self.device)
        # the warm-up: batch 0, the cell's own shapes; the window starts
        # at batch 1
        self._batch(0)
        self.j = 1

    def _batch(self, j):
        f = self.sweep.freqs(j)
        with self.spans('solve'):
            t = self.atom.t_xx(f, self.atom.occupancy)
        return f, t.cpu().numpy()

    def unit(self):
        f, t = self._batch(self.j)
        self.j += 1
        # an answer that never came reads NaN and counts as missing
        self.missing += len(f) - len(t)
        self.freqs.append(f)
        self.t.append(np.concatenate(
            [t, np.full(len(f) - len(t), np.nan, np.complex64)]))
        return len(f)

    def end_to_end(self, units, t0, ends):
        if not ends:
            return {}
        return {'solves_per_s': sum(units) / (ends[-1] - t0)}

    def counts(self):
        t = np.concatenate(self.t) if self.t else np.zeros(0)
        return int(t.size), int((~np.isfinite(t)).sum())

    def record(self):
        return {'seed': self.seed, 'missing': self.missing,
                'freqs': np.concatenate(self.freqs) if self.freqs
                else np.zeros(0, np.float32),
                't': np.concatenate(self.t) if self.t
                else np.zeros(0, np.complex64)}

    def release(self):
        self.atom = None
