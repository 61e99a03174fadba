"""Broadband design gradients of a one-layer meta-atom (the adjoint pattern
of the reference's Example 4, over Example 1's band): per batch of
wavelengths the loss mean |t_xx(0, 0)|^2 and its gradient with respect to
the occupancy raster, through the port's forward and backward.

A unit is one batch, ended by a host read of the loss and the gradient's
norm; its answers are the batch's loss and gradient raster.
"""

import numpy as np
import torch

from rcwa_bench.drivers import sweep
from rcwa_bench.inputs import Sweep, sample


class Run:
    def __init__(self, cfg, traffic, seed, device, spans):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.spans = device, spans
        self.sweep = Sweep(cfg, traffic, seed)
        self.batches = []

    def setup(self):
        self.atom = sweep.MetaAtom(self.cfg, self.traffic, self.device)
        self._batch(0)
        self.j = 1

    def _batch(self, j):
        f = self.sweep.freqs(j)
        occ = self.atom.occupancy.detach().requires_grad_(True)
        with self.spans('solve'):
            t = self.atom.t_xx(f, occ)
            loss = (t.real ** 2 + t.imag ** 2).mean()
        with self.spans('backward'):
            grad, = torch.autograd.grad(loss, occ)
        read = torch.stack([loss.detach(), grad.norm()]).cpu().numpy()
        return f, float(read[0]), grad

    def unit(self):
        f, loss, grad = self._batch(self.j)
        self.j += 1
        self.batches.append((f, loss, grad))
        return len(f)

    end_to_end = sweep.Run.end_to_end

    def counts(self):
        bad = sum(len(f) for f, loss, g in self.batches
                  if not np.isfinite(loss))
        return sum(len(f) for f, _, _ in self.batches), bad

    def record(self):
        """The batches' answers; the gradients of the seed's sample of
        batches are moved to the host, the rest dropped."""
        keep = sample(self.seed, len(self.batches),
                      self.traffic['check_sample'])
        return {'seed': self.seed,
                'batches': [(f, loss, g.cpu().numpy() if i in keep else None)
                            for i, (f, loss, g) in enumerate(self.batches)],
                'sample': keep}

    def release(self):
        self.atom = None
        self.batches = [(f, l, None) for f, l, _ in self.batches]
