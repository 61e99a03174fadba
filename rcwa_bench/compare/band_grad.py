"""The comparison of broadband design gradients (``drivers/band_grad.py``)
with the plain reference.

A sample of the window's batches, drawn from the seed: the loss (the
batch's mean |t_xx(0, 0)|^2) against the reference's, relative, and the
gradient raster's ||g - g_ref|| / ||g_ref||, the worst batch of each.  The
configuration's own reference module (``reference/<config>.py``:
``occupancy`` and ``t_xx``) makes the raster and the solve; ``control``
puts the reference, computed with TF32 products, in the program's place.
"""

import math

import numpy as np

from rcwa_bench.inputs import Sweep, sample
from rcwa_bench.reference import rcwa_ref as R


def reference_loss_grad(ref, cfg, traffic, freqs, prec, device):
    """mean |t_xx|^2 over the batch and its gradient w.r.t. the occupancy
    raster, accumulated block by block."""
    lam = 1.0 / np.asarray(freqs, np.float64)
    occ = ref.occupancy(cfg, prec, device).requires_grad_(True)
    loss = 0.
    for i in range(0, len(lam), traffic['ref_block']):
        t = ref.t_xx(cfg, traffic, prec, occ,
                     lam[i:i + traffic['ref_block']], device)
        part = (t.real ** 2 + t.imag ** 2).sum() / len(lam)
        part.backward()
        loss += float(part.detach())
    return loss, occ.grad.cpu().numpy()


def readings(record, ref, cfg, traffic, device):
    exact = R.Precision('exact')
    loss_gap = grad_gap = math.inf if not record['sample'] else 0.
    for i in record['sample']:
        f, loss, g = record['batches'][i]
        loss_r, g_r = reference_loss_grad(ref, cfg, traffic, f, exact,
                                          device)
        loss_gap = max(loss_gap, abs(loss - loss_r) / abs(loss_r))
        grad_gap = max(grad_gap, float(
            np.linalg.norm(g.astype(np.float64) - g_r) / np.linalg.norm(g_r)))
    return {'loss_gap': loss_gap, 'grad_gap': grad_gap}


def control(record, ref, cfg, traffic, device):
    """The record with the sampled batches computed by the reference with
    TF32 products (complex64) in the program's place."""
    batches = list(record['batches'])
    for i in record['sample']:
        f = batches[i][0]
        loss, g = reference_loss_grad(ref, cfg, traffic, f,
                                      R.Precision('tf32'), device)
        batches[i] = (f, loss, g)
    return dict(record, batches=batches)


def control_record(cfg, traffic, seed, answers):
    """A record with a run's inputs and no program answers: the window's
    first batches, covering ``answers`` answers, and the seed's sample."""
    sweep = Sweep(cfg, traffic, seed)
    nb = max(1, -(-answers // sweep.batch))
    return {'seed': seed,
            'batches': [(sweep.freqs(j), np.nan, None)
                        for j in range(1, nb + 1)],
            'sample': sample(seed, nb, traffic['check_sample'])}
