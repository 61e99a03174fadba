"""The comparison of a forward sweep (``drivers/sweep.py``) with the plain
reference.

The complex t_xx(0, 0) of a sample of the window's answers, drawn from the
seed, against the reference's at the same wavelengths; the numbers compared
are the widest gap |t - t_ref| and the count of answers due in the window
that never came (limit 0).

The configuration's own reference module (``reference/<config>.py``:
``occupancy`` and ``t_xx``) makes the raster, the material and the solve
from the same inputs (the frequencies the program got); the program's
answers are read only to judge them.  ``control`` puts the reference,
computed with TF32 products, in the program's place.
"""

import math

import numpy as np
import torch

from rcwa_bench.inputs import Sweep, sample
from rcwa_bench.reference import rcwa_ref as R


def reference_t(ref, cfg, traffic, freqs, prec, device):
    """t_xx(0, 0) at the frequencies, in blocks of ``ref_block``."""
    lam = 1.0 / np.asarray(freqs, np.float64)
    occ = ref.occupancy(cfg, prec, device)
    out = []
    with torch.no_grad():
        for i in range(0, len(lam), traffic['ref_block']):
            out.append(ref.t_xx(cfg, traffic, prec, occ,
                                lam[i:i + traffic['ref_block']],
                                device).cpu())
    return torch.cat(out).numpy()


def readings(record, ref, cfg, traffic, device):
    idx = sample(record['seed'], len(record['t']), traffic['check_sample'])
    if not idx:
        return {'txx_gap': math.inf, 'missing': math.inf}
    t_ref = reference_t(ref, cfg, traffic, record['freqs'][idx],
                        R.Precision('exact'), device)
    return {'txx_gap': float(np.max(np.abs(
        record['t'][idx].astype(np.complex128) - t_ref))),
        'missing': float(record['missing'])}


def control(record, ref, cfg, traffic, device):
    """The record with the sampled answers computed by the reference with
    TF32 products (complex64) in the program's place."""
    idx = sample(record['seed'], len(record['t']), traffic['check_sample'])
    t = record['t'].copy()
    t[idx] = reference_t(ref, cfg, traffic, record['freqs'][idx],
                         R.Precision('tf32'), device)
    return dict(record, t=t)


def control_record(cfg, traffic, seed, answers):
    """A record with a run's inputs and no program answers: the window's
    first batches, covering ``answers`` answers."""
    sweep = Sweep(cfg, traffic, seed)
    nb = max(1, -(-answers // sweep.batch))
    f = np.concatenate([sweep.freqs(j) for j in range(1, nb + 1)])
    return {'seed': seed, 'freqs': f, 'missing': 0,
            't': np.full(f.shape, np.nan, np.complex64)}
