"""Inputs made from the seed, the same for the program, the reference and
the control: the sweeps' wavelengths and the ADAM loop's start.

Every seed gives the same sizes and the same amount of work: the seed moves
the sweeps' wavelengths by a fraction of their spacing, and where the loop
starts.  Seeds may
be any whole number up to 2**63: numpy's generators take them whole.
"""

import math

import numpy as np

__all__ = ['Sweep', 'adam_start', 'sample']


class Sweep:
    """The configuration's wavelengths as a ring, run ``batch`` at a time.
    The ring is walked from the first wavelength in steps of
    ``traffic['stride']`` places (coprime to its length), so that any run of
    batches spreads over the band and every seed runs the same wavelengths
    in the same order; each pass through the ring shifts them by its own
    offset in ``traffic['offset_nm']``, drawn from the seed."""

    def __init__(self, cfg, traffic, seed):
        w = cfg['wavelengths_nm']
        self.base = np.linspace(w['from'], w['to'], w['count'])
        self.batch = int(traffic['batch'])
        self.stride = int(traffic.get('stride', 1))
        if math.gcd(self.stride, len(self.base)) != 1:
            raise ValueError('the stride must be coprime to the number of '
                             'wavelengths')
        self.offset = traffic['offset_nm']
        self.seed = int(seed)
        self._offsets = {}

    def _pass_offset(self, k):
        if k not in self._offsets:
            lo, hi = self.offset
            self._offsets[k] = float(np.random.default_rng(
                [self.seed, 1, k]).uniform(lo, hi))
        return self._offsets[k]

    def wavelengths(self, j):
        """Batch j's wavelengths (nm), float64."""
        n = len(self.base)
        p = j * self.batch + np.arange(self.batch)
        return np.array([self.base[(q * self.stride) % n]
                         + self._pass_offset(q // n) for q in p])

    def freqs(self, j):
        """Batch j's frequencies 1/lambda as the program gets them,
        float32."""
        return (1.0 / self.wavelengths(j)).astype(np.float32)


def adam_start(traffic, seed):
    """The loop's starting (width, height) in nm, float32, uniform in
    ``traffic['start_nm']`` per coordinate."""
    lo, hi = traffic['start_nm']
    return np.random.default_rng([int(seed), 2]).uniform(
        lo, hi, 2).astype(np.float32)


def sample(seed, population, k):
    """k indices of range(population) drawn from the seed, sorted."""
    k = min(int(k), population)
    return sorted(np.random.default_rng([int(seed), 3]).choice(
        population, size=k, replace=False).tolist())
