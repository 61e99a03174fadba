"""torcwa_tpu_torch: the PyTorch/CUDA port of torcwa_tpu.

The main path (an Example-1 wavelength sweep, forward and gradient) runs
on complex tensors, with the layer eigendecomposition in hand-written CUDA
kernels for Hopper (``ops/eig_kernels.py``, sources in ``csrc/``).  On a
CPU tensor each kernel wrapper uses its plain PyTorch version.

Importing the package sets no global state; every entry point pins IEEE
float32 matmuls (no TF32) when it runs.
"""

from .geometry import geometry, rcwa_geo
from .ops.eig import Eig, eig
from .fmm import (StackSpec, kvectors_real, pq_pair, solve_stack_pair,
                  redheffer_pair, sparam_xy_pair, simulate_txx)

__version__ = '0.1.0'
__all__ = ['geometry', 'rcwa_geo', 'Eig', 'eig', 'StackSpec',
           'kvectors_real', 'pq_pair', 'solve_stack_pair', 'redheffer_pair',
           'sparam_xy_pair', 'simulate_txx', '__version__']
