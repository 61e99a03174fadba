"""torcwa_tpu_torch: the PyTorch/CUDA port of torcwa_tpu.

The main path (an Example-1 wavelength sweep, forward and gradient) runs
on complex tensors, with the layer eigendecomposition in hand-written CUDA
kernels for Hopper (``ops/eig_kernels.py``, sources in ``csrc/``).  On a
CPU tensor each kernel wrapper uses its plain PyTorch version.

Importing the package sets no global state.  The first solve does: every
entry point pins IEEE float32 (``_constants.pin_f32_precision``: TF32 off
for cuBLAS matmuls and cuDNN, float32 matmul precision 'highest') for the
rest of the process and never restores the earlier setting, so other code
in the same process that wants TF32 must turn it back on after a solve.
"""

from .geometry import geometry, rcwa_geo
from .ops.eig import Eig, eig
from .fmm import (StackSpec, kvectors_real, pq_pair, solve_stack_pair,
                  redheffer_pair, sparam_xy_pair, simulate_txx)

__version__ = '0.1.0'
__all__ = ['geometry', 'rcwa_geo', 'Eig', 'eig', 'StackSpec',
           'kvectors_real', 'pq_pair', 'solve_stack_pair', 'redheffer_pair',
           'sparam_xy_pair', 'simulate_txx', '__version__']
