"""torcwa_tpu_torch: the PyTorch/CUDA port of torcwa_tpu.

The reference-compatible class API (``rcwa``: patterned, homogeneous and
magnetic layers, the Pinv fallback, xy and ps S-parameters, sources and
fields), the dispersive materials (``materials``: ``TabulatedMaterial``,
``aSiH``) and the functional main path (an Example-1 wavelength sweep,
forward and gradient, through ``solve_stack_pair``) run on complex
tensors, with the layer eigendecomposition in hand-written CUDA kernels
for Hopper (``ops/eig_kernels.py``, sources in ``csrc/``).  On a CPU tensor
each kernel wrapper uses its plain PyTorch version.

Importing the package sets no global state, and neither does a solve:
every entry point (``rcwa``'s methods, ``solve_stack_pair``,
``simulate_txx``, ``eig``) runs its forward and its backward inside
``_constants.f32_pinned``, which turns TF32 off for cuBLAS matmuls and
cuDNN and sets the float32 matmul precision to 'highest', then restores
the caller's settings.
"""

from .geometry import geometry, rcwa_geo
from .ops.eig import Eig, eig
from .fmm import (StackSpec, kvectors_real, pq_pair, solve_stack_pair,
                  redheffer_pair, sparam_xy_pair, simulate_txx)
from . import materials
from .materials import TabulatedMaterial, aSiH
from .solver import rcwa

__version__ = '0.1.0'
__all__ = ['geometry', 'rcwa_geo', 'Eig', 'eig', 'StackSpec',
           'kvectors_real', 'pq_pair', 'solve_stack_pair', 'redheffer_pair',
           'sparam_xy_pair', 'simulate_txx', 'materials', 'TabulatedMaterial',
           'aSiH', 'rcwa', '__version__']
