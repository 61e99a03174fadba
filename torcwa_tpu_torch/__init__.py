"""torcwa_tpu_torch: the PyTorch/CUDA port of torcwa_tpu.

The reference-compatible class API (``rcwa``: patterned, homogeneous and
magnetic layers, the Pinv fallback, xy and ps S-parameters, sources and
fields), the dispersive materials (``materials``: ``TabulatedMaterial``,
``aSiH``), the functional solve (``solve_stack_pair`` with every option of
the JAX package's, the S-parameters, sources and diagnostics, and the
fields through ``fields.fmm_field_adapter``), the optimisation loop
(``optim``) and checkpointing and export (``utils``) run on complex
tensors, with the layer eigendecomposition in hand-written CUDA kernels
for Hopper (``ops/eig_kernels.py``, sources in ``csrc/``).  On a CPU tensor
each kernel wrapper uses its plain PyTorch version.

Importing the package sets no global state, and neither does a solve:
every entry point (``rcwa``'s methods, ``solve_stack_pair``,
``simulate_txx``, ``eig``, each iteration of ``maximize_adam``) runs its
forward and its backward inside ``_constants.f32_pinned``, which turns
TF32 off for cuBLAS matmuls and cuDNN and sets the float32 matmul
precision to 'highest', then restores the caller's settings.
"""

from .geometry import geometry, rcwa_geo
from .ops.eig import Eig, eig
from .fmm import (StackSpec, kvectors_real, pq_pair, layer_smatrix_pair,
                  solve_stack_pair, redheffer_pair, sparam_xy_pair,
                  sparam_ps_pair, source_fourier_pair, source_planewave_pair,
                  diffraction_angle_pair, return_layer_pair, simulate_txx)
from . import fields, materials, optim, utils
from .fields import fmm_field_adapter
from .materials import TabulatedMaterial, aSiH
from .optim import maximize_adam
from .solver import rcwa

__version__ = '0.1.0'
__all__ = ['geometry', 'rcwa_geo', 'Eig', 'eig', 'StackSpec',
           'kvectors_real', 'pq_pair', 'layer_smatrix_pair',
           'solve_stack_pair', 'redheffer_pair', 'sparam_xy_pair',
           'sparam_ps_pair', 'source_fourier_pair', 'source_planewave_pair',
           'diffraction_angle_pair', 'return_layer_pair', 'simulate_txx',
           'fields', 'fmm_field_adapter', 'materials', 'TabulatedMaterial',
           'aSiH', 'optim', 'maximize_adam', 'utils', 'rcwa', '__version__']
