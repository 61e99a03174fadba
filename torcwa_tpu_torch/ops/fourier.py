"""Fourier factorization: material raster -> block-Toeplitz convolution matrix.

Counterpart of ``order_vectors`` and ``material_conv`` in
``torcwa_tpu/ops/fourier.py`` (Laurent rule, the upstream torcwa's fft2 +
order-difference gather).  The gather indices are taken modulo the grid
size, which equals the upstream negative-index wrapping as long as
``2 * max_order < n``.  The JAX package's DFT-matmul form exists because
gathers were slow on the TPU and is not carried over.
"""

import numpy as np
import torch

from .._constants import complex_dtype_of

__all__ = ['order_vectors', 'material_conv']


def order_vectors(order):
    """Flattened Fourier-order index vectors: ox slowest, oy fastest."""
    ox1 = np.arange(-order[0], order[0] + 1)
    oy1 = np.arange(-order[1], order[1] + 1)
    ox, oy = np.meshgrid(ox1, oy1, indexing='ij')
    return ox.reshape(-1), oy.reshape(-1)


def material_conv(grid, order, dtype=None):
    """Convolution matrix of a material raster.

    Args:
      grid: [..., nx, ny] real or complex tensor.
      order: (order_x, order_y).
      dtype: complex result dtype (default: from the grid's precision).

    Returns [..., N, N] complex, N = (2 order_x + 1)(2 order_y + 1).
    """
    nx, ny = grid.shape[-2:]
    if dtype is None:
        dtype = (grid.dtype if grid.is_complex()
                 else complex_dtype_of(grid.dtype))
    ox, oy = order_vectors(order)
    rows = torch.as_tensor(np.mod(ox[:, None] - ox[None, :], nx),
                           device=grid.device)
    cols = torch.as_tensor(np.mod(oy[:, None] - oy[None, :], ny),
                           device=grid.device)
    fft = torch.fft.fft2(grid.to(dtype)) / (nx * ny)
    return fft[..., rows, cols]
