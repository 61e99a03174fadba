"""Carry the JAX package's numpy inputs across to the port's tensors.

The JAX package takes complex values as split-real (re, im) pairs; the
port takes native complex tensors.  :func:`from_jax_pairs` turns the same
numpy inputs into the port's arguments so that both packages compute the
same thing.  It reads ``StackSpec`` by its fields and imports nothing of
JAX.  The tensors land on ``device``: the CUDA card unless the caller passes
``device='cpu'``.
"""

import numpy as np
import torch

from .fmm import StackSpec

__all__ = ['from_jax_pairs', 'to_complex']


def to_complex(re, im=None, device='cuda'):
    """numpy (re, im) -> complex tensor (complex64 for float32 parts,
    complex128 otherwise)."""
    re = np.asarray(re)
    im = np.zeros_like(re) if im is None else np.asarray(im)
    cdt = np.complex64 if re.dtype == np.float32 else np.complex128
    return torch.as_tensor((re + 1j * im).astype(cdt), device=device)


def from_jax_pairs(eps_grids=None, thicknesses=None, eps_in=None,
                   eps_out=None, spec=None, device='cuda'):
    """Convert JAX-package inputs; only the given ones appear in the result.

    Args:
      eps_grids: (re, im) pair of [n_layers, nx, ny] rasters.
      thicknesses: [n_layers] real.
      eps_in, eps_out: (re, im) pairs of scalars.
      spec: the JAX package's ``StackSpec`` (or anything with its fields).

    Returns a dict with the same keys, holding the port's values.
    """
    out = {}
    if eps_grids is not None:
        out['eps_grids'] = to_complex(*eps_grids, device=device)
    if thicknesses is not None:
        out['thicknesses'] = torch.as_tensor(np.asarray(thicknesses),
                                             device=device)
    for key, val in (('eps_in', eps_in), ('eps_out', eps_out)):
        if val is not None:
            out[key] = to_complex(*val, device=device)
    if spec is not None:
        out['spec'] = StackSpec(order=tuple(int(o) for o in spec.order),
                                L=tuple(float(x) for x in spec.L),
                                n_layers=int(spec.n_layers),
                                has_input=bool(spec.has_input),
                                has_output=bool(spec.has_output),
                                homogeneous=tuple(spec.homogeneous))
    return out
