"""MATLAB .mat export and import, as the reference's notebooks persist
their sweeps and optimisations (``scipy.io.savemat``).  Counterpart of
``torcwa_tpu/utils/export.py``; scipy is imported only when called."""

import numpy as np
import torch

__all__ = ['save_mat', 'load_mat']


def save_mat(path, data):
    """Save a dict of tensors, arrays or scalars to a MATLAB .mat file."""
    import scipy.io
    scipy.io.savemat(path, {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v) for k, v in data.items()})


def load_mat(path):
    """The dict of numpy arrays in a MATLAB .mat file."""
    import scipy.io
    return scipy.io.loadmat(path)
