"""Optimisation-state checkpoint and resume.

Counterpart of ``torcwa_tpu/utils/checkpoint.py``, with the same ``.npz``
schema: a nested dict, list or tuple of tensors, arrays and scalars (the
density, the ADAM moments, the step, the history) flattens to one key per
leaf, joined by '/'.  Container nodes carry markers so that empty
containers round-trip: list and tuple nodes store ``__kind__`` ('L' or
'T') and ``__len__``, dict nodes ``__kind__`` = 'D'.  Dict keys that hold
the separator '/' are refused.
"""

import numpy as np
import torch

__all__ = ['save_state', 'load_state']

_SEP = '/'


def _flatten(tree, prefix=''):
    out = {}
    if isinstance(tree, dict):
        out[f'{prefix}__kind__'] = np.asarray('D')
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(
                    f'dict key {k!r} contains the reserved separator {_SEP!r}')
            out.update(_flatten(v, f'{prefix}{k}{_SEP}'))
    elif isinstance(tree, (list, tuple)):
        out[f'{prefix}__kind__'] = np.asarray(
            'T' if isinstance(tree, tuple) else 'L')
        out[f'{prefix}__len__'] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            out.update(_flatten(v, f'{prefix}{i}{_SEP}'))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def save_state(path, state):
    """Save a nested dict / list / tuple of tensors, arrays and scalars to
    an .npz file."""
    np.savez(path, **_flatten(state))


def load_state(path, device='cuda'):
    """Load what :func:`save_state` (of either package) saved; every leaf
    comes back as a tensor on ``device``, the CUDA card unless the caller
    asks for the CPU (``None`` means the card too)."""
    device = torch.device('cuda' if device is None else device)
    data = dict(np.load(path, allow_pickle=False))

    def build(prefix):
        leaf_key = prefix.rstrip(_SEP)
        if leaf_key in data:
            return torch.as_tensor(data[leaf_key], device=device)
        kind_key = f'{prefix}__kind__'
        len_key = f'{prefix}__len__'
        children = [k for k in data
                    if k.startswith(prefix) and k not in (kind_key, len_key)]
        direct = {k[len(prefix):].split(_SEP)[0] for k in children}
        direct -= {'__kind__', '__len__'}
        kind = str(data[kind_key]) if kind_key in data else 'D'
        if kind in ('L', 'T'):
            if len_key in data:
                n = int(data[len_key])
            else:
                # files without a length marker: the largest index + 1
                n = max((int(d) + 1 for d in direct), default=0)
            items = [build(f'{prefix}{i}{_SEP}') for i in range(n)]
            return tuple(items) if kind == 'T' else items
        return {k: build(f'{prefix}{k}{_SEP}') for k in sorted(direct)}

    return build('')
