"""Checkpointing and data export for the port.

Counterpart of ``torcwa_tpu/utils``: ``save_state`` / ``load_state`` keep
an optimisation's state in one ``.npz`` file whose schema is the JAX
package's, so a file saved by either package loads in the other;
``save_mat`` / ``load_mat`` read and write MATLAB files as the reference's
notebooks do.
"""

from .checkpoint import save_state, load_state
from .export import save_mat, load_mat

__all__ = ['save_state', 'load_state', 'save_mat', 'load_mat']
