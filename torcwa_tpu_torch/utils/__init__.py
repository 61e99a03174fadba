"""Profiling, checkpointing and data export for the port.

Counterpart of ``torcwa_tpu/utils``: ``StageTimer`` and ``eig_stage_flops``
time the solve's stages against a nominal FLOP model; ``timing.tracing``
turns on the spans and counters the port's layers open (``timing.span``);
``save_state`` / ``load_state`` keep an optimisation's state in one
``.npz`` file whose schema is the JAX package's, so a file saved by either
package loads in the other; ``save_mat`` / ``load_mat`` read and write
MATLAB files as the reference's notebooks do.
"""

from . import timing
from .timing import StageTimer, eig_stage_flops
from .checkpoint import save_state, load_state
from .export import save_mat, load_mat

__all__ = ['timing', 'StageTimer', 'eig_stage_flops', 'save_state',
           'load_state', 'save_mat', 'load_mat']
