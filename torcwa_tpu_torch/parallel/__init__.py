"""Parameter sweeps split over devices.

Counterpart of ``torcwa_tpu/parallel``.  The reference loops its sweeps in
Python (Example1 cell 2, Example3 cell 1).  In the port a sweep is a batch
dimension of one solve (``solve_stack_pair`` takes a batch of frequencies
and of rasters); these functions split that batch into equal contiguous
chunks, one for each device of a 1-D mesh, and gather the results.  The
solve needs no collectives: only the per-point results and the gradient
sum cross devices.
"""

from .sweep import sweep_mesh, shard_sweep, sweep_and_grad

__all__ = ['sweep_mesh', 'shard_sweep', 'sweep_and_grad']
