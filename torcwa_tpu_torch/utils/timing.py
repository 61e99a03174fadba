"""Per-stage timing breakdown for the solve pipeline.

Counterpart of ``torcwa_tpu/utils/timing.py``.  ``StageTimer`` stops its
clock only after the stage's device work is done (the caller synchronizes
inside the block, or :meth:`StageTimer.wrap` does), so its numbers are
device time; ``eig_stage_flops`` and ``mfu_report`` put each eig stage's
time beside a nominal FLOP model and a measured GEMM rate
(``measured_gemm_peak``).  For deeper traces use ``torch.profiler``.
"""

import time
from contextlib import contextmanager

import numpy as np
import torch
import torch.utils._pytree as pytree

from .._constants import complex_dtype_of, f32_pinned

__all__ = ['StageTimer', 'eig_stage_flops', 'measured_gemm_peak', 'mfu_report']


# --- FLOP model for the eig pipeline (the solve's cost driver) -------------
#
# Convention: one complex multiply-add = 8 real flops (4 mul + 4 add).
# Counts are the standard dense nominal models (LAPACK working notes /
# Golub-Van Loan), NOT the kernels' actual op counts: the MFU reported
# against them answers "how far from a speed-of-light dense method", which
# is the honest yardstick when the algorithm itself adapts (AED deflation
# and skipped chases change the actual work).
#
#   hess : zgehrd (10/3 n^3) + Q formation zunghr (4/3 n^3)
#   qr   : Hessenberg Schur QR with Schur-vector accumulation; nominal
#          ~10 n^3 complex madds (zhseqr with Z, LAWN 41 class estimate)
#   vec  : triangular eigenvector back-substitution (~n^3/6) + the
#          Z @ Y basis GEMM (n^3)
_CMADD = 8.0


def eig_stage_flops(n):
    """Nominal real-FLOP counts per eig stage for one n x n complex
    matrix (see module comment for the models)."""
    n3 = float(n) ** 3
    return {
        'hess': (10. / 3. + 4. / 3.) * n3 * _CMADD,
        'qr': 10. * n3 * _CMADD,
        'vec': (1. / 6. + 1.) * n3 * _CMADD,
    }


def measured_gemm_peak(n, reps=3, dtype=torch.float32, device='cuda'):
    """Measured complex-GEMM throughput (real TFLOP/s) at size n on
    ``device``: the calibration denominator for MFU lines.

    A chain of k complex products C <- A C / sqrt(2n) on complex tensors
    of the real precision ``dtype``, inside ``_constants.f32_pinned``
    (IEEE f32, never TF32: the eig kernels' setting), so 'peak' means what
    a GEMM-only algorithm could reach here.  On a CUDA device each run is
    timed with CUDA events, on the CPU with the host clock; the best of
    ``reps`` runs after one warm-up."""
    device = torch.device(device)
    cdt = complex_dtype_of(dtype)
    rng = np.random.default_rng(0)
    a, c0 = (torch.as_tensor(rng.standard_normal((n, n))
                             + 1j * rng.standard_normal((n, n)),
                             dtype=cdt, device=device) for _ in range(2))
    # amortize the launches over one chain of k products; entries of
    # variance 2 make each product scale C's by 2n, which the factor undoes
    # (no overflow, and no subnormals to slow a CPU)
    k = min(8192, max(4, int(2e12 / (_CMADD * float(n) ** 3))))
    scale = (2. * n) ** -0.5

    def chain():
        c = c0
        for _ in range(k):
            c = (a @ c) * scale
        return c

    cuda = device.type == 'cuda'
    best = float('inf')
    with f32_pinned():
        chain()
        if cuda:
            torch.cuda.synchronize(device)
        for _ in range(reps):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain()
                end.record()
                end.synchronize()
                secs = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                chain()
                secs = time.perf_counter() - t0
            best = min(best, secs)
    flops = _CMADD * float(n) ** 3 * k           # k complex GEMMs
    return flops / best / 1e12


def mfu_report(stage_times, n, gemm_peak_tflops):
    """Lines of 'stage: time, model TFLOP/s achieved, % of measured GEMM
    peak' for stages present in both stage_times and the flop model."""
    model = eig_stage_flops(n)
    lines = []
    for name, secs in stage_times.items():
        if name not in model or secs <= 0:
            continue
        tf = model[name] / secs / 1e12
        pct = 100. * tf / gemm_peak_tflops if gemm_peak_tflops else 0.
        lines.append(f'{name:5s} {secs:7.3f}s  {tf:6.2f} TFLOP/s '
                     f'(nominal)  {pct:5.1f}% of measured GEMM peak '
                     f'({gemm_peak_tflops:.1f})')
    return lines


def _sync_outputs(out):
    """Wait for the devices of every CUDA tensor among the outputs."""
    for d in {x.device for x in pytree.tree_leaves(out)
              if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates wall-clock per named stage, device-synchronized.

    Usage:
        t = StageTimer()
        with t('conv'):
            conv = build_conv(...)
            torch.cuda.synchronize()
        eig = t.wrap('eig', tp.eig)
        w, v = eig(A)
        print(t.report())
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextmanager
    def __call__(self, name):
        """Context manager; the caller must wait for the stage's device
        work inside the block (or use :meth:`wrap`): CUDA launches return
        before their kernels finish."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def wrap(self, name, fn):
        """Timed wrapper: synchronizes the device of every CUDA tensor
        among fn's outputs before stopping the clock, so the measurement
        is device time."""
        def timed(*args, **kwargs):
            with self(name):
                out = fn(*args, **kwargs)
                _sync_outputs(out)
            return out
        return timed

    def report(self):
        total = sum(self.totals.values()) or 1.0
        lines = ['stage              total_s   calls   share']
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f'{name:18s} {t:7.3f}  {self.counts[name]:6d}'
                         f'  {100 * t / total:5.1f}%')
        return '\n'.join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
