"""The yardstick's fixed numbers: published peaks of one NVIDIA H100 SXM and
the nominal work of the eig stages.

Peaks are NVIDIA's data sheet (dense, no sparsity, at the 700 W limit):
67 TFLOP/s float32 outside the tensor cores and 3.35 TB/s of HBM3.  The
kernels run IEEE float32 (TF32 off), so that is their compute peak.

``eig_stage_flops`` is a frozen copy of the port's nominal model
(``torcwa_tpu_torch/utils/timing.py``): counts that depend on n alone, the
dense LAPACK-class estimates, whatever implements the stage.
"""

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# one complex multiply-add in real flops (4 mul + 4 add)
CMADD = 8.0
# bytes of one complex64 entry
C64_BYTES = 8


def eig_stage_flops(n):
    """Nominal real flops of each eig stage for one n x n complex matrix:
    Hessenberg reduction with Q (10/3 + 4/3) n^3, Schur QR with Z 10 n^3,
    triangular vectors and the Z Y product (1/6 + 1) n^3 complex
    multiply-adds."""
    n3 = float(n) ** 3
    return {'hess': (10. / 3. + 4. / 3.) * n3 * CMADD,
            'qr': 10. * n3 * CMADD,
            'vec': (1. / 6. + 1.) * n3 * CMADD}


def schur_least_seconds(n, batch):
    """The least time of the Schur stage on ``batch`` matrices of order n:
    the larger of its nominal work at the float32 peak and its compulsory
    bytes (H and Q read, T and Z written, complex64) at the HBM peak."""
    flops = batch * eig_stage_flops(n)['qr']
    nbytes = batch * 4 * n * n * C64_BYTES
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
