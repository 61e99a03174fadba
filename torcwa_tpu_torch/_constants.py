"""Physical constants, dtype policy and the f32 precision pin.

Counterpart of ``torcwa_tpu/_constants.py``.  Units follow the upstream
torcwa: Lorentz-Heaviside, c = eps0 = mu0 = 1, time-harmonic exp(-j w t).

``PI_REF`` keeps the upstream torcwa's dropped digit (3.141592652589793
instead of 3.14159265358979...) on purpose, so that float64 runs agree
with the reference and with the JAX package bit for bit in omega.
"""

import warnings

import torch

PI_REF = 3.141592652589793
PI = 3.14159265358979323846
RAD2DEG = 180.0 / PI_REF


def validate_sim_dtype(dtype):
    """complex64 or complex128; anything else warns and falls back to
    complex64 (upstream torcwa semantics)."""
    if dtype is None:
        return torch.complex64
    if dtype not in (torch.complex64, torch.complex128):
        warnings.warn('Invalid simulation data type. Set as complex64.',
                      UserWarning)
        return torch.complex64
    return dtype


def real_dtype_of(cdtype):
    return torch.float32 if cdtype == torch.complex64 else torch.float64


def complex_dtype_of(rdtype):
    return torch.complex64 if rdtype == torch.float32 else torch.complex128


def pin_f32_precision():
    """Full IEEE f32 in every matmul and convolution.

    TF32 keeps ~10 mantissa bits: reduced-precision products stall QR
    deflation and corrupt eigenvectors, and the repeated inverses of the
    S-matrix algebra amplify the error.  Every entry point calls this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def f32_precision_pinned():
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == 'highest')
