"""Build and load the hand-written CUDA kernels (nvcc -> shared library).

The sources under ``torcwa_tpu_torch/csrc`` expose a plain C interface and
are compiled once per source hash with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<hash>/libtorcwa_kernels.so \
         torcwa_tpu_torch/csrc/*.cu

into ``build/torch_kernels`` beside the package, then loaded with ctypes.
Nothing is compiled at import: the first wrapper that launches a kernel
calls :func:`load`.  A CUDA host without nvcc raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_ROOT = _PKG.parent / 'build' / 'torch_kernels'
LIB_NAME = 'libtorcwa_kernels.so'

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes.  Each returns cudaGetLastError().
_SIGNATURES = {
    'torcwa_hessenberg_c64': [_P, _P, _P, _I, _I, _P],
    'torcwa_schur_qr_c64': [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    'torcwa_tri_vectors_c64': [_P, _P, _I, _I, _P],
}

_lib = None
build_info = {}


def sources():
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


def source_hash():
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    nvcc = shutil.which('nvcc')
    if nvcc is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        nvcc = '/usr/local/cuda/bin/nvcc'
    if nvcc is None:
        raise RuntimeError('nvcc not found: the CUDA kernels of '
                           'torcwa_tpu_torch must be built on a CUDA host '
                           'with the CUDA toolkit installed')
    return nvcc


def build():
    """Compile the kernels if this source hash has no library yet.
    Returns the library path."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        if not build_info:
            build_info.update(path=str(lib_path), seconds=0.0, cached=True,
                              log='')
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f'{LIB_NAME}.{os.getpid()}.tmp'
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
           '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
           '-Xptxas', '-v', '-o', str(tmp)]
    cmd += [str(p) for p in sorted(CSRC.glob('*.cu'))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n'
                           f'{" ".join(cmd)}\n{res.stdout}\n{res.stderr}')
    os.replace(tmp, lib_path)
    build_info.update(path=str(lib_path), seconds=secs, cached=False,
                      log=res.stdout + res.stderr)
    return lib_path


def load():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
