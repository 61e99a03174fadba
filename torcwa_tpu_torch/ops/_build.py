"""Build and load the hand-written CUDA kernels (nvcc -> shared library).

The sources under ``torcwa_tpu_torch/csrc`` expose a plain C interface and
are compiled once per source hash, every source by its own nvcc, all
started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu

and linked with ``nvcc -shared`` into
``build/torch_kernels/<hash>/libtorcwa_kernels.so`` beside the package,
then loaded with ctypes.
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

from ..utils import timing

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_ROOT = _PKG.parent / 'build' / 'torch_kernels'
LIB_NAME = 'libtorcwa_kernels.so'

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)   # host ints: a lane table, a count out
# C entry points: name -> argtypes.  Each returns cudaGetLastError().
_SIGNATURES = {
    'torcwa_hessenberg_c64': [_P, _P, _P, _I, _I, _P],
    'torcwa_hessenberg_cluster_info': [_I, _P],
    'torcwa_hess_panel_c64': [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    'torcwa_hess_panel_info': [_I, _I, _P],
    'torcwa_schur_qr_c64': [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    'torcwa_schur_qr_v2_c64': [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    'torcwa_schur_qr_ms_c64': [_P, _P, _P, _I, _I, _I, _P],
    'torcwa_schur_qr_ms_cluster_info': [_I, _I, _P],
    'torcwa_schur_qr_baed_c64': [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    'torcwa_schur_qr_baed_cluster_info': [_I, _I, _I, _P],
    'torcwa_schur_qr_packed_f32': [_P, _P, _P, _I, _I, _I, _I, _P],
    'torcwa_tri_vectors_c64': [_P, _P, _P, _P, _I, _I, _P],
    'torcwa_tri_vectors_slots': [_I],
    'torcwa_tri_vectors_block_c64': [_P, _P, _P, _P, _I, _I, _I, _P],
    'torcwa_ms_band_scan_c64': [_P, _I, _IP, _I, _F, _P, _IP, _P],
    'torcwa_ms_aed_c64': [_P, _I, _P, _IP, _I, _I, _I, _F, _P, _P, _IP, _P],
    'torcwa_ms_trailing_shifts_c64': [_P, _I, _P, _IP, _I, _I, _P, _IP, _P],
    'torcwa_ms_chase_c64': [_P, _I, _P, _L, _IP, _I, _I, _P, _P, _IP, _P],
    'torcwa_ms_apply_slabs_c64': [_P, _I, _P, _I, _I, _I, _P, _L, _IP, _I,
                                  _IP, _P],
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
    nvcc = _nvcc()
    flags = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
             '-Xcompiler', '-fPIC']
    srcs = sorted(CSRC.glob('*.cu'))
    objs = [out_dir / f'{p.stem}.{os.getpid()}.o' for p in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *flags, '-Xptxas', '-v', '-c', '-o',
                               str(o), str(p)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p, o in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    for proc, p, log in zip(procs, srcs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}) on {p.name}:\n'
                               f'{log}')
    cmd = [nvcc, *flags, '-shared', '-o', str(tmp)] + [str(o) for o in objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f'nvcc link failed ({res.returncode}):\n'
                           f'{" ".join(cmd)}\n{res.stdout}\n{res.stderr}')
    for o in objs:
        o.unlink()
    os.replace(tmp, lib_path)
    build_info.update(path=str(lib_path), seconds=secs, cached=False,
                      log=''.join(logs) + res.stdout + res.stderr)
    return lib_path


def load():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        with timing.span('kernels.load') as sp:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            if sp is not None:
                sp.meta['cached'] = build_info['cached']
        _lib = lib
    return _lib
