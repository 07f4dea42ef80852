"""
Build and load the CUDA kernels of dedalus_tpu_torch.

The sources in this directory are compiled with nvcc for sm_90a into a
shared library with a plain C interface, under build/kernels/ at the root of
the checkout (git-ignored), at first use, and loaded with ctypes. The
library name carries a hash of the sources, so an edited source is rebuilt
and a stale library is never loaded.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
SIGNATURES = {
    'k5_block_tridiag_qr_solve_f32': [_P] * 7 + [_I] * 3 + [_P],
    'k5_block_tridiag_qr_solve_f64': [_P] * 7 + [_I] * 3 + [_P],
    'k4_banded_apply_f64': [_P] * 9 + [_I] * 8 + [_U] * 4 + [_P],
}

_library = None
build_seconds = None


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    cand = pathlib.Path(home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library():
    """The loaded kernel library (built on first call)."""
    global _library, build_seconds
    if _library is not None:
        return _library
    sources = sorted(CSRC.glob('*.cu'))
    h = hashlib.sha1()
    for src in sources:
        h.update(src.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f'libdedalus_tpu_torch_{h.hexdigest()[:16]}.so'
    t0 = time.perf_counter()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        tmp.replace(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
    _library = lib
    return lib


def check(status, name):
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
