"""
Build and load the CUDA kernels of dedalus_tpu_torch.

Each source in this directory is compiled with nvcc for sm_90a into its own
shared library with a plain C interface, under build/kernels/ at the root of
the checkout (git-ignored), at first use, and loaded with ctypes. The nvcc
processes of all sources run at once. A library's name carries a hash of its
source and the flags, so an edited source is rebuilt and a stale library is
never loaded.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
import types

CSRC = pathlib.Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# Exported launchers of each source (by file stem) and their argument types
SIGNATURES = {
    'banded_kernels': {
        'k5_block_tridiag_qr_solve_f32': [_P] * 7 + [_I] * 5 + [_P],
        'k5_block_tridiag_qr_solve_f64': [_P] * 7 + [_I] * 5 + [_P],
        'k4_banded_apply_f64': [_P, _P, _I] + [_P] * 13 + [_I] * 13 + [_P],
        'k4_banded_apply_general_f64': [_P, _P, _I] + [_P] * 9 + [_I] * 7 + [_P],
        'k4_geometry': [_P, _I],
        'k8_block_tridiag_qr_factor_f64': [_P] * 16 + [_I] * 3 + [_D, _P],
        'k8_multi_rhs_solve_f64': [_P] * 7 + [_I] * 6 + [_P],
        'k6_solve_pre_f64': [_P] * 4 + [_I] * 4 + [_P],
        'k6_solve_post_f64': [_P] * 8 + [_I, _P] + [_I] * 7 + [_P, _P],
    },
    'dense_kernels': {
        'ka_dense_refined_solve_f64': [_P] * 4 + [_I] * 3 + [_P],
        'ka_dense_refined_solve_c128': [_P] * 4 + [_I] * 3 + [_P],
        'kb_dense_matvec_f64': [_P] * 5 + [_I] * 4 + [_P],
        'kb_dense_matvec_c128': [_P] * 5 + [_I] * 4 + [_P],
        'kb_dense_matvec_f32': [_P] * 3 + [_I] * 3 + [_P],
        'k14a_lu_solve_f64': [_P] * 4 + [_I] * 2 + [_P],
        'k14a_lu_solve_c128': [_P] * 4 + [_I] * 2 + [_P],
        'k14b_mixed_solve_f64': [_P] * 4 + [_I] * 2 + [_P],
        'k14b_mixed_solve_cluster_f64': [_P] * 4 + [_I] * 6 + [_P],
    },
    'separable_kernels': {
        'k14c_separable_apply_f64': [_P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _P] + [_I] * 3
                                    + [_P],
        'k14c_override_f64': [_P] * 4 + [_I] * 2 + [_P],
    },
    'polar_kernels': {
        'ke_polar_apply_f64': [_P] * 3 + [_I] * 14 + [_P],
        'ke_geometry': [_P, _I],
        'ke_trailing_apply_f64': [_P] * 4 + [_I] * 13 + [_P],
        'kt_geometry': [_P, _I],
    },
    'cfl_kernels': {
        'kd_cfl_max_f64': [_P, _P],
        'kd_geometry': [_P, _I],
    },
    'ball_kernels': {
        'kh_ball_radial_apply_f64': [_P] * 4 + [_I] * 8 + [_P] + [_I] * 7 + [_P],
        'kh_ball_radial_apply_c128': [_P] * 4 + [_I] * 8 + [_P] + [_I] * 7 + [_P],
        'kh_geometry': [_P, _I],
        'kh_ball_radial_rot_apply_f64': [_P] * 6 + [_I] * 16 + [_P],
        'kh_ball_radial_rot_apply_c128': [_P] * 6 + [_I] * 16 + [_P],
    },
    'shell_kernels': {
        'kj_shell_radial_f64': [_P] * 5 + [_I] * 3 + [_P],
        'kj_shell_radial_c128': [_P] * 5 + [_I] * 3 + [_P],
    },
    'fft_kernels': {
        'k10_fft_c128': [_P] * 8 + [_D, _P],
        'k11_dct2_pre_f64': [_P] * 2 + [_I] * 4 + [_P],
        'k11_dct2_post_f64': [_P] * 5 + [_I] * 4 + [_P],
        'k11_dct3_pre_f64': [_P] * 5 + [_I] * 5 + [_P],
        'k11_dct3_post_f64': [_P] * 2 + [_I] * 4 + [_P],
        'k12_fourier_pack_f64': [_P] * 4 + [_I] * 6 + [_D] * 2 + [_P],
        'k12_fourier_unpack_f64': [_P] * 2 + [_I] * 5 + [_D] * 2 + [_I, _P],
    },
    'regularity_kernels': {
        'ki_regularity_recombine_f64': [_P] * 3 + [_I] * 8 + [_P],
        'ki_geometry': [_P, _I],
    },
    'spin_kernels': {
        'kf_spin_recombine': [_P, _P],
    },
    'conversion_kernels': {
        'k11_conversion_apply_f64': [_P, _P, _I, _P, _P] + [_I] * 4 + [_P],
        'k11_conversion_solve_f64': [_P, _I, _P, _P] + [_I] * 4 + [_P],
        'k11_geometry': [_P, _I],
    },
    'rhs_kernels': {
        'k2a_geometry': [_P, _I],
        'k2a_stage_f64': [_P, _I, _P] + [_I] * 6 + [_P],
        'k2a_stage_c128': [_P, _I, _P] + [_I] * 6 + [_P],
    },
    'pencil_kernels': {
        'k3_pencil_gather_f64': [_P, _I, _P, _I, _I] + [_P] * 5 + [_I] * 2 + [_P],
        'k3_pencil_gather_c128': [_P, _I, _P, _I, _I] + [_P] * 5 + [_I] * 2 + [_P],
        'k3_pencil_scatter_f64': [_P] * 3 + [_I] + [_P] * 3 + [_I, _P, _P],
        'k3_pencil_scatter_c128': [_P] * 3 + [_I] + [_P] * 3 + [_I, _P, _P],
    },
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


def _library_path(src):
    h = hashlib.sha1(src.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{src.stem}_{h.hexdigest()[:16]}.so'


def library():
    """The launchers of every kernel source, as attributes of one namespace
    (the sources are built on first call, in parallel)."""
    global _library, build_seconds
    if _library is not None:
        return _library
    t0 = time.perf_counter()
    paths = {stem: _library_path(CSRC / f'{stem}.cu') for stem in SIGNATURES}
    procs = {}
    try:
        for stem, path in paths.items():
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f'.{os.getpid()}.tmp')
                cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{stem}.cu')]
                procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True), tmp)
        errors = []
        for stem, (proc, tmp) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{stem}.cu ({proc.returncode}):\n{err}")
            else:
                tmp.replace(paths[stem])
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    fns = {}
    for stem, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    build_seconds = time.perf_counter() - t0
    _library = types.SimpleNamespace(**fns)
    return _library


# The name suffix of a kernel's instantiation for each element type (torch
# dtype names: this module imports no torch)
SUFFIX = {'torch.float64': 'f64', 'torch.complex128': 'c128'}


def launcher(name, dtype):
    """The launcher `name`_f64 or `name`_c128 for tensors of `dtype`."""
    return getattr(library(), f"{name}_{SUFFIX[str(dtype)]}")


# The forms of a kernel counted apart from its float64 launches, by the
# suffix of their count (`launches_<suffix>`) and of their kernel's name in
# chip_smoke.py: complex128 data, KE's signed (m, +-) stacks, and the
# general paths of K4, K5 and K11b past their tile kernels' sizes
FORMS = {'torch.complex128': 'c128', 'signed': 'signed', 'general': 'general'}


def counter(form):
    """The attribute that counts a wrapper's launches in `form`: a dtype,
    'signed', or a form's suffix ('c128', 'signed'). A counted form's
    launches go in `launches_<suffix>`, every other form's in `launches`."""
    form = str(form)
    suffix = FORMS.get(form, form if form in FORMS.values() else None)
    return f'launches_{suffix}' if suffix else 'launches'


# The launches counted while a CUDA graph is captured: {(wrapper, count
# attribute): launches per replay}, or None outside a capture
_capturing = None


def count(wrapper, form=None):
    """Add one launch of `wrapper`'s kernel in `form` (as in counter) to its
    count. Inside a capture (`Capture`) the launch is recorded instead: it
    counts once per replay of the graph."""
    attr = counter(form)
    if _capturing is not None:
        key = (wrapper, attr)
        _capturing[key] = _capturing.get(key, 0) + 1
        return
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


class Capture:
    """Around a CUDA graph's capture: the wrappers' launches recorded during
    it (`launches`), which `replayed` adds to their counts once per replay."""

    def __enter__(self):
        global _capturing
        if _capturing is not None:
            raise RuntimeError("nested launch-count capture")
        self.launches = _capturing = {}
        return self

    def __exit__(self, *exc):
        global _capturing
        _capturing = None
        return False

    def replayed(self, times=1):
        for (wrapper, attr), n in self.launches.items():
            setattr(wrapper, attr, getattr(wrapper, attr) + n * times)

    @property
    def total(self):
        """Kernel launches of this repository per replay."""
        return sum(self.launches.values())


def reset(wrapper):
    """Set every launch count that `wrapper` keeps to 0."""
    for attr in ['launches'] + [f'launches_{suffix}' for suffix in FORMS.values()]:
        if hasattr(wrapper, attr):
            setattr(wrapper, attr, 0)


_geometry_checked = set()


def check_geometry(name, expected):
    """Raise unless the library's `name` getter reports `expected`: the
    constants of a kernel source that a host plan restates (checked once)."""
    if name in _geometry_checked:
        return
    out = (ctypes.c_int * len(expected))()
    check(getattr(library(), name)(out, len(expected)), name)
    if tuple(out) != tuple(expected):
        raise RuntimeError(f"{name}: the kernel source gives {tuple(out)}, the host plan "
                           f"is built for {tuple(expected)}")
    _geometry_checked.add(name)


def check(status, name):
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
