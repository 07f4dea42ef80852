"""The Rayleigh-Benard main path of the PyTorch port against dedalus_tpu
with `[transforms] fourier_library = jacobi_library = fast` in both
packages: RBC 64x32 (Ra=1e5, SBDF2, banded, 10 steps) within
1e-11 * max(1, max|ref|), the bound of tests/test_torch_rbc.py, and the
port's fast run against its own MMT run to the same bound. Both packages'
configs are restored by the fixture (tests/test_torch_curvilinear_fast.py
holds the annulus and the shell under `fast`)."""

import numpy as np
import pytest
import torch

from dedalus_tpu.utils.config import config as jconfig
from dedalus_tpu_torch.utils.config import config as tconfig
from dedalus_tpu_torch.ops import fft as F

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

NX, NZ, RA, DT, STEPS = 64, 32, 1e5, 1e-3, 10
KEYS = ('fourier_library', 'jacobi_library')
# The kernel wrappers of ops/fft.py (their plain twins on the CPU)
WRAPPERS = ('dft', 'dct2_pre', 'dct2_post', 'dct3_pre', 'dct3_post', 'fourier_pack',
            'fourier_unpack', 'conversion_apply', 'conversion_solve')


def _set_libraries(value):
    for cfg in (jconfig, tconfig):
        for k in KEYS:
            cfg.set('transforms', k, value)


@pytest.fixture(scope='module')
def trajectories():
    """The RBC 64x32 runs: JAX fast, port fast, port matrix (the port's
    refinement counts read with the JAX package's rule, as
    tests/test_torch_rbc.py)."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    from dedalus_tpu_torch.models.rbc import initial_condition
    saved = {k: (jconfig.get('transforms', k), tconfig.get('transforms', k)) for k in KEYS}
    saved_rule = tconfig.get('linear algebra', 'refinement_rule')
    tconfig.set('linear algebra', 'refinement_rule', 'reference')
    out = {}
    try:
        for library in ('fast', 'matrix'):
            _set_libraries(library)
            tp, tctx = tbuild(NX, NZ, Rayleigh=RA, device='cpu')
            ts = tp.build_solver(td3.SBDF2, matsolver='banded')
            initial_condition(tctx, seed=42)
            calls = {}
            originals = {name: getattr(F, name) for name in WRAPPERS}
            for name, fn in originals.items():
                setattr(F, name, lambda *a, _f=fn, _n=name, **kw:
                        calls.__setitem__(_n, calls.get(_n, 0) + 1) or _f(*a, **kw))
            try:
                ts.run_steps(DT, STEPS)
            finally:
                for name, fn in originals.items():
                    setattr(F, name, fn)
            out[library] = ts.state_flat().numpy()
            out[library + '_calls'] = calls
        _set_libraries('fast')
        jp, jctx = jbuild(NX, NZ, Rayleigh=RA)
        js = jp.build_solver(jd3.SBDF2, matsolver='banded')
        b = jctx['b']
        z = jctx['dist'].local_grid(jctx['zbasis'], scale=1)
        Lz = jctx['Lz']
        b.fill_random('g', seed=42, distribution='normal', scale=1e-3)
        b['g'] = np.array(b['g']) * z * (Lz - z) + (Lz - z)
        js.run_steps(DT, STEPS)
        out['jax'] = np.asarray(js.state_flat())
    finally:
        for k, (j, t) in saved.items():
            jconfig.set('transforms', k, j)
            tconfig.set('transforms', k, t)
        tconfig.set('linear algebra', 'refinement_rule', saved_rule)
    return out


def test_rbc_fast_matches_jax_fast(trajectories):
    ref, got = trajectories['jax'], trajectories['fast']
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err < 1e-11 * max(1, np.abs(ref).max()), err


def test_rbc_fast_matches_mmt(trajectories):
    ref, got = trajectories['matrix'], trajectories['fast']
    err = np.abs(got - ref).max()
    assert err < 1e-11 * max(1, np.abs(ref).max()), err


def test_rbc_fast_run_took_the_fast_path(trajectories):
    """The fast run called every kernel wrapper of ops/fft.py (the plain
    twins here), the MMT run none."""
    assert sorted(trajectories['fast_calls']) == sorted(WRAPPERS)
    assert trajectories['matrix_calls'] == {}
