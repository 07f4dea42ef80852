"""The fast transforms of the PyTorch port (dedalus_tpu_torch/ops/fft.py and
the fast paths of core/basis.py, the plain twins of kernels K10, K11a, K11b
and K12 on the CPU) against the JAX package's (dedalus_tpu/ops/fft64.py,
ops/transforms.py and core/basis.py), on the same numpy-seeded inputs.

The cases and tolerances are those of tests/test_fast_transforms.py: the
DFT, rfft and irfft and DCT-II at 1e-13 and DCT-III at 2e-13 (relative to
the largest reference value); the conversion apply and solve at 1e-12; the
Chebyshev fast plans forward at 1e-13 and backward at max(1e-13, 100 M^2
1e-16) (the backward plan uses exact angles where MMT evaluates polynomials
at rounded grid points: an O(M^2 eps) endpoint difference), each against
the JAX fast plan and against the port's own MMT; the real Fourier fast
plans at 1e-13; and the plan each package picks under `[transforms]
fourier_library` / `jacobi_library` = auto, matrix and fast. Both packages'
configs are set and restored by a fixture (the JAX package's is one global
ConfigParser that later test files in the same worker read).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp

from dedalus_tpu.core import basis as JB
from dedalus_tpu.core.coords import Coordinate as JCoordinate
from dedalus_tpu.ops import fft64
from dedalus_tpu.ops import transforms as JT
from dedalus_tpu.utils.config import config as jconfig
from dedalus_tpu_torch.core import basis as TB
from dedalus_tpu_torch.core.coords import Coordinate as TCoordinate
from dedalus_tpu_torch.ops import fft as F
from dedalus_tpu_torch.ops import transforms as TT
from dedalus_tpu_torch.utils.config import config as tconfig

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

SIZES = [32, 64, 100, 128, 256]
SCALES = [1, 1.5, 0.75, 2 / 3]
KEYS = ('fourier_library', 'jacobi_library')


def relerr(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture
def libraries():
    """set(value) puts both transform libraries of both packages to value;
    the old settings come back after the test."""
    old = {k: (jconfig.get('transforms', k), tconfig.get('transforms', k)) for k in KEYS}

    def set_(value):
        for k in KEYS:
            jconfig.set('transforms', k, value)
            tconfig.set('transforms', k, value)

    yield set_
    for k, (j, t) in old.items():
        jconfig.set('transforms', k, j)
        tconfig.set('transforms', k, t)


def _jit(fn, *static):
    """The JAX reference compiled once per shape (a jitted call compiles in
    a fraction of the time its eager op-by-op form takes at a new shape)."""
    return jax.jit(fn, static_argnums=static)


JAX_REAL_FORWARD = _jit(JT.real_fft_forward, 1, 2, 3)
JAX_REAL_BACKWARD = _jit(JT.real_fft_backward, 1, 2, 3)
FFT64 = {name: _jit(getattr(fft64, name), 1) for name in ('fft64', 'ifft64', 'rfft64', 'dct2_64',
                                                          'dct3_64')}
IRFFT64 = _jit(fft64.irfft64, 1, 2)


def _coords():
    jc, tc = JCoordinate('x'), TCoordinate('x')
    jc.axis = tc.axis = 0
    return jc, tc


def _pair(maker, M, bounds):
    jc, tc = _coords()
    return getattr(JB, maker)(jc, M, bounds), getattr(TB, maker)(tc, M, bounds)


# ---------------------------------------------------------------------------
# The primitives (K10, K11a, K11b, K12 plain twins) against fft64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('N', [16, 33, 97, 100, 512, 2048])
def test_dft_matches_fft64(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    assert relerr(F.fft(torch.tensor(x)), FFT64['fft64'](x, -1)) < 1e-13
    assert relerr(F.ifft(torch.tensor(x)), FFT64['ifft64'](x, -1)) < 1e-13
    assert relerr(F.fft(torch.tensor(x)), np.fft.fft(x)) < 1e-13


@pytest.mark.parametrize('N', [16, 33, 97, 100, 512, 2048])
def test_real_dft_matches_fft64(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal(N)
    assert relerr(F.rfft(torch.tensor(x)), FFT64['rfft64'](x, -1)) < 1e-13
    c = np.fft.rfft(x)
    assert relerr(F.irfft(torch.tensor(c), N), IRFFT64(c, N, -1)) < 1e-13
    assert relerr(F.irfft(torch.tensor(c), N), x) < 1e-13


@pytest.mark.parametrize('N', [16, 33, 100, 512, 2048])
def test_dct_matches_fft64(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal(N)
    assert relerr(F.dct2(torch.tensor(x)), FFT64['dct2_64'](x, -1)) < 1e-13
    assert relerr(F.dct3(torch.tensor(x)), FFT64['dct3_64'](x, -1)) < 2e-13


def test_primitives_along_every_axis():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 64, 3))
    xt = torch.tensor(x)
    assert relerr(F.fft(xt + 0j, axis=1), FFT64['fft64'](x + 0j, 1)) < 1e-13
    assert relerr(F.rfft(xt, axis=0), FFT64['rfft64'](x, 0)) < 1e-13
    assert relerr(F.dct2(xt, axis=2), FFT64['dct2_64'](x, 2)) < 1e-13
    assert relerr(F.dct3(xt, axis=1), FFT64['dct3_64'](x, 1)) < 2e-13
    c = np.fft.rfft(x, axis=1)
    assert relerr(F.irfft(torch.tensor(c), 64, axis=1), IRFFT64(c, 64, 1)) < 1e-13


def test_dft_loads_and_stores():
    """K10's packed and real loads and its real store equal the complex DFT
    of the same lines (the kernel's modes, held by its twin)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 96, 5))
    xt = torch.tensor(x)
    z = x[:, 0::2] + 1j * x[:, 1::2]
    assert relerr(F.dft(xt, -1, 1, load='packed'), np.fft.fft(z, axis=1)) < 1e-13
    assert relerr(F.dft(xt, -1, 1, load='real'), np.fft.fft(x, axis=1)) < 1e-13
    y = F.dft(torch.tensor(z), +1, 1, scale=0.5, real_out=True)
    assert y.dtype == torch.float64
    assert relerr(y, 0.5 * (np.fft.ifft(z, axis=1) * 48).real) < 1e-13


def _conversion_band(M, rng):
    U = sp.diags([np.full(M, 2.0), 0.3 * rng.standard_normal(M - 2),
                  0.1 * rng.standard_normal(M - 4)], [0, 2, 4], format='csr')
    diags = [np.r_[U.diagonal(o), np.zeros(o)] for o in (0, 2, 4)]
    return U, diags, [0, 2, 4]


def test_conversion_solve_matches_blocked_upper_solve():
    rng = np.random.default_rng(1)
    M = 200
    U, diags, offsets = _conversion_band(M, rng)
    b = rng.standard_normal((4, M))
    ref = fft64.blocked_upper_solve(fft64.build_blocked_upper_solve(U, nb=32), b, axis=-1)
    got = F.conversion_solve(F.ConversionBand(diags, offsets), torch.tensor(b), -1)
    assert relerr(got, ref) < 1e-12
    assert relerr(got, sp.linalg.spsolve(sp.csc_matrix(U), b.T).T) < 1e-12
    # along a leading axis, on the first 200 of 230 points
    b3 = rng.standard_normal((230, 3))
    ref = fft64.blocked_upper_solve(fft64.build_blocked_upper_solve(U, nb=32), b3[:M], axis=0)
    got = F.conversion_solve(F.ConversionBand(diags, offsets), torch.tensor(b3), 0)
    assert relerr(got, ref) < 1e-12


def test_conversion_apply_matches_banded_shift_matmul():
    rng = np.random.default_rng(2)
    M = 150
    _, diags, offsets = _conversion_band(M, rng)
    x = rng.standard_normal((M, 4))
    ref = fft64.banded_shift_matmul(diags, offsets, x, axis=0)
    got = F.conversion_apply(F.ConversionBand(diags, offsets), torch.tensor(x), 0)
    assert relerr(got, ref) < 1e-12


@pytest.mark.parametrize('N', [12, 15, 16, 33, 96])
@pytest.mark.parametrize('M', [2, 31, 64])
def test_real_fourier_pack_unpack_match_jax(N, M):
    """K12 with K10 around it: real_fft_forward / backward at every parity
    of N, coarse grids (N//2 + 1 below the modes: padding) and fine ones."""
    rng = np.random.default_rng(N * 1000 + M)
    Kmax = min((N - 1) // 2, (M - 1) // 2)
    g = rng.standard_normal((2, N, 3))
    ref = JAX_REAL_FORWARD(jnp.asarray(g), 1, M, Kmax)
    assert relerr(TT.real_fft_forward(torch.tensor(g), 1, M, Kmax), ref) < 1e-13
    c = rng.standard_normal((3, M - M % 2))
    ref = JAX_REAL_BACKWARD(jnp.asarray(c), 1, N, Kmax)
    assert relerr(TT.real_fft_backward(torch.tensor(c), 1, N, Kmax), ref) < 1e-13


def test_resize_axis_matches_jax():
    x = np.arange(24.0).reshape(2, 4, 3)
    for n in (2, 4, 7):
        assert relerr(TT.resize_axis(torch.tensor(x), n, 1), JT.resize_axis(jnp.asarray(x), n, 1)) == 0


# ---------------------------------------------------------------------------
# Basis-level fast plans
# ---------------------------------------------------------------------------

CHEBYSHEV = ('ChebyshevT', 'ChebyshevU', 'ChebyshevV')
_JAX_CHEBYSHEV = {}


def _chebyshev_inputs(M, N):
    rng = np.random.default_rng(M)
    return rng.standard_normal((2, N)), rng.standard_normal((M, 2))


def _jax_chebyshev(M, scale):
    """The JAX fast plans of the three Chebyshev bases at (M, scale), one
    compiled program for all six transforms: {maker: (forward, backward)}."""
    if (M, scale) not in _JAX_CHEBYSHEV:
        jc, _ = _coords()
        bases = [getattr(JB, maker)(jc, M, (-1, 3)) for maker in CHEBYSHEV]
        N = bases[0].grid_size(scale)
        g, c = _chebyshev_inputs(M, N)
        run = jax.jit(lambda g, c: [(b._fast_forward(g, 1, N, np.float64),
                                     b._fast_backward(c, 0, N, np.float64)) for b in bases])
        _JAX_CHEBYSHEV[M, scale] = dict(zip(CHEBYSHEV, run(jnp.asarray(g), jnp.asarray(c))))
    return _JAX_CHEBYSHEV[M, scale]


@pytest.mark.parametrize('maker', CHEBYSHEV)
@pytest.mark.parametrize('M', SIZES)
@pytest.mark.parametrize('scale', SCALES)
def test_fast_chebyshev_matches_jax_and_mmt(maker, M, scale):
    jb, tb = _pair(maker, M, (-1, 3))
    assert tb._fast_da == jb._fast_da is not None
    N = tb.grid_size(scale)
    g, c = _chebyshev_inputs(M, N)
    ref_f, ref_b = _jax_chebyshev(M, scale)[maker]
    got = tb._fast_forward(torch.tensor(g), 1, N)
    assert relerr(got, ref_f) < 1e-13
    assert relerr(got, g @ tb.forward_matrix(scale, np.float64).T) < 1e-13
    tol = max(1e-13, 100 * M**2 * 1e-16)
    got = tb._fast_backward(torch.tensor(c), 0, N)
    assert relerr(got, ref_b) < 1e-13
    assert relerr(got, tb.backward_matrix(scale, np.float64) @ c) < tol


@pytest.mark.parametrize('maker', ['ChebyshevT', 'ChebyshevU'])
@pytest.mark.parametrize('M', [64, 256])
def test_fast_chebyshev_roundtrip(maker, M):
    rng = np.random.default_rng(M)
    _, tb = _pair(maker, M, (-1, 1))
    c = torch.tensor(rng.standard_normal(M))
    assert relerr(tb._fast_forward(tb._fast_backward(c, 0, M), 0, M), c) < 1e-13


@pytest.mark.parametrize('M', SIZES)
@pytest.mark.parametrize('scale', SCALES)
def test_fast_real_fourier_matches_jax_and_mmt(libraries, M, scale):
    libraries('fast')
    rng = np.random.default_rng(M)
    jb, tb = _pair('RealFourier', M, (0, 2.7))
    N = tb.grid_size(scale)
    g = rng.standard_normal((N, 3))
    ref = _jit(jb.forward_transform, 1, 2, 3)(jnp.asarray(g), 0, scale, np.float64)
    got = tb.forward_transform(torch.tensor(g), 0, scale, np.float64)
    assert relerr(got, ref) < 1e-13
    assert relerr(got, tb.forward_matrix(scale, np.float64) @ g) < 1e-13
    c = rng.standard_normal((3, M))
    ref = _jit(jb.backward_transform, 1, 2, 3)(jnp.asarray(c), 1, scale, np.float64)
    got = tb.backward_transform(torch.tensor(c), 1, scale, np.float64)
    assert relerr(got, ref) < 1e-13
    assert relerr(got, c @ tb.backward_matrix(scale, np.float64).T) < 1e-13


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('library', ['auto', 'matrix', 'fast'])
@pytest.mark.parametrize('maker', ['ChebyshevT', 'ChebyshevU', 'Legendre', 'RealFourier'])
@pytest.mark.parametrize('N', [16, 8191, 8192, 16384])
def test_dispatch_matches_jax(libraries, library, maker, N):
    libraries(library)
    jb, tb = _pair(maker, 16, (0, 1))
    if maker == 'RealFourier':
        key = 'fourier_library'
        jfast = JB._fast_enabled(key, max(N, jb.size))
        assert TB._fast_enabled(key, max(N, tb.size)) == jfast
    else:
        jfast = jb._use_fast(N)
        assert tb._use_fast(N) == jfast
    expect = {'matrix': False, 'fast': maker != 'Legendre',
              'auto': maker != 'Legendre' and N >= 8192}[library]
    assert jfast == expect
    assert TB.FAST_THRESHOLD == JB.FAST_THRESHOLD == 8192


@pytest.mark.parametrize('library', ['auto', 'matrix', 'fast'])
def test_transforms_take_the_chosen_plan(libraries, library, monkeypatch):
    """forward/backward_transform of RealFourier and ChebyshevU go through
    the fast wrappers exactly when the JAX package's dispatch says so, and a
    size-1 RealFourier stays on its matrix."""
    libraries(library)
    calls = []
    for name in ('real_fft_forward', 'real_fft_backward'):
        fn = getattr(TT, name)
        monkeypatch.setattr(TT, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    for name in ('dct2_pre', 'dct3_post'):
        fn = getattr(F, name)
        monkeypatch.setattr(F, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    _, tf = _pair('RealFourier', 32, (0, 2 * np.pi))
    _, tu = _pair('ChebyshevU', 32, (0, 1))
    x = torch.tensor(np.random.default_rng(3).standard_normal((48, 48)))
    tf.backward_transform(tf.forward_transform(x, 0, 1.5, np.float64), 0, 1.5, np.float64)
    tu.backward_transform(tu.forward_transform(x, 1, 1.5, np.float64), 1, 1.5, np.float64)
    fast = library == 'fast'
    assert calls == (['real_fft_forward', 'real_fft_backward', 'dct2_pre', 'dct3_post']
                     if fast else [])
    _, t1 = _pair('RealFourier', 1, (0, 2 * np.pi))
    t1.forward_transform(torch.ones(4, 1, dtype=torch.float64), 0, 1, np.float64)
    assert len(calls) == (4 if fast else 0)


@pytest.mark.parametrize('maker', ['RealFourier', 'ChebyshevT'])
def test_auto_at_the_threshold_equals_jax(libraries, maker):
    """At a grid of 8192 the port no longer raises: under 'auto' both
    packages take the fast plan and agree."""
    libraries('auto')
    N = JB.FAST_THRESHOLD
    jb, tb = _pair(maker, N, (0, 1))
    rng = np.random.default_rng(8)
    g = rng.standard_normal((N, 2))
    ref = jb.forward_transform(jnp.asarray(g), 0, 1, np.float64)
    got = tb.forward_transform(torch.tensor(g), 0, 1, np.float64)
    assert relerr(got, ref) < 1e-13
    c = rng.standard_normal((N, 2))
    ref = jb.backward_transform(jnp.asarray(c), 0, 1, np.float64)
    got = tb.backward_transform(torch.tensor(c), 0, 1, np.float64)
    assert relerr(got, ref) < 1e-13
