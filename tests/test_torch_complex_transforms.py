"""Complex transforms of the PyTorch port against dedalus_tpu: ComplexFourier
(its matrices, ordering and masks), the complex fast transform (the DFT of
ops/fft.py, kernel K10, with K12's complex select and scatter, their plain
twins on the CPU), and the fast Jacobi transforms of complex data (the
real and imaginary parts through the real kernels as one batch).

The cases and tolerances are the reference's own: tests/test_transforms.py
:63 (test_complex_fourier_accuracy, 1e-12 by allclose) and :164
(test_fft_matches_mmt_complex); tests/test_fast_transforms.py :44
(test_fft64_complex, 1e-13), :96 (the complex Chebyshev plans against MMT:
forward 1e-13, backward max(1e-13, 100 M^2 1e-16)), :157 (the complex
Fourier plans against MMT at every SIZES x SCALES case, 1e-13, scale < 1
included) and :187 (the field roundtrip); tests/test_roundtrips.py :18-31
and :33-48 (the complex Jacobi and Fourier round trips, 1e-12), here under
both `[transforms]` libraries. The JAX side's matrices are numpy; its fast
transforms are jitted. Both packages' configs are restored by a fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
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

pytestmark = pytest.mark.filterwarnings('error::numpy.exceptions.ComplexWarning')

SIZES = [32, 64, 100, 128, 256]
SCALES = [1, 1.5, 0.75, 2 / 3]
KEYS = ('fourier_library', 'jacobi_library')

JAX_COMPLEX_FORWARD = jax.jit(JT.complex_fft_forward, static_argnums=(1, 2, 3))
JAX_COMPLEX_BACKWARD = jax.jit(JT.complex_fft_backward, static_argnums=(1, 2, 3))
FFT64 = {name: jax.jit(getattr(fft64, name), static_argnums=1) for name in ('fft64', 'ifft64')}


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


def _pair(maker, M, bounds):
    return (getattr(JB, maker)(JCoordinate('x'), M, bounds),
            getattr(TB, maker)(TCoordinate('x'), M, bounds))


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ---------------------------------------------------------------------------
# ComplexFourier: ordering, masks, matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('M', [1, 15, 16, 33])
def test_complex_fourier_basis_matches_jax(M):
    jb, tb = _pair('ComplexFourier', M, (0, 2.7))
    np.testing.assert_array_equal(tb.wavenumbers_native, jb.wavenumbers_native)
    np.testing.assert_allclose(tb.wavenumbers, jb.wavenumbers, rtol=0, atol=0)
    assert tb.group_shape == jb.group_shape == (1,)
    np.testing.assert_array_equal(tb.valid_coeff_mask(), jb.valid_coeff_mask())
    for g in range(M):
        np.testing.assert_array_equal(tb.group_valid_mask(g), jb.group_valid_mask(g))
    for scale in SCALES:
        np.testing.assert_array_equal(tb.forward_matrix(scale, np.complex128),
                                      jb.forward_matrix(scale, np.complex128))
        np.testing.assert_array_equal(tb.backward_matrix(scale, np.complex128),
                                      jb.backward_matrix(scale, np.complex128))
    for A, B in ((tb.differentiation_matrix(), jb.differentiation_matrix()),
                 (tb.interpolation_vector(0.3), jb.interpolation_vector(0.3)),
                 (tb.integration_vector(), jb.integration_vector())):
        np.testing.assert_array_equal(A.toarray(), B.toarray())


@pytest.mark.parametrize('N', [16, 32])
def test_complex_fourier_accuracy(N):
    """tests/test_transforms.py:63: exp(3ix) + 2 exp(-2ix) lands at k = 3
    and at storage N - 2; the coefficients equal the JAX package's."""
    out = []
    for d3, kw in ((jd3, {}), (td3, dict(device='cpu'))):
        c = d3.Coordinate('x')
        dist = d3.Distributor(c, dtype=np.complex128, **kw)
        b = d3.ComplexFourier(c, size=N, bounds=(0, 2 * np.pi))
        u = dist.Field(name='u', bases=b)
        x = dist.local_grid(b, scale=1).ravel()
        u['g'] = np.exp(3j * x) + 2 * np.exp(-2j * x)
        uc = np.array(u['c'])
        expect = np.zeros(N, dtype=complex)
        expect[3] = 1
        expect[N - 2] = 2
        assert np.allclose(uc, expect, atol=1e-12)
        assert np.allclose(np.array(u['g']), np.exp(3j * x) + 2 * np.exp(-2j * x), atol=1e-12)
        out.append(uc)
    assert np.abs(out[1] - out[0]).max() <= 1e-15


def test_complex_fourier_requires_complex_dtype():
    c = td3.Coordinate('x')
    dist = td3.Distributor(c, dtype=np.float64, device='cpu')
    b = td3.ComplexFourier(c, size=8, bounds=(0, 1))
    with pytest.raises(ValueError):
        dist.Field(name='u', bases=b)


def test_fourier_factory_dispatch():
    """tests/test_public_api.py:51-60."""
    coords = td3.CartesianCoordinates('x')
    td3.Distributor(coords, dtype=np.float64, device='cpu')
    assert isinstance(td3.Fourier(coords['x'], size=8, bounds=(0, 1), dtype=np.float64),
                      td3.RealFourier)
    td3.Distributor(coords, dtype=np.complex128, device='cpu')
    assert isinstance(td3.Fourier(coords['x'], size=8, bounds=(0, 1), dtype=np.complex128),
                      td3.ComplexFourier)
    with pytest.raises(ValueError):
        td3.Fourier(coords['x'], size=8, bounds=(0, 1))


# ---------------------------------------------------------------------------
# The complex fast transform: K10 with K12's complex select and scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('N', [16, 33, 97, 100, 512, 2048])
def test_complex_dft_matches_fft64(N):
    """tests/test_fast_transforms.py:44, on the port's K10 twin."""
    x = _crandn(np.random.default_rng(N), N)
    xt = torch.as_tensor(x)
    assert relerr(F.fft(xt), FFT64['fft64'](jnp.asarray(x), -1)) < 1e-13
    assert relerr(F.ifft(xt), FFT64['ifft64'](jnp.asarray(x), -1)) < 1e-13
    assert relerr(F.fft(xt), np.fft.fft(x)) < 1e-13


def test_fft_matches_mmt_complex():
    """tests/test_transforms.py:164: N = 24 grid points, M = 16 modes."""
    N, M = 24, 16
    rng = np.random.default_rng(2)
    g = _crandn(rng, N)
    jb, tb = _pair('ComplexFourier', M, (0, 2 * np.pi))
    mmt_f = jb.forward_matrix(N / M, np.complex128) @ g
    fft_f = TT.complex_fft_forward(torch.as_tensor(g), 0, M, tb.Kmax_for(N))
    assert np.allclose(mmt_f, fft_f.numpy(), atol=1e-12)
    c = _crandn(rng, M)
    mmt_b = jb.backward_matrix(N / M, np.complex128) @ c
    fft_b = TT.complex_fft_backward(torch.as_tensor(c), 0, N, tb.Kmax_for(N))
    assert np.allclose(mmt_b, fft_b.numpy(), atol=1e-12)


@pytest.mark.parametrize('M', SIZES)
@pytest.mark.parametrize('scale', SCALES)
def test_fast_complex_fourier_matches_jax_and_mmt(libraries, M, scale):
    """tests/test_fast_transforms.py:157: forward and backward against the
    JAX package's MMT matrices and its fast transform, < 1e-13 (scale < 1:
    M > N, the clipped indices masked); through the basis under `fast`."""
    libraries('fast')
    rng = np.random.default_rng(M)
    jb, tb = _pair('ComplexFourier', M, (0, 2.7))
    N = tb.grid_size(scale)
    Kmax = tb.Kmax_for(N)
    g = _crandn(rng, N)
    mmt_f = jb.forward_matrix(scale, np.complex128) @ g
    fast_f = tb.forward_transform(torch.as_tensor(g), 0, scale, np.complex128)
    assert relerr(fast_f, mmt_f) < 1e-13
    assert relerr(fast_f, JAX_COMPLEX_FORWARD(jnp.asarray(g), 0, M, Kmax)) < 1e-13
    c = _crandn(rng, M)
    mmt_b = jb.backward_matrix(scale, np.complex128) @ c
    fast_b = tb.backward_transform(torch.as_tensor(c), 0, scale, np.complex128)
    assert relerr(fast_b, mmt_b) < 1e-13
    assert relerr(fast_b, JAX_COMPLEX_BACKWARD(jnp.asarray(c), 0, N, Kmax)) < 1e-13


@pytest.mark.parametrize('N, M', [(24, 16), (16, 24), (15, 16), (16, 15), (33, 64), (64, 33)])
def test_k12_complex_twins_select_and_scatter(N, M):
    """K12's complex twins alone: the select equals the reference's take
    with clip and mask on a spectrum (M < N and M > N), the scatter its
    masked .at[].add into zeros; exactly."""
    rng = np.random.default_rng(N * 100 + M)
    Kmax = min((N - 1) // 2, (M - 1) // 2)
    k_out = (np.arange(M) + (M - 1) // 2) % M - (M - 1) // 2
    valid = np.abs(k_out) <= Kmax
    idx = np.where(k_out >= 0, k_out, N + k_out)
    Z = _crandn(rng, 3, N, 2)
    expect = np.take(Z, np.clip(idx, 0, N - 1), axis=1) * valid[None, :, None]
    np.testing.assert_array_equal(F.fourier_select(torch.as_tensor(Z), 1, M, Kmax).numpy(),
                                  expect)
    c = _crandn(rng, 3, M, 2)
    full = np.zeros((3, N, 2), dtype=complex)
    np.add.at(full, (slice(None), idx[valid]), c[:, valid])
    np.testing.assert_array_equal(F.fourier_scatter(torch.as_tensor(c), 1, N, Kmax).numpy(),
                                  full)


def test_complex_fast_along_every_axis():
    """The complex fast transform along each axis of a 3-D array equals the
    transform of the moved axis (the kernels take the axis where it lies)."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(_crandn(rng, 6, 24, 5))
    for axis in range(3):
        N = x.shape[axis]
        M = N - 2
        Kmax = min((N - 1) // 2, (M - 1) // 2)
        y = TT.complex_fft_forward(x, axis, M, Kmax)
        ref = TT.complex_fft_forward(torch.movedim(x, axis, -1).contiguous(), -1, M, Kmax)
        assert relerr(y, torch.movedim(ref, -1, axis)) < 1e-15
        back = TT.complex_fft_backward(y, axis, N, Kmax)
        ref = TT.complex_fft_backward(torch.movedim(y, axis, -1).contiguous(), -1, N, Kmax)
        assert relerr(back, torch.movedim(ref, -1, axis)) < 1e-15


@pytest.mark.parametrize('library', ['auto', 'matrix', 'fast'])
@pytest.mark.parametrize('N', [16, 8192])
def test_complex_fourier_dispatch_matches_jax(libraries, library, N):
    """ComplexFourier picks the plan the JAX package picks (auto: fast from
    the threshold on), and the fast plan launches the complex select (the
    8192-mode matrix plan is not built: a 1 GB matrix)."""
    libraries(library)
    jb, tb = _pair('ComplexFourier', N, (0, 2 * np.pi))
    want = JB._fast_enabled('fourier_library', N)
    assert TB._fast_enabled('fourier_library', N) == want
    if N > 16 and not want:
        return
    x = torch.as_tensor(_crandn(np.random.default_rng(3), 2, N))
    calls = []
    orig = F.fourier_select
    F.fourier_select = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        tb.forward_transform(x, 1, 1, np.complex128)
    finally:
        F.fourier_select = orig
    assert bool(calls) == want


# ---------------------------------------------------------------------------
# Fast Jacobi transforms of complex data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('maker', ['ChebyshevT', 'ChebyshevU', 'ChebyshevV'])
@pytest.mark.parametrize('M', SIZES)
@pytest.mark.parametrize('scale', SCALES)
def test_fast_chebyshev_complex_matches_mmt(maker, M, scale):
    """tests/test_fast_transforms.py:96 (complex128): the port's fast plan on
    complex data against the JAX package's MMT matrices, forward < 1e-13,
    backward < max(1e-13, 100 M^2 1e-16); the two parts agree with the real
    plan run on each to roundoff (the batch of twice the lines may sum in
    another order)."""
    rng = np.random.default_rng(M)
    jb, tb = _pair(maker, M, (-1, 3))
    N = tb.grid_size(scale)
    g = _crandn(rng, N)
    fast_f = tb._fast_forward(torch.as_tensor(g), 0, N)
    assert relerr(fast_f, jb.forward_matrix(scale, np.complex128) @ g) < 1e-13
    parts = [tb._fast_forward(torch.as_tensor(p.copy()), 0, N) for p in (g.real, g.imag)]
    assert relerr(fast_f, parts[0] + 1j * parts[1]) < 1e-15
    c = _crandn(rng, M)
    fast_b = tb._fast_backward(torch.as_tensor(c), 0, N)
    assert relerr(fast_b, jb.backward_matrix(scale, np.complex128) @ c) < max(1e-13,
                                                                               100 * M**2 * 1e-16)


# ---------------------------------------------------------------------------
# Field round trips (tests/test_roundtrips.py, tests/test_fast_transforms.py:187)
# ---------------------------------------------------------------------------

def _roundtrip(field, data, tol=1e-12):
    field['g'] = data
    field.require_coeff_space()
    field.require_grid_space()
    assert np.abs(np.asarray(field.data) - data).max() < tol


@pytest.mark.parametrize('library', ['matrix', 'fast'])
@pytest.mark.parametrize('basis_name', ['ChebyshevT', 'ChebyshevU', 'Legendre'])
@pytest.mark.parametrize('dealias', [1, 3 / 2])
def test_jacobi_roundtrip_complex(libraries, library, basis_name, dealias):
    libraries(library)
    c = td3.Coordinate('x')
    dist = td3.Distributor(c, dtype=np.complex128, device='cpu')
    xb = getattr(td3, basis_name)(c, size=16, bounds=(0, 2), dealias=dealias,
                                  dtype=np.complex128)
    f = dist.Field(name='f', bases=xb)
    x = dist.local_grid(xb, scale=1).ravel()
    _roundtrip(f, (0.3 + x - 0.5 * x**3 + 0.01 * x**7).astype(np.complex128)
               * (1 + 0.5j))


@pytest.mark.parametrize('library', ['matrix', 'fast'])
@pytest.mark.parametrize('dealias', [1, 3 / 2])
def test_complex_fourier_roundtrip(libraries, library, dealias):
    libraries(library)
    c = td3.Coordinate('x')
    dist = td3.Distributor(c, dtype=np.complex128, device='cpu')
    xb = td3.ComplexFourier(c, size=16, bounds=(0, 2 * np.pi), dealias=dealias)
    f = dist.Field(name='f', bases=xb)
    x = dist.local_grid(xb, scale=1).ravel()
    _roundtrip(f, np.cos(3 * x) + 0.5 * np.sin(x) + 1j * np.sin(2 * x))


def test_fast_complex_fourier_field_roundtrip(libraries):
    """tests/test_fast_transforms.py:187 (ComplexFourier): 128 modes,
    dealias 3/2, under `fast`, against the JAX package's field."""
    libraries('fast')
    out = []
    for d3, kw in ((jd3, {}), (td3, dict(device='cpu'))):
        xcoord = d3.Coordinate('x')
        dist = d3.Distributor(xcoord, dtype=np.complex128, **kw)
        xbasis = d3.ComplexFourier(xcoord, 128, (0, 2 * np.pi), dealias=3 / 2)
        f = dist.Field(bases=xbasis)
        x = dist.local_grid(xbasis, scale=1)
        data = (np.cos(3 * x) + 0.5 * np.sin(7 * x)).astype(np.complex128)
        f['g'] = data
        f.require_coeff_space()
        out.append(np.array(f.data))
        f.require_grid_space()
        assert np.abs(np.array(f.data) - data).max() < 1e-12
    assert relerr(out[1], out[0]) < 1e-13
