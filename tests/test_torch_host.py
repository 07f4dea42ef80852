"""Host layers of the PyTorch port against dedalus_tpu: the Jacobi and
Clenshaw matrices, the dense transform matrices, and grid<->coeff
round-trips of fields (the port on the CPU, the JAX package on the CPU with
x64, inputs made with numpy from a seed)."""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.spectral import jacobi as jjac, clenshaw as jcl
from dedalus_tpu_torch.spectral import jacobi as tjac, clenshaw as tcl

AB = [(-0.5, -0.5), (0.5, 0.5), (0.0, 0.0), (1.5, 1.5), (-0.5, 0.5)]

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


def _dense(m):
    return m.toarray() if hasattr(m, 'toarray') else np.asarray(m)


def _close(a, b, rtol):
    a, b = _dense(a), _dense(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize('a,b', AB)
@pytest.mark.parametrize('name', ['conversion', 'differentiation', 'jacobi_matrix',
                                  'integration', 'interpolation', 'polynomials'])
def test_jacobi_matrices_equal(name, a, b):
    N = 24
    z = np.linspace(-1, 1, 7)
    calls = {
        'conversion': lambda lib: lib.conversion_matrix(N, a, b, a + 1, b + 1),
        'differentiation': lambda lib: lib.differentiation_matrix(N, a, b),
        'jacobi_matrix': lambda lib: lib.jacobi_matrix(N, a, b),
        'integration': lambda lib: lib.integration_vector(N, a, b),
        'interpolation': lambda lib: lib.interpolation_vector(N, a, b, 0.3),
        'polynomials': lambda lib: lib.polynomials(N, a, b, z),
    }
    _close(calls[name](tjac), calls[name](jjac), 1e-15)


@pytest.mark.parametrize('a,b', AB[:3])
def test_quadrature_equal(a, b):
    for lib_t, lib_j in ((tjac, jjac),):
        zt, wt = lib_t.quadrature(20, a, b)
        zj, wj = lib_j.quadrature(20, a, b)
        _close(zt, zj, 1e-15)
        _close(wt, wj, 1e-15)


@pytest.mark.parametrize('a,b', AB[:3])
def test_clenshaw_matrices_equal(a, b):
    rng = np.random.default_rng(3)
    coeffs = rng.standard_normal(12)
    N = 32
    St = tcl.matrix_clenshaw(coeffs, a, b, tjac.jacobi_matrix(N, a, b), cutoff=1e-12)
    Sj = jcl.matrix_clenshaw(coeffs, a, b, jjac.jacobi_matrix(N, a, b), cutoff=1e-12)
    _close(St, Sj, 1e-15)


def _bases(d3, kind, N, dealias=1.5):
    c = d3.Coordinate('x') if kind == 'fourier' else d3.Coordinate('z')
    if kind == 'fourier':
        return d3.RealFourier(c, size=N, bounds=(0, 4.0), dealias=dealias)
    return d3.ChebyshevT(c, size=N, bounds=(0, 1.0), dealias=dealias)


@pytest.mark.parametrize('kind', ['fourier', 'chebyshev'])
@pytest.mark.parametrize('N', [8, 18, 32])
@pytest.mark.parametrize('scale', [1.0, 1.5])
def test_transform_matrices_equal(kind, N, scale):
    bt = _bases(td3, kind, N)
    bj = _bases(jd3, kind, N)
    np.testing.assert_array_equal(bt.forward_matrix(scale, np.float64),
                                  bj.forward_matrix(scale, np.float64))
    np.testing.assert_array_equal(bt.backward_matrix(scale, np.float64),
                                  bj.backward_matrix(scale, np.float64))
    np.testing.assert_array_equal(bt.global_grid(scale), bj.global_grid(scale))


def _box_field(d3, Nx, Nz, vector):
    coords = d3.CartesianCoordinates('x', 'z')
    kw = {'device': 'cpu'} if d3 is td3 else {}
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    xb = d3.RealFourier(coords['x'], size=Nx, bounds=(0, 4.0), dealias=1.5)
    zb = d3.ChebyshevT(coords['z'], size=Nz, bounds=(0, 1.0), dealias=1.5)
    if vector:
        return dist.VectorField(coords, name='u', bases=(xb, zb))
    return dist.Field(name='f', bases=(xb, zb))


@pytest.mark.parametrize('vector', [False, True])
@pytest.mark.parametrize('Nx,Nz', [(16, 8), (32, 16)])
def test_grid_coeff_roundtrip_matches_reference(vector, Nx, Nz):
    ft = _box_field(td3, Nx, Nz, vector)
    fj = _box_field(jd3, Nx, Nz, vector)
    rng = np.random.default_rng(11)
    c = rng.standard_normal(tuple(ft.data.shape))
    ft['c'] = c
    fj['c'] = c
    for f in (ft, fj):
        f.change_scales(1.5)
    gt = ft['g'].numpy()
    gj = np.asarray(fj['g'])
    assert np.abs(gt - gj).max() <= 1e-14 * np.abs(gj).max()
    ct = ft['c'].numpy()
    cj = np.asarray(fj['c'])
    assert np.abs(ct - cj).max() <= 1e-14 * np.abs(cj).max()


def test_fill_random_matches_reference():
    ft = _box_field(td3, 32, 16, False)
    fj = _box_field(jd3, 32, 16, False)
    ft.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    fj.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    np.testing.assert_array_equal(ft['g'].numpy(), np.asarray(fj['g']))


def test_field_data_lives_on_distributor_device():
    f = _box_field(td3, 16, 8, True)
    assert f.data.device == torch.device('cpu')
    f['g'] = np.ones(tuple(f['g'].shape))
    assert isinstance(f.data, torch.Tensor) and f.data.dtype == torch.float64
