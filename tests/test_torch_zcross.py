"""SphericalZCross (ez x u, the Coriolis operator) and SphericalEllProduct on
the PyTorch port, against the analytic values and the JAX package.

The analogues of tests/test_zcross.py: the grid evaluation against the
analytic components on the ball and the shell in float64 and complex128
(< 1e-11), and the pencil matrices applied group by group against the grid
evaluation (< 1e-12). The port's pencil matrices against the JAX package's
expression_matrices (1e-14), the ZCross kernel's plain twin against the
JAX package's operate, the real-dtype NotImplementedError of the
matrices; and SphericalEllProduct: tests/test_public_api.py:79-86, and a
scalar and a vector on the ball and the shell in both dtypes against the
JAX package (1e-12). ComplexWarning is an error here.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.core.operators_ball import SphericalZCross as JZCross
from dedalus_tpu_torch.core.operators_ball import SphericalZCross as TZCross
from dedalus_tpu.core import subsystems as jsub
from dedalus_tpu_torch.core import subsystems as tsub

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings('error::numpy.exceptions.ComplexWarning')

SIDES = (('jax', jd3, {}), ('torch', td3, dict(device='cpu')))


def _build(d3, kw, geom, dtype, shape=(8, 6, 6)):
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=dtype, **kw)
    if geom == 'shell':
        basis = d3.ShellBasis(coords, shape, radii=(1.0, 2.0), dtype=dtype, dealias=3 / 2)
    else:
        basis = d3.BallBasis(coords, shape, radius=1.0, dtype=dtype, dealias=2)
    return coords, dist, basis


def _gradient(d3, dist, basis, dtype):
    """grad of the reference test's polynomial, a vector field."""
    phi, theta, r = dist.local_grids(basis, scales=1)
    x = r * np.sin(theta) * np.cos(phi)
    y = r * np.sin(theta) * np.sin(phi)
    z = r * np.cos(theta)
    f = dist.Field(name='f', bases=basis)
    fg = x * z + 0.5 * y - 0.3 * z * z + 0.1
    if dtype == np.complex128:
        fg = fg + 1j * (y * z - 0.2 * x)
    f['g'] = np.broadcast_to(fg, np.broadcast_shapes(phi.shape, theta.shape, r.shape))
    return d3.grad(f).evaluate(), theta


def _numpy(field):
    return field.data.numpy() if isinstance(field.data, torch.Tensor) else np.asarray(field.data)


@pytest.mark.parametrize('geom', ['shell', 'ball'])
@pytest.mark.parametrize('dtype', [np.float64, np.complex128])
def test_zcross_grid_values(geom, dtype):
    coords, dist, basis = _build(td3, dict(device='cpu'), geom, dtype)
    u, theta = _gradient(td3, dist, basis, dtype)
    w = TZCross(u).evaluate()
    for field in (w, u):
        field.require_coeff_space()
        field.change_scales(1)
        field.require_grid_space()
    ug = _numpy(u)
    shp = ug[0].shape
    ct = np.broadcast_to(np.cos(theta), shp)
    st = np.broadcast_to(np.sin(theta), shp)
    ex = np.stack([ct * ug[1] + st * ug[2], -ct * ug[0], -st * ug[0]])
    assert np.abs(_numpy(w) - ex).max() < 1e-11


def _subproblems(dist, expr, u, sub):
    return sub.enumerate_subproblems(dist, [expr.domain, u.domain],
                                     list(expr.matrix_coupling(u)))[1]


@pytest.mark.parametrize('geom', ['shell', 'ball'])
def test_zcross_matrix_matches_grid(geom):
    dtype = np.complex128
    coords, dist, basis = _build(td3, dict(device='cpu'), geom, dtype)
    u, _ = _gradient(td3, dist, basis, dtype)
    w = TZCross(u).evaluate()
    w.require_coeff_space()
    w.change_scales(1)
    ref = _numpy(w)
    expr = TZCross(u)
    u.require_coeff_space()
    u.change_scales(1)
    udata = _numpy(u)
    L, n = basis.colatitude_basis.size, basis.radial_basis.size
    got = np.zeros_like(ref)
    for sp in _subproblems(dist, expr, u, tsub):
        A = expr.expression_matrices(sp, [u])[u].toarray()
        g = sp.group[0] if sp.group[0] is not None else 0
        sl = slice(2 * g, 2 * g + 2)
        got[:, sl] = (A @ udata[:, sl].ravel()).reshape(3, 2, L, n)
    assert np.abs(got - ref).max() < 1e-12


@pytest.mark.parametrize('geom', ['shell', 'ball'])
def test_zcross_matrices_match_reference(geom):
    """The port's pencil matrices, group by group, against the JAX
    package's expression_matrices (1e-14 of the largest entry)."""
    mats = {}
    for name, d3, kw in SIDES:
        coords, dist, basis = _build(d3, kw, geom, np.complex128)
        u = dist.VectorField(coords, name='u', bases=basis)
        Z = JZCross if name == 'jax' else TZCross
        expr = Z(u)
        sps = _subproblems(dist, expr, u, jsub if name == 'jax' else tsub)
        mats[name] = [expr.expression_matrices(sp, [u])[u].toarray() for sp in sps]
    assert len(mats['torch']) == len(mats['jax']) == 4
    for got, ref in zip(mats['torch'], mats['jax']):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()


def test_zcross_real_matrices_raise():
    coords, dist, basis = _build(td3, dict(device='cpu'), 'shell', np.float64)
    u = dist.VectorField(coords, name='u', bases=basis)
    expr = TZCross(u)
    sp = _subproblems(dist, expr, u, tsub)[0]
    with pytest.raises(NotImplementedError):
        expr.expression_matrices(sp, [u])


@pytest.mark.parametrize('geom', ['shell', 'ball'])
@pytest.mark.parametrize('dtype', [np.float64, np.complex128])
def test_zcross_twin_matches_reference(geom, dtype):
    """The ZCross kernel's plain twin (SphericalZCross.operate on the CPU)
    against the JAX package's operate, from the same seeded coefficients of
    u, on the dealias grid."""
    out = {}
    for name, d3, kw in SIDES:
        rng = np.random.default_rng(5)
        coords, dist, basis = _build(d3, kw, geom, dtype)
        u = dist.VectorField(coords, name='u', bases=basis)
        shape = (3,) + tuple(basis.shape)
        data = rng.standard_normal(shape)
        if dtype == np.complex128:
            data = data + 1j * rng.standard_normal(shape)
        u['g'] = data
        u['c']          # project onto the valid modes first
        w = (JZCross if name == 'jax' else TZCross)(u).evaluate()
        out[name] = _numpy(w).copy()
    assert np.abs(out['torch'] - out['jax']).max() <= 1e-14 * np.abs(out['jax']).max()


# ---------------------------------------------------------------------------
# SphericalEllProduct
# ---------------------------------------------------------------------------

def test_spherical_ell_product_scales_by_ell():
    """tests/test_public_api.py:79-86: r cos(theta) is a pure ell = 1
    regular solid harmonic, so the product with ell (ell + 1) doubles it."""
    coords = td3.SphericalCoordinates('phi', 'theta', 'r')
    dist = td3.Distributor(coords, dtype=np.float64, device='cpu')
    ball = td3.BallBasis(coords, (8, 4, 6), radius=1, dtype=np.float64)
    f = dist.Field(name='f', bases=ball)
    phi, theta, r = dist.local_grids(ball, scales=1)
    f['g'] = r * np.cos(theta)
    out = td3.SphericalEllProduct(f, coords, lambda ell: ell * (ell + 1)).evaluate()
    out.require_grid_space()
    np.testing.assert_allclose(out['g'].numpy(), 2.0 * f['g'].numpy(), atol=1e-12)


@pytest.mark.parametrize('geom', ['shell', 'ball'])
@pytest.mark.parametrize('dtype', [np.float64, np.complex128])
@pytest.mark.parametrize('rank', [0, 1])
def test_ell_product_matches_reference(geom, dtype, rank):
    """A seeded scalar or vector times ell (ell + 1) - 2 (the regularity
    total shifts ell for a vector's components), in both packages, from the
    same coefficients: 1e-12 of the largest value, coefficients and grid."""
    out = {}
    for name, d3, kw in SIDES:
        coords, dist, basis = _build(d3, kw, geom, dtype, shape=(8, 4, 8))
        rng = np.random.default_rng(9)
        f = dist.Field(name='f', bases=basis, tensorsig=(coords,) * rank)
        shape = (3,) * rank + tuple(basis.shape)
        data = rng.standard_normal(shape)
        if dtype == np.complex128:
            data = data + 1j * rng.standard_normal(shape)
        f['g'] = data
        e = d3.SphericalEllProduct(f, coords, lambda ell: ell * (ell + 1) - 2).evaluate()
        e.require_coeff_space()
        c = _numpy(e).copy()
        e.require_grid_space()
        out[name] = (c, _numpy(e).copy())
    for got, ref in zip(out['torch'], out['jax']):
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
