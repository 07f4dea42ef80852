"""The sphere (S2) basis and operators of the PyTorch port against
dedalus_tpu at 24x12, dealias 3/2, float64, on numpy-seeded data: the
per-(m, s) SWSH transform stacks (1e-14: the same host arithmetic), the
colatitude grid and the operator matrices, scalar, vector and rank-2
transforms forward and backward, grad, div, lap, skew, MulCosine, integ and
ave, and the analytic identities of tests/test_sphere.py. Tolerance 1e-12,
relative to max(1, |ref|): the reference's own tests allow 1e-10 to 1e-12
for transforms and operators."""

import numpy as np
import pytest
import torch

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

SHAPE = (24, 12)
DEALIAS = 1.5


def _bases(d3, radius=1.0, **dkw):
    coords = d3.S2Coordinates('phi', 'theta')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    basis = d3.SphereBasis(coords, SHAPE, radius=radius, dealias=DEALIAS, dtype=np.float64)
    return coords, dist, basis


@pytest.fixture(scope='module', params=[1.0, 2.5])
def pair(request):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    return _bases(jd3, request.param), _bases(td3, request.param, device='cpu')


def _field(side, rank, name='f'):
    coords, dist, basis = side
    return dist.Field(name=name, bases=basis, tensorsig=(coords,) * rank)


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize('spin', [-2, -1, 0, 1, 2])
@pytest.mark.parametrize('direction', ['f', 'b'])
def test_swsh_stacks_match_reference(pair, spin, direction):
    jside, tside = pair
    for scale in (1, DEALIAS):
        ref = jside[2].colatitude_basis._transform_stacks(scale, spin, direction)
        got = tside[2].colatitude_basis._transform_stacks(scale, spin, direction)
        _close(got, ref, 1e-14)


def test_grids_and_weights_match_reference(pair):
    jside, tside = pair
    for scale in (1, DEALIAS):
        for jg, tg in zip(jside[2].global_grids((scale, scale)),
                          tside[2].global_grids((scale, scale))):
            _close(tg, jg, 1e-15)
        _close(tside[2].colatitude_basis.global_weights(scale),
               jside[2].colatitude_basis.global_weights(scale), 1e-15)
    theta = tside[2].colatitude_basis.global_grid(1)
    assert np.all(np.diff(theta) > 0)       # increasing theta, decreasing z


@pytest.mark.parametrize('op', ['Cos', 'Sin+', 'Sin-', 'D+', 'D-', 'L2', 'Id'])
def test_operator_matrices_match_reference(pair, op):
    jside, tside = pair
    jb, tb = jside[2].colatitude_basis, tside[2].colatitude_basis
    for m in (0, 1, 5, 11):
        for s in (-2, -1, 0, 1, 2):
            ref = jb.operator_matrix(op, m, s).toarray()
            _close(tb.operator_matrix(op, m, s).toarray(), ref, 1e-15)


@pytest.mark.parametrize('rank', [0, 1, 2])
@pytest.mark.parametrize('direction', ['forward', 'backward'])
def test_transforms_match_reference(pair, rank, direction):
    jside, tside = pair
    jf, tf = _field(jside, rank), _field(tside, rank)
    rng = np.random.default_rng(10 * rank + (direction == 'forward'))
    if direction == 'forward':
        data = rng.standard_normal(tuple(jf.required_shape(jside[1].grid_layout,
                                                            (DEALIAS, DEALIAS))))
        for f in (jf, tf):
            f['g', DEALIAS] = data
        _close(tf['c'], jf['c'], 1e-12)
    else:
        data = rng.standard_normal(tuple(jf.required_shape(jside[1].coeff_layout, (1, 1))))
        for f in (jf, tf):
            f['c'] = data
        _close(tf['g', DEALIAS], jf['g', DEALIAS], 1e-12)


OPERATORS = {
    'grad_scalar': (0, lambda d3, f: d3.grad(f)),
    'grad_vector': (1, lambda d3, f: d3.grad(f)),
    'div_vector': (1, lambda d3, f: d3.div(f)),
    'div_rank2': (2, lambda d3, f: d3.div(f)),
    'lap_scalar': (0, lambda d3, f: d3.lap(f)),
    'lap_vector': (1, lambda d3, f: d3.lap(f)),
    'lap_lap_vector': (1, lambda d3, f: d3.lap(d3.lap(f))),
    'skew': (1, lambda d3, f: d3.skew(f)),
    'mulcosine_scalar': (0, lambda d3, f: d3.MulCosine(f)),
    'mulcosine_vector': (1, lambda d3, f: d3.MulCosine(f)),
    'zcross': (1, lambda d3, f: d3.MulCosine(d3.skew(f))),
    'integ': (0, lambda d3, f: d3.integ(f)),
    'ave': (0, lambda d3, f: d3.ave(f)),
}


@pytest.mark.parametrize('name', sorted(OPERATORS))
def test_operators_match_reference(pair, name):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jside, tside = pair
    rank, op = OPERATORS[name]
    jf, tf = _field(jside, rank), _field(tside, rank)
    rng = np.random.default_rng(sorted(OPERATORS).index(name))
    data = rng.standard_normal(tuple(jf.required_shape(jside[1].coeff_layout, (1, 1))))
    jf['c'] = data
    tf['c'] = data
    jout = op(jd3, jf).evaluate()
    tout = op(td3, tf).evaluate()
    _close(tout['c'], jout['c'], 1e-12)
    jout.change_scales(DEALIAS)
    tout.change_scales(DEALIAS)
    _close(tout['g'], jout['g'], 1e-12)


def _grid1(expr):
    f = expr.evaluate()
    f.change_scales(1)
    return f['g'].numpy()


@pytest.fixture(scope='module')
def unit():
    import dedalus_tpu_torch.public as td3
    coords, dist, basis = _bases(td3, device='cpu')
    phi, theta = basis.global_grids(scales=(1, 1))
    return td3, coords, dist, basis, phi.reshape(-1, 1), theta.reshape(1, -1)


def test_gradient_of_harmonics_is_analytic(unit):
    """Signs and component order, not only round trips: grad in (phi, theta)
    components of cos(theta) and of sin(theta) sin(phi)."""
    d3, coords, dist, basis, phi, theta = unit
    f = dist.Field(name='f', bases=basis)
    f['g'] = np.cos(theta) * np.ones_like(phi)
    gd = _grid1(d3.grad(f))
    assert np.abs(gd[0]).max() < 1e-11
    assert np.abs(gd[1] + np.sin(theta)).max() < 1e-11
    f['g'] = np.sin(theta) * np.sin(phi)
    gd = _grid1(d3.grad(f))
    assert np.abs(gd[0] - np.cos(phi)).max() < 1e-11
    assert np.abs(gd[1] - np.cos(theta) * np.sin(phi)).max() < 1e-11


def test_laplacian_and_div_grad_are_analytic(unit):
    d3, coords, dist, basis, phi, theta = unit
    f = dist.Field(name='f', bases=basis)
    fg = np.sin(theta) * np.cos(theta) * np.cos(phi)     # l = 2: lap = -6 f
    f['g'] = fg
    assert np.abs(_grid1(d3.lap(f)) + 6 * fg).max() < 1e-10
    assert np.abs(_grid1(d3.div(d3.grad(f))) + 6 * fg).max() < 1e-10


def test_skew_and_mulcosine_are_analytic(unit):
    d3, coords, dist, basis, phi, theta = unit
    f = dist.Field(name='f', bases=basis)
    f['g'] = np.sin(theta) * np.sin(phi)
    gd = _grid1(d3.grad(f))
    u = dist.VectorField(coords, name='u', bases=basis)
    u['g'] = gd
    sk = _grid1(d3.skew(u))
    # skew: (u_phi, u_theta) -> (-u_theta, u_phi)
    assert np.abs(sk[0] + gd[1]).max() < 1e-10
    assert np.abs(sk[1] - gd[0]).max() < 1e-10
    assert np.abs(_grid1(d3.MulCosine(u)) - np.cos(theta) * gd).max() < 1e-10


def test_integral_and_average_are_analytic(unit):
    d3, coords, dist, basis, phi, theta = unit
    f = dist.Field(name='f', bases=basis)
    f['g'] = 3.0 + np.sin(theta) * np.cos(phi) + np.cos(theta)
    assert abs(float(_grid1(d3.integ(f)).ravel()[0]) - 3.0 * 4 * np.pi) < 1e-10
    assert abs(float(_grid1(d3.ave(f)).ravel()[0]) - 3.0) < 1e-11


def test_sphere_basis_rejects_other_coordinates_and_complex():
    import dedalus_tpu_torch.public as td3
    polar = td3.PolarCoordinates('phi', 'r')
    td3.Distributor(polar, dtype=np.float64, device='cpu')
    with pytest.raises(ValueError):
        td3.SphereBasis(polar, SHAPE)
    # Complex dtype is no longer refused: it takes the signed (+m, -m)
    # azimuth (tests/test_torch_complex_curvilinear.py holds its transforms)
    from dedalus_tpu_torch.core.basis_polar import ExponentialAzimuthBasis
    coords = td3.S2Coordinates('phi', 'theta')
    td3.Distributor(coords, dtype=np.complex128, device='cpu')
    sphere = td3.SphereBasis(coords, SHAPE, dtype=np.complex128)
    assert isinstance(sphere.azimuth_basis, ExponentialAzimuthBasis)
