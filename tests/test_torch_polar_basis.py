"""The polar bases and operators of the PyTorch port against dedalus_tpu:
scalar, vector and rank-2 transforms of the annulus (32x16) and the disk
(16x32) forward and backward, the plain twins of kernels KF (spin
recombination) and KE (the per-m stack apply), the polar operators and
low_pass_filter, on numpy-seeded data in float64. Tolerances: the
reference's own tests allow 1e-12 for transforms and operators; KF and KE
repeat the reference's arithmetic (1e-15, 1e-14)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

GEOMETRIES = {'annulus': (32, 16), 'disk': (16, 32)}
DEALIAS = 1.5


def _bases(d3, geometry, **dkw):
    coords = d3.PolarCoordinates('phi', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    shape = GEOMETRIES[geometry]
    if geometry == 'annulus':
        basis = d3.AnnulusBasis(coords, shape=shape, radii=(1.0, 2.0), dealias=DEALIAS,
                                dtype=np.float64)
    else:
        basis = d3.DiskBasis(coords, shape=shape, radius=1.0, dealias=DEALIAS,
                             dtype=np.float64)
    return coords, dist, basis


@pytest.fixture(scope='module', params=sorted(GEOMETRIES))
def pair(request):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    return request.param, _bases(jd3, request.param), _bases(td3, request.param, device='cpu')


def _field(side, rank, name='f', bases=None):
    coords, dist, basis = side
    return dist.Field(name=name, bases=basis if bases is None else bases,
                      tensorsig=(coords,) * rank)


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize('rank', [0, 1, 2])
@pytest.mark.parametrize('direction', ['forward', 'backward'])
def test_transforms_match_reference(pair, rank, direction):
    geometry, jside, tside = pair
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


@pytest.mark.parametrize('rank', [1, 2])
@pytest.mark.parametrize('forward', [True, False])
def test_spin_recombine_plain_matches_reference(pair, rank, forward):
    from dedalus_tpu.core.basis_polar import spin_recombine as jrecombine
    from dedalus_tpu_torch.core.basis_polar import spin_matrix
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    geometry, jside, tside = pair
    rng = np.random.default_rng(rank + 7 * forward)
    data = rng.standard_normal((2,) * rank + (16, 24))
    ref = jrecombine(jside[0], (jside[0],) * rank, jnp.asarray(data), rank,
                     forward=forward, real=True)
    W = torch.as_tensor(spin_matrix(tside[0], forward))
    got = torch.as_tensor(data)
    for i in range(rank):
        got = kf.spin_recombine(got, i, rank, W)
    _close(got, ref, 1e-15)
    assert kf.spin_recombine.launches == 0


@pytest.mark.parametrize('batch', [(), (2,), (2, 2), (5,)])
def test_polar_apply_plain_matches_reference_einsum(batch):
    from dedalus_tpu_torch.ops import polar as ops_polar
    rng = np.random.default_rng(len(batch))
    K, O, I = 8, 12, 10
    S = rng.standard_normal((K, O, I))
    x = rng.standard_normal(batch + (2 * K, I))
    base = rng.standard_normal(batch + (2 * K, O))
    cm = x.reshape(batch + (K, 2, I))
    ref = np.asarray(jnp.einsum('moi,...mpi->...mpo', S, cm)).reshape(batch + (2 * K, O))
    got = ops_polar.polar_apply(torch.as_tensor(S), torch.as_tensor(x))
    _close(got, ref, 1e-14)
    out = torch.as_tensor(base.copy())
    ops_polar.polar_apply(torch.as_tensor(S), torch.as_tensor(x), out=out, accumulate=True)
    _close(out, base + ref, 1e-14)
    assert ops_polar.polar_apply.launches == 0


OPERATORS = {
    'grad_scalar': (0, lambda d3, f, basis: d3.grad(f)),
    'grad_vector': (1, lambda d3, f, basis: d3.grad(f)),
    'div': (1, lambda d3, f, basis: d3.div(f)),
    'lap_scalar': (0, lambda d3, f, basis: d3.lap(f)),
    'lap_vector': (1, lambda d3, f, basis: d3.lap(f)),
    'trace_grad': (1, lambda d3, f, basis: d3.trace(d3.grad(f))),
    'interp_edge': (1, lambda d3, f, basis: f(r=1.0)),
    'interp_mid': (0, lambda d3, f, basis: f(r=0.75 if hasattr(basis, 'edge') else 1.5)),
    'integ': (0, lambda d3, f, basis: d3.integ(f)),
    'convert_k2': (1, lambda d3, f, basis: d3.Convert(f, basis.derivative_basis(2))),
}


@pytest.mark.parametrize('name', sorted(OPERATORS))
def test_operators_match_reference(pair, name):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    geometry, jside, tside = pair
    rank, op = OPERATORS[name]
    jf, tf = _field(jside, rank), _field(tside, rank)
    rng = np.random.default_rng(sorted(OPERATORS).index(name))
    data = rng.standard_normal(tuple(jf.required_shape(jside[1].coeff_layout, (1, 1))))
    jf['c'] = data
    tf['c'] = data
    jout = op(jd3, jf, jside[2]).evaluate()
    tout = op(td3, tf, tside[2]).evaluate()
    _close(tout['c'], jout['c'], 1e-12)


@pytest.mark.parametrize('index', [-1, -2])
def test_lift_matches_reference(pair, index):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    geometry, jside, tside = pair
    jt = _field(jside, 1, 'tau', bases=jside[2].S1_basis())
    tt = _field(tside, 1, 'tau', bases=tside[2].S1_basis())
    data = np.random.default_rng(3).standard_normal(
        tuple(jt.required_shape(jside[1].coeff_layout, (1, 1))))
    jt['c'] = data
    tt['c'] = data
    lift_basis = lambda side: side[2].derivative_basis(2) if geometry == 'annulus' else side[2]
    jop = jd3.Lift(jt, lift_basis(jside), index)
    tout = td3.Lift(tt, lift_basis(tside), index).evaluate()
    if geometry == 'annulus':
        ref = jop.evaluate()['c']
    else:
        # The reference's PolarLift does not evaluate eagerly (its stack key
        # reads the radial basis of an edge operand): apply its per-m
        # columns as its operate() would
        K = data.shape[1] // 2
        stack = np.stack([jop.radial_matrix((0,), (0,), m).toarray() for m in range(K)])
        ref = np.einsum('moi,cmpi->cmpo', stack, data.reshape(2, K, 2, 1)).reshape(
            2, 2 * K, -1)
    _close(tout['c'], ref, 1e-12)


def test_low_pass_filter_matches_reference(pair):
    geometry, jside, tside = pair
    jf, tf = _field(jside, 1), _field(tside, 1)
    data = np.random.default_rng(5).standard_normal(
        tuple(jf.required_shape(jside[1].grid_layout, (1, 1))))
    for f in (jf, tf):
        f['g'] = data
        f.low_pass_filter(shape=(8, 6))
    got = tf['c']
    _close(got, jf['c'], 1e-12)
    assert not got[:, 8:, :].any() and not got[:, :, 6:].any()
