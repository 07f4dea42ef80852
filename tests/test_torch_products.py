"""KG's plain twin (dedalus_tpu_torch.ops.products) against the product
nodes of dedalus_tpu: Multiply.operate and DotProduct.operate on
numpy-seeded grid data of a 2-D Cartesian domain (12x10, dealias 3/2) for
scalar*vector, vector*scalar, vector (x) vector, vector@vector,
vector@rank-2, rank-2@vector, rank-2@rank-2, scaled products, and operands
constant along a grid axis (size 1 there: the kernel's zero stride).
Tolerance 1e-15 relative: the twin repeats the reference's arithmetic in
its order. Both packages' nodes are evaluated through the public API, and
the twin is also held to numpy's einsum directly."""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.ops import products

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

SHAPE = (12, 10)
DEALIAS = 1.5


def _side(d3, **dkw):
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    xb = d3.RealFourier(coords['x'], size=SHAPE[0], bounds=(0, 2.0), dealias=DEALIAS)
    zb = d3.ChebyshevT(coords['z'], size=SHAPE[1], bounds=(0, 1.0), dealias=DEALIAS)
    return coords, dist, dict(full=(xb, zb), x=(xb,), z=(zb,), const=())


@pytest.fixture(scope='module')
def sides():
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    return _side(jd3), _side(td3, device='cpu')


def _fields(side, specs, seed):
    """Fields of (rank, bases key) specs holding seeded grid data."""
    coords, dist, bases = side
    rng = np.random.default_rng(seed)
    out = []
    for i, (rank, key) in enumerate(specs):
        f = dist.Field(name=f'f{i}', bases=bases[key], tensorsig=(coords,) * rank)
        f.change_scales(DEALIAS)
        f['g'] = rng.standard_normal(tuple(f.required_shape(dist.grid_layout,
                                                            (DEALIAS, DEALIAS))))
        out.append(f)
    return out


def _close(got, ref, tol=1e-15):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


NODES = {
    'scalar_times_vector': ([(0, 'full'), (1, 'full')], lambda a, b: a * b),
    'vector_times_scalar': ([(1, 'full'), (0, 'full')], lambda a, b: a * b),
    'scalar_times_scalar': ([(0, 'full'), (0, 'full')], lambda a, b: a * b),
    'vector_outer_vector': ([(1, 'full'), (1, 'full')], lambda a, b: a * b),
    'scaled_scalar_times_vector': ([(0, 'full'), (1, 'full')], lambda a, b: -2.5 * (a * b)),
    'vector_dot_vector': ([(1, 'full'), (1, 'full')], lambda a, b: a @ b),
    'vector_dot_rank2': ([(1, 'full'), (2, 'full')], lambda a, b: a @ b),
    'rank2_dot_vector': ([(2, 'full'), (1, 'full')], lambda a, b: a @ b),
    'rank2_dot_rank2': ([(2, 'full'), (2, 'full')], lambda a, b: a @ b),
    'zero_stride_z_profile': ([(0, 'z'), (1, 'full')], lambda a, b: a * b),
    'zero_stride_x_profile': ([(1, 'full'), (0, 'x')], lambda a, b: a * b),
    'zero_stride_constant_vector': ([(1, 'const'), (0, 'full')], lambda a, b: a * b),
    'zero_stride_dot': ([(1, 'const'), (2, 'full')], lambda a, b: a @ b),
    'zero_stride_both': ([(1, 'x'), (1, 'z')], lambda a, b: a @ b),
}


@pytest.mark.parametrize('name', sorted(NODES))
def test_product_nodes_match_reference(sides, name):
    specs, build = NODES[name]
    seed = sorted(NODES).index(name)
    jout = build(*_fields(sides[0], specs, seed)).evaluate()
    tout = build(*_fields(sides[1], specs, seed)).evaluate()
    assert tout.layout == sides[1][1].grid_layout and tout.scales == (DEALIAS, DEALIAS)
    _close(tout.data, jout.data)
    assert products.grid_product.launches == 0      # CPU tensors take the plain twin


EINSUMS = [   # (a shape, b shape, na, nb, contract, einsum)
    ((), (2,), 0, 1, False, 'xz,bxz->bxz'),
    ((2,), (2, 2), 1, 2, True, 'cxz,cbxz->bxz'),
    ((2, 2), (2,), 2, 1, True, 'acxz,cxz->axz'),
    ((3,), (3,), 1, 1, True, 'cxz,cxz->xz'),
    ((2,), (3,), 1, 1, False, 'axz,bxz->abxz'),
]


@pytest.mark.parametrize('case', range(len(EINSUMS)))
@pytest.mark.parametrize('alpha', [1.0, -0.75])
def test_plain_twin_matches_einsum(case, alpha):
    ta, tb, na, nb, contract, spec = EINSUMS[case]
    rng = np.random.default_rng(case)
    a = rng.standard_normal(ta + (6, 5))
    b = rng.standard_normal(tb + (6, 5))
    got = products.grid_product(torch.as_tensor(a), torch.as_tensor(b), na, nb, contract, alpha)
    _close(got, alpha * np.einsum(spec, a, b), 4e-16)


def test_plain_twin_broadcasts_size_one_grid_axes():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((2, 1, 5))
    b = rng.standard_normal((2, 3, 6, 1))
    got = products.grid_product(torch.as_tensor(a), torch.as_tensor(b), 1, 2, True)
    _close(got, np.einsum('cxz,cbxz->bxz', np.broadcast_to(a, (2, 6, 5)),
                          np.broadcast_to(b, (2, 3, 6, 5))), 4e-16)
    assert tuple(got.shape) == (3, 6, 5)
