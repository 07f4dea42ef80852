"""The rest of the Cartesian operators on the PyTorch port against
dedalus_tpu, each side built by the same lines (device='cpu' for the port):

  * tests/test_operators.py::test_curl_skew_trace_transpose's analogue in
    2-D (the curl a scalar) with its closed forms, held to the JAX
    package's grid values (1e-12);
  * the 3-D curl and transpose on Fourier x Fourier x Chebyshev, against
    the JAX package's and the closed forms, and the curl's pencil matrices
    against the JAX package's;
  * HilbertTransform on RealFourier and ComplexFourier (H cos = sin,
    H sin = -cos) and its matrices;
  * Grid and Coeff: the layout and the scales they hand out;
  * tests/test_grid_operators.py::test_general_function's analogue;
  * the advective CFL frequency on Legendre and ChebyshevU axes (the Jacobi
    grid spacing) against the JAX package's;
  * sym_diff of the new operators against the JAX package's differential,
    evaluated.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3

torch.set_num_threads(1)

TOL = 1e-12
SIDES = ((jd3, {}), (td3, dict(device='cpu')))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def grid1(expr):
    f = expr.evaluate()
    f.change_scales(1)
    f.require_grid_space()
    return _np(f.data)


def _close(got, ref, tol=TOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), (err, np.abs(ref).max())


def _setup2d(d3, kw):
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    xb = d3.RealFourier(coords['x'], size=32, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords['z'], size=24, bounds=(0, 1))
    x, z = dist.local_grids(xb, zb, scales=1)
    return coords, dist, xb, zb, x, z


def _curl_etc(d3, kw):
    coords, dist, xb, zb, x, z = _setup2d(d3, kw)
    u = dist.VectorField(coords, name='u', bases=(xb, zb))
    data = np.zeros((2, 32, 24))
    data[0] = np.sin(x) * z
    data[1] = np.cos(x) * z**2
    u['g'] = data
    T = d3.grad(u, coords)
    return dict(x=x, z=z, data=data, curl=grid1(d3.curl(u)), skew=grid1(d3.skew(u)),
                trace=grid1(d3.trace(T)), T=grid1(T), transpose=grid1(d3.transpose(T)))


def test_curl_skew_trace_transpose():
    ref, got = [_curl_etc(d3, kw) for d3, kw in SIDES]
    x, z, data = got['x'], got['z'], got['data']
    assert np.allclose(got['curl'], -np.sin(x) * z**2 - np.sin(x), atol=1e-10)
    assert np.allclose(got['skew'][0], -data[1], atol=1e-12)
    assert np.allclose(got['skew'][1], data[0], atol=1e-12)
    assert np.allclose(got['trace'], np.cos(x) * z + 2 * np.cos(x) * z, atol=1e-10)
    assert np.allclose(got['transpose'], np.swapaxes(got['T'], 0, 1), atol=1e-12)
    for key in ('curl', 'skew', 'trace', 'transpose'):
        _close(got[key], ref[key])


def _setup3d(d3, kw):
    coords = d3.CartesianCoordinates('x', 'y', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    xb = d3.RealFourier(coords['x'], size=8, bounds=(0, 2 * np.pi))
    yb = d3.RealFourier(coords['y'], size=8, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords['z'], size=10, bounds=(0, 1))
    x, y, z = dist.local_grids(xb, yb, zb, scales=1)
    u = dist.VectorField(coords, name='u', bases=(xb, yb, zb))
    shape = (8, 8, 10)
    data = np.zeros((3,) + shape)
    data[0] = np.broadcast_to(np.sin(y) * z, shape)
    data[1] = np.broadcast_to(np.cos(x) * z**2, shape)
    data[2] = np.broadcast_to(np.sin(x) * np.cos(y), shape)
    u['g'] = data
    return coords, dist, u, (x, y, z)


def test_curl_and_transpose_3d():
    sides = []
    for d3, kw in SIDES:
        coords, dist, u, (x, y, z) = _setup3d(d3, kw)
        sides.append((grid1(d3.curl(u)), grid1(d3.transpose(d3.grad(u))), grid1(d3.grad(u))))
    (jc, jt, _), (tc, tt, tg) = sides
    shape = (8, 8, 10)
    exact = np.zeros((3,) + shape)
    # curl u = (dy u_z - dz u_y, dz u_x - dx u_z, dx u_y - dy u_x)
    exact[0] = np.broadcast_to(-np.sin(x) * np.sin(y) - 2 * np.cos(x) * z, shape)
    exact[1] = np.broadcast_to(np.sin(y) - np.cos(x) * np.cos(y), shape)
    exact[2] = np.broadcast_to(-np.sin(x) * z**2 - np.cos(y) * z, shape)
    assert np.abs(tc - exact).max() < 1e-10
    assert np.abs(tt - np.swapaxes(tg, 0, 1)).max() < 1e-12
    _close(tc, jc)
    _close(tt, jt)


def test_curl_3d_pencil_matrices_match_reference():
    from dedalus_tpu.core import subsystems as jsub
    from dedalus_tpu_torch.core import subsystems as tsub
    sides = []
    for (d3, kw), sub in zip(SIDES, (jsub, tsub)):
        coords, dist, u, _ = _setup3d(d3, kw)
        E = d3.curl(u)
        _, sps = sub.enumerate_subproblems(dist, [E.domain, u.domain],
                                           np.array([False, False, True]))
        sides.append([E.expression_matrices(sp, [u])[u].toarray() for sp in sps[:6]])
    for jm, tm in zip(*sides):
        _close(tm, jm, 1e-14)


@pytest.mark.parametrize('dtype', [np.float64, np.complex128])
def test_hilbert_transform(dtype):
    sides = []
    for d3, kw in SIDES:
        xc = d3.Coordinate('x')
        dist = d3.Distributor(xc, dtype=dtype, **kw)
        xb = d3.Fourier(xc, size=16, bounds=(0, 2 * np.pi), dtype=dtype)
        x = dist.local_grid(xb, scale=1).ravel()
        f = dist.Field(name='f', bases=xb)
        f['g'] = np.cos(2 * x) + 0.5 * np.sin(3 * x) + 0.25
        H = d3.HilbertTransform(f, xc)
        sides.append((grid1(H).ravel(), xb.hilbert_matrix().toarray()))
    (jh, jm), (th, tm) = sides
    exact = np.sin(2 * x) - 0.5 * np.cos(3 * x)
    assert np.abs(th - exact).max() < 1e-13
    _close(th, jh)
    assert np.array_equal(tm, jm)


def test_grid_and_coeff():
    """Grid hands out grid data at the dealias scales, Coeff coefficients at
    scale 1, whatever the operand's scales; both equal the JAX package's."""
    outs = []
    for d3, kw in SIDES:
        coords = d3.CartesianCoordinates('x', 'z')
        dist = d3.Distributor(coords, dtype=np.float64, **kw)
        xb = d3.RealFourier(coords['x'], size=16, bounds=(0, 2 * np.pi), dealias=1.5)
        zb = d3.ChebyshevT(coords['z'], size=12, bounds=(0, 1), dealias=1.5)
        x, z = dist.local_grids(xb, zb, scales=1)
        f = dist.Field(name='f', bases=(xb, zb))
        f['g'] = np.sin(x) * z**2
        f.change_scales(2)
        g = d3.Grid(f).evaluate()
        assert all(g.layout.grid_space) and g.scales == (1.5, 1.5)
        c = d3.Coeff(f).evaluate()
        assert not any(c.layout.grid_space) and c.scales == (1.0, 1.0)
        outs.append((_np(g.data), _np(c.data)))
        f.change_scales(1)
        _close(c.data, f['c'])
        g.change_scales(1)
        _close(g['g'], np.sin(x) * z**2)
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])


def test_general_function():
    outs = []
    for d3, kw in SIDES:
        xc = d3.Coordinate('x')
        dist = d3.Distributor(xc, dtype=np.float64, **kw)
        xb = d3.RealFourier(xc, size=32, bounds=(0, 2 * np.pi))
        x = dist.local_grid(xb, scale=1).ravel()
        f = dist.Field(name='f', bases=xb)
        f['g'] = np.sin(x)

        def custom(*args):
            return _np(args[0]['g'])**2 + 1.0
        w = d3.GeneralFunction(dist, f.domain, layout='g', tensorsig=(), dtype=np.float64,
                               func=custom, args=[f])
        out = w.evaluate()
        out.change_scales(1)
        outs.append(_np(out['g']).ravel())
        assert np.allclose(outs[-1], np.sin(x)**2 + 1.0)
    _close(outs[1], outs[0])


@pytest.mark.parametrize('kind', ['Legendre', 'ChebyshevU'])
def test_cfl_spacing_on_jacobi(kind):
    freqs = []
    for d3, kw in SIDES:
        coords = d3.CartesianCoordinates('x', 'z')
        dist = d3.Distributor(coords, dtype=np.float64, **kw)
        xb = d3.RealFourier(coords['x'], size=16, bounds=(0, 2 * np.pi), dealias=1.5)
        zb = getattr(d3, kind)(coords['z'], size=12, bounds=(0, 2), dealias=1.5)
        x, z = dist.local_grids(xb, zb, scales=1)
        u = dist.VectorField(coords, name='u', bases=(xb, zb))
        u['g'] = np.stack(np.broadcast_arrays(np.sin(x) * z, np.cos(x) + z**2))
        cfl = d3.AdvectiveCFL(u, coords).evaluate()
        cfl.change_scales(1.5)
        freqs.append(_np(cfl['g']))
    assert np.abs(freqs[0]).max() > 0
    _close(freqs[1], freqs[0])


def test_sym_diff_of_new_operators():
    """The Frechet differential of each new operator, evaluated on seeded
    fields, equals the JAX package's."""
    outs = {}
    for d3, kw in SIDES:
        coords, dist, xb, zb, x, z = _setup2d(d3, kw)
        u = dist.VectorField(coords, name='u', bases=(xb, zb))
        du = dist.VectorField(coords, name='du', bases=(xb, zb))
        rng = np.random.default_rng(3)
        u['g'] = np.stack([np.sin(x) * z, np.cos(x) * z**2])
        du['g'] = np.broadcast_to(rng.standard_normal((2, 1, 24)) * z, (2, 32, 24))
        c0, c1 = d3.Component(u, 0), d3.Component(u, 1)
        exprs = dict(curl=d3.curl(u * c0), transpose=d3.transpose(d3.grad(u) * c1),
                     hilbert=d3.HilbertTransform(c0 * c1, coords['x']),
                     grid=d3.Grid(c0 * c0), coeff=d3.Coeff(c1 * c1))
        outs[d3] = {k: grid1(e.sym_diff([u], [du])) for k, e in exprs.items()}
    for key in outs[jd3]:
        assert np.abs(outs[jd3][key]).max() > 0
        _close(outs[td3][key], outs[jd3][key])
