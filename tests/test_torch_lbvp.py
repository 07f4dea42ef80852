"""Cartesian LBVPs on the PyTorch port against dedalus_tpu: the cases of
tests/test_lbvp.py that need no unported operator (1-D Chebyshev, 2-D
Fourier-Chebyshev with Dirichlet rows, the pure Neumann problem with an
integral gauge, a 1-D NCC problem) and the Poisson example
(examples/lbvp_2d_poisson.py, at 64x32) with its boundary-condition error,
built by the same lines in both packages on the default dense matsolver.
The solutions are held to the reference's within 1e-11 (its own tests
allow 1e-11 to 1e-12 against the analytic solutions, which are held too),
the L stacks and masks are equal."""

import numpy as np
import pytest
import torch

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


def poisson_1d(d3, **dkw):
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, **dkw)
    xb = d3.ChebyshevT(c, size=32, bounds=(0, 1))
    u = dist.Field(name='u', bases=xb)
    t1 = dist.Field(name='t1')
    t2 = dist.Field(name='t2')
    f = dist.Field(name='f', bases=xb)
    x = dist.local_grid(xb, scale=1).ravel()
    f['g'] = -np.pi**2 * np.sin(np.pi * x)
    lift = lambda A, n: d3.Lift(A, xb.derivative_basis(2), n)
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.LBVP([u, t1, t2], namespace=locals())
    problem.add_equation("dx(dx(u)) + lift(t1,-1) + lift(t2,-2) = f")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation("u(x=1) = 1")
    return problem, u, np.sin(np.pi * x) + x, 1e-11


def _fc_bases(d3, Nx, Nz, dkw):
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    xb = d3.RealFourier(coords['x'], size=Nx, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords['z'], size=Nz, bounds=(0, 1))
    return coords, dist, xb, zb


def poisson_2d(d3, Nx=32, Nz=32, **dkw):
    coords, dist, xb, zb = _fc_bases(d3, Nx, Nz, dkw)
    u = dist.Field(name='u', bases=(xb, zb))
    tau1 = dist.Field(name='tau1', bases=xb)
    tau2 = dist.Field(name='tau2', bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)
    x, z = dist.local_grids(xb, zb, scales=1)
    F = dist.Field(name='F', bases=(xb, zb))
    F['g'] = -4 * np.sin(2 * x) * z * (1 - z) - 2 * np.sin(2 * x)
    problem = d3.LBVP([u, tau1, tau2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau1,-1) + lift(tau2,-2) = F")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("u(z=1) = 0")
    return problem, u, np.sin(2 * x) * z * (1 - z), 1e-12


def poisson_2d_small(d3, **dkw):
    return poisson_2d(d3, 16, 24, **dkw)


def neumann_gauge(d3, **dkw):
    coords, dist, xb, zb = _fc_bases(d3, 16, 32, dkw)
    u = dist.Field(name='u', bases=(xb, zb))
    tau1 = dist.Field(name='tau1', bases=xb)
    tau2 = dist.Field(name='tau2', bases=xb)
    tau3 = dist.Field(name='tau3')
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)
    dz = lambda A: d3.Differentiate(A, coords['z'])
    x, z = dist.local_grids(xb, zb, scales=1)
    F = dist.Field(name='F', bases=(xb, zb))
    F['g'] = -(1 + np.pi**2) * np.cos(x) * np.cos(np.pi * z)
    problem = d3.LBVP([u, tau1, tau2, tau3], namespace=locals())
    problem.add_equation("lap(u) + lift(tau1,-1) + lift(tau2,-2) + tau3 = F")
    problem.add_equation("dz(u)(z=0) = 0")
    problem.add_equation("dz(u)(z=1) = 0")
    problem.add_equation("integ(u) = 0")
    return problem, u, np.cos(x) * np.cos(np.pi * z), 1e-11


def ncc_1d(d3, **dkw):
    c = d3.Coordinate('z')
    dist = d3.Distributor(c, dtype=np.float64, **dkw)
    zb = d3.ChebyshevT(c, size=48, bounds=(0, 1))
    u = dist.Field(name='u', bases=zb)
    t1 = dist.Field(name='t1')
    t2 = dist.Field(name='t2')
    ncc = dist.Field(name='ncc', bases=zb)
    z = dist.local_grid(zb, scale=1).ravel()
    ncc['g'] = 2 + z
    # u = sin(2z)(1-z)z with its second derivative written out
    uex = np.sin(2 * z) * (1 - z) * z
    upp = -4 * np.sin(2 * z) * (z - z**2) + 4 * np.cos(2 * z) * (1 - 2 * z) - 2 * np.sin(2 * z)
    f = dist.Field(name='f', bases=zb)
    f['g'] = (2 + z) * upp + uex
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)
    dz = lambda A: d3.Differentiate(A, c)
    problem = d3.LBVP([u, t1, t2], namespace=locals())
    problem.add_equation("ncc*dz(dz(u)) + u + lift(t1,-1) + lift(t2,-2) = f")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("u(z=1) = 0")
    return problem, u, uex, 1e-11


CASES = dict(poisson_1d=poisson_1d, poisson_2d=poisson_2d, poisson_2d_small=poisson_2d_small,
             neumann_gauge=neumann_gauge, ncc_1d=ncc_1d)


@pytest.fixture(scope='module', params=sorted(CASES))
def solved(request):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jp, ju, exact, tol = CASES[request.param](jd3)
    tp, tu, _, _ = CASES[request.param](td3, device='cpu')
    js, ts = jp.build_solver(), tp.build_solver()
    js.solve()
    ts.solve()
    return js, ts, ju, tu, exact, tol


def test_lbvp_stack_and_masks_equal(solved):
    js, ts = solved[:2]
    assert ts.matsolver == js.matsolver == 'inverse_refined'
    np.testing.assert_array_equal(ts.pencil.row_valid, js.pencil.row_valid)
    np.testing.assert_array_equal(ts.pencil.col_valid, js.pencil.col_valid)
    got, ref = ts.pencil.matrices['L'].numpy(), np.asarray(js.pencil.matrices['L'])
    if 'ncc' in ts.problem.namespace:
        # The NCC's coefficients come from a forward transform on each side
        assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
    else:
        np.testing.assert_array_equal(got, ref)


def test_lbvp_solution_matches_reference(solved):
    js, ts, ju, tu, exact, tol = solved
    ref, got = np.asarray(js.state_flat()), ts.state_flat().numpy()
    assert np.abs(got - ref).max() <= 1e-11 * max(1.0, np.abs(ref).max())


def test_lbvp_solution_is_analytic(solved):
    js, ts, ju, tu, exact, tol = solved
    tu.change_scales(1)
    assert np.abs(tu['g'].numpy() - exact).max() < tol


def test_lbvp_second_solve_reuses_the_factorization(solved):
    """The factorization is kept between solves, and the same right-hand
    side gives the same state bit for bit."""
    js, ts, ju, tu, exact, tol = solved
    fact = ts._factorized
    ts.solve()
    before = ts.state_flat().clone()
    ts.solve()
    assert ts._factorized is fact
    assert torch.equal(ts.state_flat(), before)


def _poisson_example(d3, Nx=64, Ny=32, **dkw):
    """examples/lbvp_2d_poisson.py at a reduced size: (solver, u, g, Ly)."""
    Lx, Ly = 2 * np.pi, np.pi
    coords = d3.CartesianCoordinates('x', 'y')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    xbasis = d3.RealFourier(coords['x'], size=Nx, bounds=(0, Lx))
    ybasis = d3.ChebyshevT(coords['y'], size=Ny, bounds=(0, Ly))
    u = dist.Field(name='u', bases=(xbasis, ybasis))
    tau_1 = dist.Field(name='tau_1', bases=xbasis)
    tau_2 = dist.Field(name='tau_2', bases=xbasis)
    f = dist.Field(name='f', bases=(xbasis, ybasis))
    g = dist.Field(name='g', bases=xbasis)
    x, y = dist.local_grids(xbasis, ybasis, scales=1)
    f['g'] = -10 * np.sin(x / 2)**2 * (y - y**2 / 4)
    g['g'] = np.sin(8 * x)
    dy = lambda A: d3.Differentiate(A, coords['y'])
    lift_basis = ybasis.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)
    problem = d3.LBVP([u, tau_1, tau_2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau_1,-1) + lift(tau_2,-2) = f")
    problem.add_equation("u(y=0) = g")
    problem.add_equation("dy(u)(y=Ly) = 0")
    solver = problem.build_solver()
    solver.solve()
    return solver, u, g, dy, Ly


def test_poisson_example_matches_reference_and_its_boundary_conditions():
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    js, ju, _, _, _ = _poisson_example(jd3)
    ts, tu, g, dy, Ly = _poisson_example(td3, device='cpu')
    ref, got = np.asarray(js.state_flat()), ts.state_flat().numpy()
    assert np.abs(got - ref).max() <= 1e-11 * max(1.0, np.abs(ref).max())
    ub = tu(y=0).evaluate()
    ub.change_scales(1)
    g.change_scales(1)
    assert float((ub['g'] - g['g']).abs().max()) < 1e-11       # the example's BC error
    top = dy(tu)(y=Ly).evaluate()
    assert float(top['g'].abs().max()) < 1e-10


@pytest.mark.parametrize('name', ['skew', 'ave_all', 'ave_z', 'ave_system'])
def test_cartesian_skew_and_average_match_reference(name):
    """The Cartesian branches of the skew and ave factories (their S2
    branches are held in tests/test_torch_sphere_basis.py)."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    ops = dict(skew=lambda d3, cs, u: d3.skew(u),
               ave_all=lambda d3, cs, u: d3.ave(u),
               ave_z=lambda d3, cs, u: d3.ave(u, cs['z']),
               ave_system=lambda d3, cs, u: d3.ave(u, cs))
    outs = []
    for d3, dkw in ((jd3, {}), (td3, dict(device='cpu'))):
        coords, dist, xb, zb = _fc_bases(d3, 12, 10, dkw)
        u = dist.VectorField(coords, name='u', bases=(xb, zb))
        u['c'] = np.random.default_rng(4).standard_normal((2, 12, 10))
        out = ops[name](d3, coords, u).evaluate()
        out.require_coeff_space()
        outs.append(np.asarray(out.data) if d3 is jd3 else out.data.numpy())
    assert outs[0].shape == outs[1].shape
    assert np.abs(outs[1] - outs[0]).max() <= 1e-14 * max(1.0, np.abs(outs[0]).max())


def test_conditioned_equations_are_not_ported():
    """Conditioned equations are ported now (this test once held their
    refusal): the conditioned Poisson problem of tests/test_lbvp.py:119-138
    on the port matches the JAX package's and the exact solution."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    outs = []
    for d3, dkw in ((jd3, {}), (td3, dict(device='cpu'))):
        c = d3.Coordinate('x')
        dist = d3.Distributor(c, dtype=np.float64, **dkw)
        xb = d3.RealFourier(c, size=32, bounds=(0, 2 * np.pi))
        u = dist.Field(name='u', bases=xb)
        f = dist.Field(name='f', bases=xb)
        x = np.asarray(dist.local_grid(xb, scale=1)).ravel()
        f['g'] = -np.sin(x) - 4 * np.cos(2 * x)
        dx = lambda A: d3.Differentiate(A, c)
        problem = d3.LBVP([u], namespace=locals())
        problem.add_equation("dx(dx(u)) = f", condition="nx != 0")
        problem.add_equation("u = 0", condition="nx == 0")
        solver = problem.build_solver()
        solver.solve()
        u.change_scales(1)
        outs.append(np.asarray(u['g']) if d3 is jd3 else u['g'].numpy())
    assert np.abs(outs[1] - (np.sin(x) + np.cos(2 * x))).max() < 1e-12
    assert np.abs(outs[1] - outs[0]).max() <= 1e-12


def test_lbvp_defaults_to_the_card():
    import dedalus_tpu_torch.public as td3
    if torch.cuda.is_available():
        assert poisson_1d(td3)[1].dist.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            poisson_1d(td3)
