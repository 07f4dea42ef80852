"""Conditioned equations and the banded LBVP in the PyTorch port, against
dedalus_tpu.

The conditioned heat IVP of tests/test_ivp.py:806-840 and the conditioned
LBVPs of tests/test_lbvp.py:119-138 and :140-168, each against its exact
answer and the JAX package's; kernel K3's conditioned gather (its plain
twin) against the JAX package's gather_eq_data on the same equation data,
exactly; the matsolver a conditioned pencil steps with when 'banded' is
named (it has no banded plan, so the stepper moves on to 'poly'); and the
LBVP under 'banded', refused on dense-sized stacks with a ValueError and
solved past [memory] max_dense_stack_gb, against the JAX package's 'lu'
(the JAX package's own banded LBVP fails with a KeyError, ROADMAP queue
3). Everything runs on the CPU, where the port's wrappers take their plain
twins.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.utils.config import config as tconfig

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


def _dkw(d3):
    return {} if d3 is jd3 else dict(device='cpu')


def _np(d3, a):
    return np.asarray(a) if d3 is jd3 else a.numpy()


def heat_ivp(d3, matsolver=None):
    """tests/test_ivp.py:806-840: the mean mode pinned by an algebraic gauge
    whose condition complements the dt equation's."""
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, **_dkw(d3))
    xb = d3.RealFourier(c, size=32, bounds=(0, 2 * np.pi))
    u = dist.Field(name='u', bases=xb)
    f = dist.Field(name='f', bases=xb)
    x = np.asarray(dist.local_grid(xb, scale=1)).ravel()
    f['g'] = np.cos(3 * x) + 0.7
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.IVP([u], namespace=locals())
    problem.add_equation("dt(u) - dx(dx(u)) = f", condition="nx != 0")
    problem.add_equation("u = 0", condition="nx == 0")
    kw = {} if matsolver is None else dict(matsolver=matsolver)
    solver = problem.build_solver(d3.SBDF2, **kw)
    u['g'] = np.sin(x) + 2.0
    step, n = 1e-3, 100
    solver.run_steps(step, n)
    t = n * step
    expect = np.exp(-t) * np.sin(x) + (1 - np.exp(-9 * t)) / 9 * np.cos(3 * x)
    u.change_scales(1)
    return _np(d3, u['g']), expect, solver


def test_conditioned_ivp_matches_exact_and_reference():
    ref, _, _ = heat_ivp(jd3)
    got, expect, solver = heat_ivp(td3)
    assert solver.pencil.eq_active is not None
    assert np.abs(got - expect).max() < 5e-5
    assert abs(got.mean()) < 1e-13
    assert np.abs(got - ref).max() <= 1e-12


def test_banded_on_a_conditioned_pencil_moves_on():
    """A conditioned pencil has no banded plan: 'banded' gives way to 'poly'
    (the escalation order of dedalus_tpu/core/timesteppers.py:446-465,
    whose banded_operator fails with a TypeError before it), and the run
    matches the JAX package's under the matsolver the port ends on."""
    got, expect, solver = heat_ivp(td3, matsolver='banded')
    assert solver.pencil.banded_plan() is None
    assert solver.matsolver == 'poly'
    ref, _, _ = heat_ivp(jd3, matsolver=solver.matsolver)
    assert np.abs(got - expect).max() < 5e-5
    assert np.abs(got - ref).max() <= 1e-12


def fourier_lbvp(d3):
    """tests/test_lbvp.py:119-138: the fully Fourier Poisson problem with a
    gauge on the mean mode."""
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, **_dkw(d3))
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
    return _np(d3, u['g']), np.sin(x) + np.cos(2 * x)


def mean_bc_lbvp(d3, build_only=False):
    """tests/test_lbvp.py:140-168: conditioned boundary rows merged into one
    block beside unconditioned equations, on a coupled-axis problem."""
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **_dkw(d3))
    xb = d3.RealFourier(coords['x'], size=16, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords['z'], size=24, bounds=(0, 1))
    u = dist.Field(name='u', bases=(xb, zb))
    tau1 = dist.Field(name='tau1', bases=xb)
    tau2 = dist.Field(name='tau2', bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)
    integz = lambda A: d3.Integrate(A, coords['z'])
    x, z = dist.local_grids(xb, zb, scales=1)
    x, z = np.asarray(x), np.asarray(z)
    F = dist.Field(name='F', bases=(xb, zb))
    F['g'] = -4 * np.sin(2 * x) * z * (1 - z) - 2 * np.sin(2 * x) + 2
    problem = d3.LBVP([u, tau1, tau2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau1,-1) + lift(tau2,-2) = F")
    problem.add_equation("u(z=0) = 0", condition="nx != 0")
    problem.add_equation("integz(u) = 0", condition="nx == 0")
    problem.add_equation("u(z=1) = 0")
    solver = problem.build_solver()
    if build_only:
        return solver
    solver.solve()
    u.change_scales(1)
    return _np(d3, u['g']), np.sin(2 * x) * z * (1 - z) + z**2 - 4 * z / 3 + 1 / 3


@pytest.mark.parametrize('case', [fourier_lbvp, mean_bc_lbvp])
def test_conditioned_lbvp_matches_exact_and_reference(case):
    ref, _ = case(jd3)
    got, exact = case(td3)
    assert np.abs(got - exact).max() < 1e-12
    assert np.abs(got - ref).max() <= 1e-12


def test_conditioned_layout_matches_reference():
    """The merged row blocks, the activity and the masks of the pencils."""
    js, ts = mean_bc_lbvp(jd3, build_only=True), mean_bc_lbvp(td3, build_only=True)
    jp, tp = js.pencil, ts.pencil
    np.testing.assert_array_equal(tp.eq_active, jp.eq_active)
    np.testing.assert_array_equal(tp.eq_offsets, jp.eq_offsets)
    np.testing.assert_array_equal(tp.row_valid, np.asarray(jp.row_valid)[:jp.G_real])
    np.testing.assert_array_equal(tp.col_valid, np.asarray(jp.col_valid)[:jp.G_real])
    for name in ('L',):
        for g in range(tp.G):
            Aj = jp.matrices_scipy[name][g].toarray()
            At = tp.matrices_scipy[name][g].toarray()
            assert np.abs(At - Aj).max() <= 1e-14 * max(1.0, np.abs(Aj).max()), g


def test_k3_conditioned_gather_matches_reference_exactly():
    """K3's conditioned twin against dedalus_tpu's gather_eq_data on the
    same numpy-seeded equation data."""
    from dedalus_tpu_torch.core import subsystems as sub
    js, ts = mean_bc_lbvp(jd3, build_only=True), mean_bc_lbvp(td3, build_only=True)
    rng = np.random.default_rng(17)
    shapes = [(16, 24), (16, 1), (16, 1), (16, 1)]
    datas = [rng.standard_normal(s) for s in shapes]
    ref = np.asarray(js.pencil.gather_eq_data([d for d in datas]))[:js.pencil.G_real]
    got = ts.pencil.gather_eq_data([torch.as_tensor(d) for d in datas])
    assert ts.pencil.eq_gather.code is not None
    np.testing.assert_array_equal(got.numpy(), ref)
    # the plain twin is what the wrapper ran, and the kernel's table (each
    # entry's source and index, an invalid entry's code complemented) agrees
    gm = ts.pencil.eq_gather
    plain = sub.pencil_gather_plain(gm, [torch.as_tensor(d).reshape(-1) for d in datas])
    np.testing.assert_array_equal(plain.numpy(), ref)
    flat = [d.reshape(-1) for d in datas]
    code = gm.code.numpy().astype(np.int64)
    keep = code >= 0
    u = np.where(keep, code, ~code)
    src, idx = u >> gm.jbits, u & ((1 << gm.jbits) - 1)
    table = np.array([[flat[e][j] for e, j in zip(srow, irow)] for srow, irow in
                      zip(src, idx)]) * keep
    np.testing.assert_array_equal(table, ref)


def poisson(d3, matsolver, Nx=32, Nz=24):
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **_dkw(d3))
    xb = d3.RealFourier(coords['x'], size=Nx, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords['z'], size=Nz, bounds=(0, 1))
    u = dist.Field(name='u', bases=(xb, zb))
    tau1 = dist.Field(name='tau1', bases=xb)
    tau2 = dist.Field(name='tau2', bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)
    x, z = dist.local_grids(xb, zb, scales=1)
    x, z = np.asarray(x), np.asarray(z)
    F = dist.Field(name='F', bases=(xb, zb))
    F['g'] = -4 * np.sin(2 * x) * z * (1 - z) - 2 * np.sin(2 * x)
    problem = d3.LBVP([u, tau1, tau2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau1,-1) + lift(tau2,-2) = F")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("u(z=1) = 0")
    solver = problem.build_solver(matsolver=matsolver)
    solver.solve()
    u.change_scales(1)
    return _np(d3, u['g']), np.sin(2 * x) * z * (1 - z), solver


@pytest.fixture
def lazy_stacks():
    old = (tconfig.get('memory', 'max_dense_stack_gb'),
           tconfig.get('matrix assembly', 'sampled_min_groups'))
    tconfig.set('memory', 'max_dense_stack_gb', '0')
    tconfig.set('matrix assembly', 'sampled_min_groups', '8')
    yield
    tconfig.set('memory', 'max_dense_stack_gb', old[0])
    tconfig.set('matrix assembly', 'sampled_min_groups', old[1])


def test_banded_lbvp_matches_reference(lazy_stacks):
    got, exact, solver = poisson(td3, 'banded')
    assert solver.pencil.matrices['L'] is None
    assert solver.pencil.separable is not None
    assert solver._factorized.banded is not None
    ref, _, _ = poisson(jd3, 'lu')
    assert np.abs(got - exact).max() < 1e-12
    assert np.abs(got - ref).max() <= 1e-11


def test_banded_lbvp_refuses_dense_stacks():
    with pytest.raises(ValueError, match='banded'):
        poisson(td3, 'banded', Nx=8, Nz=16)
