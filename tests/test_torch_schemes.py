"""The timestepping schemes and the run loops of the PyTorch port against
dedalus_tpu.

The heat equation under every registered scheme (the analogue of
tests/test_ivp.py:31-35, held to the exact solution and to the JAX
package's same scheme), SBDF2's second-order ratio, run_steps against the
step loop for the three- and four-step schemes and after a step at another
dt, the KdV-Burgers problem (models/kdv.py) at Nx=128 and the shear-flow
example (models/shear_flow.py) at 16x32 against the JAX package, evolve at
a float dt and with a CFL, the profile option, and the public exports.
Everything runs on the CPU, where the port's wrappers take their plain
twins; both packages build the same problem from the same numpy inputs.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

SCHEMES = ['CNAB1', 'SBDF1', 'CNAB2', 'MCNAB2', 'SBDF2', 'CNLF2', 'SBDF3', 'SBDF4',
           'RK111', 'RK222', 'RK443', 'RKSMR', 'RKGFY']


def _grid(d3, field):
    field.change_scales(1)
    return np.asarray(field['g']) if d3 is jd3 else field['g'].numpy()


def _dkw(d3):
    return {} if d3 is jd3 else dict(device='cpu')


def heat(d3, scheme, timestep, n_steps, Nx=16, nu=0.1, kmode=3):
    """(grid values, max error against the exact decay) after n_steps."""
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, **_dkw(d3))
    xb = d3.RealFourier(c, size=Nx, bounds=(0, 2 * np.pi), dealias=1.5)
    u = dist.Field(name='u', bases=xb)
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.IVP([u], namespace=locals())
    problem.add_equation("dt(u) - nu*dx(dx(u)) = 0")
    solver = problem.build_solver(scheme)
    x = np.asarray(dist.local_grid(xb, scale=1)).ravel()
    u['g'] = np.sin(kmode * x)
    for _ in range(n_steps):
        solver.step(timestep)
    g = _grid(d3, u)
    exact = np.exp(-nu * kmode**2 * n_steps * timestep) * np.sin(kmode * x)
    return g, np.abs(g - exact).max()


def test_every_scheme_is_registered_and_exported():
    assert list(td3.timestepper_schemes) == SCHEMES
    assert list(jd3.timestepper_schemes) == SCHEMES
    for name in SCHEMES:
        assert td3.timestepper_schemes[name] is getattr(td3, name)


@pytest.mark.parametrize('scheme', SCHEMES)
def test_heat_matches_exact_and_reference(scheme):
    ref, _ = heat(jd3, jd3.timestepper_schemes[scheme], 1e-3, 50)
    # by name, as build_solver('SBDF3') is called
    got, err = heat(td3, scheme, 1e-3, 50)
    assert err < 5e-5
    assert np.abs(got - ref).max() <= 1e-12


def test_sbdf2_second_order_convergence():
    _, e1 = heat(td3, td3.SBDF2, 2e-3, 50)
    _, e2 = heat(td3, td3.SBDF2, 1e-3, 100)
    assert 3.5 < e1 / e2 < 4.5


def _burgers(scheme, mode):
    c = td3.Coordinate('x')
    dist = td3.Distributor(c, dtype=np.float64, device='cpu')
    xb = td3.RealFourier(c, size=32, bounds=(0, 2 * np.pi), dealias=1.5)
    u = dist.Field(name='u', bases=xb)
    nu = 0.05
    dx = lambda A: td3.Differentiate(A, c)
    problem = td3.IVP([u], namespace=locals())
    problem.add_equation("dt(u) - nu*dx(dx(u)) = - u*dx(u)")
    solver = problem.build_solver(td3.timestepper_schemes[scheme])
    x = dist.local_grid(xb, scale=1).ravel()
    u['g'] = np.sin(x) + 0.3 * np.cos(2 * x)
    if mode == 'run':
        solver.run_steps(1e-3, 40)
    else:
        for _ in range(40):
            solver.step(1e-3)
    return _grid(td3, u), solver.sim_time


@pytest.mark.parametrize('scheme', ['SBDF3', 'SBDF4'])
def test_run_steps_matches_step_loop(scheme):
    """As tests/test_ivp.py:217-243, at history depths 3 and 4."""
    a, ta = _burgers(scheme, 'loop')
    b, tb = _burgers(scheme, 'run')
    assert abs(ta - tb) < 1e-14
    assert np.abs(a - b).max() < 1e-13


def test_run_steps_after_different_dt_step_sbdf3():
    """As tests/test_ivp.py:306-342 under SBDF3: run_steps after steps at
    another dt steps through the mixed history one step at a time."""
    Nx, nu, kmode = 16, 0.1, 3
    c = td3.Coordinate('x')
    dist = td3.Distributor(c, dtype=np.float64, device='cpu')
    xb = td3.RealFourier(c, size=Nx, bounds=(0, 2 * np.pi), dealias=1.5)

    def run(mode):
        dx = lambda A: td3.Differentiate(A, c)
        u = dist.Field(name='u', bases=xb)
        problem = td3.IVP([u], namespace=locals())
        problem.add_equation("dt(u) - nu*dx(dx(u)) = 0")
        solver = problem.build_solver(td3.SBDF3)
        x = dist.local_grid(xb, scale=1).ravel()
        u['g'] = np.sin(kmode * x)
        dt1, dt2 = 2e-3, 1e-3
        for _ in range(3):
            solver.step(dt1)
        if mode == 'mixed':
            solver.run_steps(dt2, 30)
        else:
            for _ in range(30):
                solver.step(dt2)
        T = 3 * dt1 + 30 * dt2
        exact = np.exp(-nu * kmode**2 * T) * np.sin(kmode * x)
        return np.abs(_grid(td3, u) - exact).max()

    err_mixed = run('mixed')
    err_loop = run('loop')
    assert err_mixed < 2 * err_loop + 1e-12


def _kdv(d3, scheme):
    if d3 is jd3:
        from dedalus_tpu.models.kdv import build_kdv_problem
    else:
        from dedalus_tpu_torch.models.kdv import build_kdv_problem
    problem, ctx = build_kdv_problem(Nx=128, **_dkw(d3))
    u = ctx['u']
    mass0 = float(_grid(d3, u).mean())
    solver = problem.build_solver(getattr(d3, scheme))
    for _ in range(200):
        solver.step(2e-3)
    return _grid(d3, u), mass0


@pytest.mark.parametrize('scheme', ['SBDF2', 'SBDF3'])
def test_kdv_burgers_matches_reference(scheme):
    """As tests/test_ivp.py:44-64 (Nx=128, 200 steps at dt 2e-3)."""
    ref, _ = _kdv(jd3, scheme)
    got, mass0 = _kdv(td3, scheme)
    assert np.isfinite(got).all()
    assert abs(got.mean() - mass0) < 1e-12
    assert np.abs(got - ref).max() <= 1e-12


def _shear(d3, scheme, Nx=16, Nz=32, steps=10):
    """examples/ivp_2d_shear_flow.py's problem and initial condition at
    Nx x Nz (the port's through models/shear_flow.py), `steps` steps at the
    example's dt; returns the flat state."""
    if d3 is jd3:
        coords = d3.CartesianCoordinates('x', 'z')
        dist = d3.Distributor(coords, dtype=np.float64)
        xbasis = d3.RealFourier(coords['x'], size=Nx, bounds=(0, 1), dealias=3 / 2)
        zbasis = d3.RealFourier(coords['z'], size=Nz, bounds=(-1, 1), dealias=3 / 2)
        p = dist.Field(name='p', bases=(xbasis, zbasis))
        s = dist.Field(name='s', bases=(xbasis, zbasis))
        u = dist.VectorField(coords, name='u', bases=(xbasis, zbasis))
        tau_p = dist.Field(name='tau_p')
        nu = 1 / 5e4
        D = nu / 1
        x, z = dist.local_grids(xbasis, zbasis, scales=1)
        problem = d3.IVP([u, s, p, tau_p], namespace=locals())
        problem.add_equation("dt(u) + grad(p) - nu*lap(u) = - u@grad(u)")
        problem.add_equation("dt(s) - D*lap(s) = - u@grad(s)")
        problem.add_equation("div(u) + tau_p = 0")
        problem.add_equation("integ(p) = 0")
        ug = np.zeros((2, Nx, Nz))
        ug[0] = np.broadcast_to(
            0.5 + 0.5 * (np.tanh((z - 0.5) / 0.1) - np.tanh((z + 0.5) / 0.1)), (Nx, Nz))
        ug[1] = 0.1 * np.sin(2 * np.pi * x / 1) * np.exp(-(z**2) / 0.01)
        u['g'] = ug
        s['g'] = np.broadcast_to(
            0.5 * (np.tanh((z - 0.5) / 0.1) - np.tanh((z + 0.5) / 0.1)) + 1, (Nx, Nz)).copy()
    else:
        from dedalus_tpu_torch.models.shear_flow import (build_shear_flow_problem,
                                                         set_initial_condition)
        problem, ctx = build_shear_flow_problem(Nx, Nz, device='cpu')
        set_initial_condition(ctx)
    solver = problem.build_solver(getattr(d3, scheme))
    solver.run_steps(1e-3, steps)
    state = solver.state_flat()
    return np.asarray(state) if d3 is jd3 else state.numpy()


@pytest.mark.parametrize('scheme', ['RK443', 'SBDF2', 'SBDF3'])
def test_shear_flow_matches_reference(scheme):
    ref = _shear(jd3, scheme)
    got = _shear(td3, scheme)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_shear_flow_property_is_finite():
    from dedalus_tpu_torch.models.shear_flow import (build_shear_flow_problem,
                                                     set_initial_condition, add_flow_property)
    problem, ctx = build_shear_flow_problem(8, 16, device='cpu')
    set_initial_condition(ctx)
    solver = problem.build_solver(td3.RK443)
    flow = add_flow_property(solver, ctx)
    solver.run_steps(1e-3, 3)
    assert np.isfinite(flow.max('Re_pt')) and flow.max('Re_pt') > 0


def _heat_solver(scheme=td3.SBDF2, **kw):
    c = td3.Coordinate('x')
    dist = td3.Distributor(c, dtype=np.float64, device='cpu')
    xb = td3.RealFourier(c, size=16, bounds=(0, 2 * np.pi), dealias=1.5)
    u = dist.Field(name='u', bases=xb)
    nu = 0.1
    dx = lambda A: td3.Differentiate(A, c)
    problem = td3.IVP([u], namespace=locals())
    problem.add_equation("dt(u) - nu*dx(dx(u)) = - u*dx(u)")
    solver = problem.build_solver(scheme, **kw)
    u['g'] = np.sin(3 * dist.local_grid(xb, scale=1).ravel())
    return solver, u


def test_evolve_float_dt_matches_step_loop():
    a, ua = _heat_solver(td3.SBDF3)
    a.stop_sim_time = 0.0205
    a.evolve(1e-3)
    b, ub = _heat_solver(td3.SBDF3)
    while b.sim_time < 0.0205:
        b.step(1e-3)
    assert a.iteration == b.iteration == 21
    assert np.abs(_grid(td3, ua) - _grid(td3, ub)).max() == 0.0
    # a callable dt takes the same steps
    c, uc = _heat_solver(td3.SBDF3)
    c.stop_iteration = 21
    c.evolve(lambda: 1e-3)
    assert np.abs(_grid(td3, uc) - _grid(td3, ub)).max() == 0.0


def test_evolve_cfl_matches_reference():
    """evolve(CFL) on RBC 32x16 with SBDF2 (the chunked loop, at a dt that
    moves) against the JAX package's evolve(CFL)."""
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    from dedalus_tpu_torch.utils.interop import set_state_from_reference
    Nx, Nz = 32, 16
    out = []
    for d3, build in ((jd3, jbuild), (td3, tbuild)):
        problem, ctx = build(Nx, Nz, Rayleigh=2e6, **_dkw(d3))
        solver = problem.build_solver(d3.SBDF2)
        solver.stop_sim_time = 0.3
        cfl = d3.CFL(solver, initial_dt=0.02, cadence=5, safety=0.5, threshold=0.05,
                     max_change=1.5, min_change=0.5, max_dt=0.05)
        cfl.add_velocity(ctx['u'])
        out.append((solver, ctx, cfl))
    (js, jctx, jcfl), (ts, tctx, tcfl) = out
    rng = np.random.default_rng(5)
    x = jctx['dist'].local_grid(jctx['xbasis'], scale=1)
    z = jctx['dist'].local_grid(jctx['zbasis'], scale=1)
    jctx['b']['g'] = (1 - z) + 1e-3 * rng.standard_normal((Nx, Nz)) * z * (1 - z)
    u = np.zeros((2, Nx, Nz))
    u[0] = 0.5 * np.sin(np.pi * z) * np.cos(2 * np.pi * x / jctx['Lx'])
    u[1] = 0.3 * np.sin(2 * np.pi * x / jctx['Lx']) * np.sin(np.pi * z)
    jctx['u']['g'] = u
    arrays = {}
    for f in js.state:
        f.require_coeff_space()
        f.change_scales(1)
        arrays[f.name] = np.array(f.data)
    set_state_from_reference(ts, arrays)
    js.evolve(jcfl)
    ts.evolve(tcfl)
    assert ts.iteration == js.iteration > 6
    assert abs(ts.sim_time - js.sim_time) <= 1e-14
    ref, got = np.asarray(js.state_flat()), ts.state_flat().numpy()
    assert np.abs(got - ref).max() <= 1e-11 * max(1.0, np.abs(ref).max())


def test_profile_writes_its_files(tmp_path):
    solver, _ = _heat_solver(profile=True, profile_dir=str(tmp_path / 'prof'))
    solver.stop_iteration = 5
    solver.evolve(1e-3)
    assert (tmp_path / 'prof' / 'runtime.prof').stat().st_size > 0
    assert (tmp_path / 'prof' / 'trace.json').stat().st_size > 0
