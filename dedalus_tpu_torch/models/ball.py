"""
The ball's convection problems as functions that build them, stepped with
SBDF2 on the default matsolver:

  * build_ball_problem: the JAX bench's ball convection, internally heated
    Boussinesq convection in the unit ball with no-slip, fixed-temperature
    walls (dedalus_tpu/models/ball.py, the 3-D leg of bench.py), with its
    equations, parameters and initial condition;
  * build_ball_ihc_problem: the repository's internally heated convection
    example (examples/ivp_ball_internally_heated_convection.py, the copy of
    upstream Dedalus's internally_heated_convection.py): a stress-free,
    no-penetration wall with a fixed heat flux, the buoyancy r_vec*T on the
    left-hand side (a ball tensor NCC) and -cross(curl(u), u) in F, with
    the example's initial condition (set_ihc_ic) and GlobalFlowProperty
    (add_ihc_flow_property); its HDF5 snapshots are left out.

`device` goes to the Distributor (default: the current CUDA card; pass
device='cpu' for the CPU). The example's functions take `d3`, the public
module to build with (this port's by default; dedalus_tpu.public builds the
JAX reference from the same lines).
"""

import numpy as np

import dedalus_tpu_torch.public as d3

# The example's timestep (SBDF2) and flow-property cadence
IHC_TIMESTEP = 2e-3
IHC_CADENCE = 50


def build_ball_problem(Nphi, Ntheta, Nr, Rayleigh=1e4, Prandtl=1.0, dealias=3 / 2,
                       dtype=np.float64, device=None):
    """The ball convection IVP: (problem, ctx)."""
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    kw = {} if device is None else dict(device=device)
    dist = d3.Distributor(coords, dtype=dtype, **kw)
    ball = d3.BallBasis(coords, shape=(Nphi, Ntheta, Nr), radius=1, dealias=dealias,
                        dtype=dtype)
    u = dist.VectorField(coords, name='u', bases=ball)
    p = dist.Field(name='p', bases=ball)
    T = dist.Field(name='T', bases=ball)
    tau_p = dist.Field(name='tau_p')
    tau_u = dist.VectorField(coords, name='tau_u', bases=ball.surface)
    tau_T = dist.Field(name='tau_T', bases=ball.surface)
    phi, theta, r = dist.local_grids(ball, scales=1)
    r_vec = dist.VectorField(coords, name='r_vec', bases=ball)
    r_vec.change_scales(1)
    rv = np.zeros((3, Nphi, Ntheta, Nr))
    rv[2] = r
    r_vec.preset_data(dist.grid_layout, rv)
    T_source = 6
    kappa = (Rayleigh * Prandtl)**(-1 / 2)
    nu = (Rayleigh / Prandtl)**(-1 / 2)
    lift = lambda A: d3.Lift(A, ball, -1)
    problem = d3.IVP([p, u, T, tau_p, tau_u, tau_T], namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("dt(u) - nu*lap(u) + grad(p) + lift(tau_u) = - u@grad(u) + r_vec*T")
    problem.add_equation("dt(T) - kappa*lap(T) + lift(tau_T) = - u@grad(T) + kappa*T_source")
    problem.add_equation("u(r=1) = 0")
    problem.add_equation("T(r=1) = 0")
    problem.add_equation("integ(p) = 0")
    return problem, dict(locals())


def set_conductive_ic(ctx, seed=42, scale=0.01):
    """T = 1 - r^2 plus seeded noise on the grid (the JAX package's)."""
    T, dist, r = ctx['T'], ctx['dist'], ctx['r']
    Nphi, Ntheta, Nr = ctx['Nphi'], ctx['Ntheta'], ctx['Nr']
    T.fill_random('g', seed=seed, distribution='normal', scale=scale)
    T.change_scales(1)
    T.require_grid_space()
    cond = np.broadcast_to(1 - r**2, (Nphi, Ntheta, Nr)).copy()
    T.preset_data(dist.grid_layout, T.data + T.data.new_tensor(cond))
    T.require_coeff_space()


def build_ball_ihc_problem(Nphi, Ntheta, Nr, Rayleigh=1e4, Prandtl=1, dealias=3 / 2,
                           dtype=np.float64, device=None, d3=d3):
    """The internally heated convection example's IVP: (problem, ctx)."""
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    kw = {} if device is None else dict(device=device)
    dist = d3.Distributor(coords, dtype=dtype, **kw)
    ball = d3.BallBasis(coords, shape=(Nphi, Ntheta, Nr), radius=1, dealias=dealias,
                        dtype=dtype)
    u = dist.VectorField(coords, name='u', bases=ball)
    p = dist.Field(name='p', bases=ball)
    T = dist.Field(name='T', bases=ball)
    tau_p = dist.Field(name='tau_p')
    tau_u = dist.VectorField(coords, name='tau_u', bases=ball.surface)
    tau_T = dist.Field(name='tau_T', bases=ball.surface)
    phi, theta, r = dist.local_grids(ball, scales=1)
    # The position vector, set on the grid: only its radial component, r
    r_vec = dist.VectorField(coords, name='r_vec', bases=ball)
    r_vec.change_scales(1)
    rv = np.zeros((3, Nphi, Ntheta, Nr))
    rv[2] = r
    r_vec['g'] = rv
    T_source = 6
    kappa = (Rayleigh * Prandtl)**(-1 / 2)
    nu = (Rayleigh / Prandtl)**(-1 / 2)
    lift = lambda A: d3.Lift(A, ball, -1)
    strain_rate = d3.grad(u) + d3.TransposeComponents(d3.grad(u))
    shear_stress = d3.AngularComponent(d3.RadialComponent(strain_rate(r=1), 0), 0)
    radial = d3.RadialComponent
    problem = d3.IVP([p, u, T, tau_p, tau_u, tau_T], namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation(
        "dt(u) - nu*lap(u) + grad(p) - r_vec*T + lift(tau_u) = - cross(curl(u),u)")
    problem.add_equation(
        "dt(T) - kappa*lap(T) + lift(tau_T) = - u@grad(T) + kappa*T_source")
    problem.add_equation("shear_stress = 0")
    problem.add_equation("radial(u(r=1)) = 0")
    problem.add_equation("radial(grad(T)(r=1)) = -2")
    problem.add_equation("integ(p) = 0")
    return problem, dict(locals())


def set_ihc_ic(ctx, seed=42):
    """The example's initial temperature: seeded normal noise of scale 0.01
    on the grid plus the conductive profile 1 - r^2."""
    T, r = ctx['T'], ctx['r']
    Nphi, Ntheta, Nr = ctx['Nphi'], ctx['Ntheta'], ctx['Nr']
    T.fill_random('g', seed=seed, distribution='normal', scale=0.01)
    T.change_scales(1)
    T['g'] = T.allgather_data('g') + np.broadcast_to(1 - r**2, (Nphi, Ntheta, Nr)).copy()


def add_ihc_flow_property(solver, ctx, cadence=IHC_CADENCE):
    """The example's GlobalFlowProperty: u@u every 50 iterations."""
    flow = ctx['d3'].GlobalFlowProperty(solver, cadence=cadence)
    flow.add_property(ctx['u'] @ ctx['u'], name='u2')
    return flow


def ihc_residuals(ctx):
    """Max |coefficient| of radial(u(r=1)), div(u) and the shear stress at
    r=1, evaluated on the current state (floats)."""
    d3, u = ctx['d3'], ctx['u']
    out = []
    for expr in (d3.RadialComponent(u(r=1)), d3.div(u), ctx['shear_stress']):
        f = expr.evaluate()
        f.require_coeff_space()
        out.append(float(np.abs(_numpy(f.allgather_data())).max()))
    return out


def _numpy(data):
    """A field's data as numpy (a torch tensor or the JAX package's array)."""
    return data.detach().cpu().numpy() if hasattr(data, 'detach') else np.asarray(data)


def ihc_wall_flux(ctx):
    """The coefficients of radial(grad(T)(r=1)) on the current state, as
    numpy: the fixed-flux wall, held at -2 in the ell = 0 coefficient."""
    f = ctx['d3'].RadialComponent(ctx['d3'].grad(ctx['T'])(r=1)).evaluate()
    f.require_coeff_space()
    return _numpy(f.allgather_data())
