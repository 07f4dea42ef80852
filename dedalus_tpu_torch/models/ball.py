"""
The JAX bench's ball convection as functions that build its problem:
internally heated Boussinesq convection in the unit ball with no-slip,
fixed-temperature walls (dedalus_tpu/models/ball.py, the 3-D leg of
bench.py), stepped with SBDF2 on the default matsolver.

The equations, parameters and initial condition are those of
dedalus_tpu/models/ball.py. `device` goes to the Distributor (default: the
current CUDA card; pass device='cpu' for the CPU).
"""

import numpy as np

import dedalus_tpu_torch.public as d3


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
