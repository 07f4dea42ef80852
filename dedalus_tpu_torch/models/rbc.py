"""
2D Rayleigh-Benard convection model (the port of dedalus_tpu/models/rbc.py,
with an explicit torch device).
"""

import numpy as np

import dedalus_tpu_torch.public as d3


def build_rbc_problem(Nx, Nz, Rayleigh=1e6, Prandtl=1.0, Lx=4.0, Lz=1.0, dealias=1.5,
                      device=None):
    """Standard RBC IVP (reference examples/ivp_2d_rayleigh_benard); every
    field and solver array lives on `device` (default: the current CUDA
    card; pass device='cpu' for the CPU)."""
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    xbasis = d3.RealFourier(coords['x'], size=Nx, bounds=(0, Lx), dealias=dealias)
    zbasis = d3.ChebyshevT(coords['z'], size=Nz, bounds=(0, Lz), dealias=dealias)
    p = dist.Field(name='p', bases=(xbasis, zbasis))
    b = dist.Field(name='b', bases=(xbasis, zbasis))
    u = dist.VectorField(coords, name='u', bases=(xbasis, zbasis))
    tau_p = dist.Field(name='tau_p')
    tau_b1 = dist.Field(name='tau_b1', bases=xbasis)
    tau_b2 = dist.Field(name='tau_b2', bases=xbasis)
    tau_u1 = dist.VectorField(coords, name='tau_u1', bases=xbasis)
    tau_u2 = dist.VectorField(coords, name='tau_u2', bases=xbasis)
    kappa = (Rayleigh * Prandtl)**(-1/2)
    nu = (Rayleigh / Prandtl)**(-1/2)
    ex, ez = coords.unit_vector_fields(dist)
    lift = lambda A: d3.Lift(A, zbasis.derivative_basis(1), -1)
    grad_u = d3.grad(u) + ez * lift(tau_u1)
    grad_b = d3.grad(b) + ez * lift(tau_b1)
    ns = dict(locals())
    problem = d3.IVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2], namespace=ns)
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*div(grad_b) + lift(tau_b2) = - u@grad(b)")
    problem.add_equation("dt(u) - nu*div(grad_u) + grad(p) - b*ez + lift(tau_u2) = - u@grad(u)")
    problem.add_equation("b(z=0) = Lz")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("b(z=Lz) = 0")
    problem.add_equation("u(z=Lz) = 0")
    problem.add_equation("integ(p) = 0")
    return problem, dict(coords=coords, dist=dist, xbasis=xbasis, zbasis=zbasis,
                         p=p, b=b, u=u, kappa=kappa, nu=nu, Lx=Lx, Lz=Lz,
                         dealias=dealias)


def initial_condition(ctx, seed=42, scale=1e-3):
    """The bench initial condition: seeded noise times z (Lz - z) on the
    linear conduction profile (the same draw as dedalus_tpu's fill_random)."""
    b = ctx['b']
    z = ctx['dist'].local_grid(ctx['zbasis'], scale=1)
    Lz = ctx['Lz']
    b.fill_random('g', seed=seed, distribution='normal', scale=scale)
    b['g'] = b.allgather_data('g') * z * (Lz - z) + (Lz - z)
