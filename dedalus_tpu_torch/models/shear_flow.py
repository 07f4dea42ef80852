"""
2D periodic shear flow with a passive tracer: the problem, initial condition
and flow property of examples/ivp_2d_shear_flow.py (doubly periodic
incompressible Navier-Stokes with two tanh shear layers, the pressure gauge
through tau_p), without its snapshot file handler, with an explicit torch
device.
"""

import numpy as np

import dedalus_tpu_torch.public as d3


def build_shear_flow_problem(Nx=128, Nz=256, Reynolds=5e4, Schmidt=1.0, Lx=1.0, Lz=2.0,
                             dealias=3 / 2, device=None):
    """The example's IVP on RealFourier x RealFourier; every array lives on
    `device` (default: the current CUDA card; device='cpu' for the CPU)."""
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    xbasis = d3.RealFourier(coords['x'], size=Nx, bounds=(0, Lx), dealias=dealias)
    zbasis = d3.RealFourier(coords['z'], size=Nz, bounds=(-Lz / 2, Lz / 2), dealias=dealias)
    p = dist.Field(name='p', bases=(xbasis, zbasis))
    s = dist.Field(name='s', bases=(xbasis, zbasis))
    u = dist.VectorField(coords, name='u', bases=(xbasis, zbasis))
    tau_p = dist.Field(name='tau_p')
    nu = 1 / Reynolds
    D = nu / Schmidt
    x, z = dist.local_grids(xbasis, zbasis, scales=1)
    problem = d3.IVP([u, s, p, tau_p], namespace=dict(locals()))
    problem.add_equation("dt(u) + grad(p) - nu*lap(u) = - u@grad(u)")
    problem.add_equation("dt(s) - D*lap(s) = - u@grad(s)")
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("integ(p) = 0")
    return problem, dict(coords=coords, dist=dist, xbasis=xbasis, zbasis=zbasis, u=u, s=s,
                         p=p, nu=nu, x=x, z=z, Nx=Nx, Nz=Nz, Lx=Lx)


def set_initial_condition(ctx):
    """The example's two shear layers with a sinusoidal perturbation, and
    the tracer marking the central stream."""
    x, z, Nx, Nz, Lx = (ctx[k] for k in ('x', 'z', 'Nx', 'Nz', 'Lx'))
    ug = np.zeros((2, Nx, Nz))
    ug[0] = np.broadcast_to(
        0.5 + 0.5 * (np.tanh((z - 0.5) / 0.1) - np.tanh((z + 0.5) / 0.1)), (Nx, Nz))
    ug[1] = 0.1 * np.sin(2 * np.pi * x / Lx) * np.exp(-(z**2) / 0.01)
    ctx['u']['g'] = ug
    ctx['s']['g'] = np.broadcast_to(
        0.5 * (np.tanh((z - 0.5) / 0.1) - np.tanh((z + 0.5) / 0.1)) + 1, (Nx, Nz)).copy()


def add_flow_property(solver, ctx):
    """The example's GlobalFlowProperty: Re_pt = (u@u)/nu every 100
    iterations."""
    u = ctx['u']
    flow = d3.GlobalFlowProperty(solver, cadence=100)
    flow.add_property((u @ u) / ctx['nu'], name='Re_pt')
    return flow
