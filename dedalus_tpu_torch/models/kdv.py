"""
1D Korteweg-de Vries / Burgers model (the port of dedalus_tpu/models/kdv.py,
with an explicit torch device; examples/ivp_1d_kdv_burgers.py's problem and
initial condition).
"""

import numpy as np

import dedalus_tpu_torch.public as d3


def build_kdv_problem(Nx=1024, Lx=10.0, a=1e-4, b=2e-4, dealias=1.5, n=20, device=None):
    """dt(u) - a dx(dx(u)) - b dx(dx(dx(u))) = - u dx(u) on a RealFourier
    basis, with the example's soliton-like initial condition; every array
    lives on `device` (default: the current CUDA card; device='cpu' for the
    CPU)."""
    xcoord = d3.Coordinate('x')
    dist = d3.Distributor(xcoord, dtype=np.float64, device=device)
    xbasis = d3.RealFourier(xcoord, size=Nx, bounds=(0, Lx), dealias=dealias)
    u = dist.Field(name='u', bases=xbasis)
    dx = lambda A: d3.Differentiate(A, xcoord)
    ns = dict(locals())
    problem = d3.IVP([u], namespace=ns)
    problem.add_equation("dt(u) - a*dx(dx(u)) - b*dx(dx(dx(u))) = - u*dx(u)")
    x = dist.local_grid(xbasis, scale=1).ravel()
    u['g'] = np.log(1 + np.cosh(n)**2 / np.cosh(n * (x - 0.2 * Lx))**2) / (2 * n)
    return problem, dict(dist=dist, xbasis=xbasis, u=u, x=x)
