"""
The Lane-Emden equation in the ball (examples/nlbvp_ball_lane_emden.py, with
an explicit torch device): the structure of a self-gravitating polytrope,

    lap(f) = -f**n,  f(r=1) = 0,

a nonlinear boundary value problem solved by Newton iterations. The
converged central value gives the radius R = f(0)**((n-1)/2), which Boyd
(2011, Table 1) tabulates as 6.896848619376960 for n = 3.
"""

import numpy as np

import dedalus_tpu_torch.public as d3

NCC_CUTOFF = 1e-10
TOLERANCE = 1e-10
R_BOYD = 6.896848619376960375454528  # Boyd (2011) Table 1, n = 3


def build_lane_emden_problem(Nr=64, n=3.0, dealias=2, device=None):
    """The example's problem on a (1, 1, Nr) ball and its initial guess
    f = 5**(2/(n-1)) (1 - r^2)^2; every array lives on `device` (default:
    the current CUDA card; device='cpu' for the CPU). Returns the problem
    and a dict of its dist, ball, f, tau and n."""
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    ball = d3.BallBasis(coords, shape=(1, 1, Nr), radius=1, dtype=np.float64, dealias=dealias)
    f = dist.Field(name='f', bases=ball)
    tau = dist.Field(name='tau', bases=ball.surface)
    lift = lambda A: d3.Lift(A, ball, -1)
    problem = d3.NLBVP([f, tau], namespace=dict(locals(), n=n))
    problem.add_equation("lap(f) + lift(tau) = - f**n")
    problem.add_equation("f(r=1) = 0")
    phi, theta, r = dist.local_grids(ball)
    f.change_scales(ball.dealias)
    f['g'] = 5**(2 / (n - 1)) * (1 - r**2)**2
    return problem, dict(dist=dist, ball=ball, f=f, tau=tau, n=n)


def solve(solver, tolerance=TOLERANCE, max_iterations=20):
    """The example's loop: Newton iterations until the perturbation norm
    falls to `tolerance`. Returns the norms, one an iteration."""
    norms = []
    while not norms or norms[-1] > tolerance:
        if len(norms) == max_iterations:
            raise RuntimeError(f"Lane-Emden: no convergence in {max_iterations} iterations")
        norms.append(solver.newton_iteration())
    return norms


def radius(ctx):
    """R = f(0)**((n-1)/2) from the current f."""
    f0 = ctx['f'](r=0).evaluate()
    f0.change_scales(1)
    f0.require_grid_space()
    return float(f0.data.reshape(-1)[0]) ** ((ctx['n'] - 1) / 2)
