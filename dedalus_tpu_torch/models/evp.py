"""
The 1-D eigenvalue problems of the examples, with an explicit torch device:

  * waves on a clamped string (examples/evp_1d_waves_on_a_string.py):
    lam*u + u_xx = 0, u(0) = u(1) = 0, whose eigenvalues are (n pi)^2;
  * the linear stability of stress-free Rayleigh-Benard convection at one
    horizontal wavenumber (examples/evp_1d_rayleigh_benard.py, complex128),
    whose critical Rayleigh number at k = pi/sqrt(2) is 27 pi^4 / 4.

Their pencil pairs solve on the host with scipy (solver.solve_dense,
solver.solve_sparse); set_state writes an eigenmode into the fields on
`device`.
"""

import numpy as np

import dedalus_tpu_torch.public as d3

RB_KC = np.pi / np.sqrt(2)
RB_RA_CRITICAL = 27 * np.pi**4 / 4


def build_waves_problem(Nx=128, device=None):
    """The waves example's EVP on a ChebyshevT basis of Nx modes, float64.
    Returns the problem and a dict of its dist, xbasis and u."""
    xcoord = d3.Coordinate('x')
    dist = d3.Distributor(xcoord, dtype=np.float64, device=device)
    xbasis = d3.ChebyshevT(xcoord, size=Nx, bounds=(0, 1))
    u = dist.Field(name='u', bases=xbasis)
    tau_1 = dist.Field(name='tau_1')
    tau_2 = dist.Field(name='tau_2')
    lam = dist.Field(name='lam')
    dx = lambda A: d3.Differentiate(A, xcoord)
    lift_basis = xbasis.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)
    problem = d3.EVP([u, tau_1, tau_2], eigenvalue=lam, namespace=locals())
    problem.add_equation("lam*u + dx(dx(u)) + lift(tau_1,-1) + lift(tau_2,-2) = 0")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation("u(x=1) = 0")
    return problem, dict(dist=dist, xbasis=xbasis, u=u)


class RayleighBenardEVP:
    """The Rayleigh-Benard example's fields on a ChebyshevT basis of Nz modes
    (complex128), and its problem built anew for each (Ra, k)."""

    def __init__(self, Nz=48, device=None):
        zcoord = d3.Coordinate('z')
        self.dist = dist = d3.Distributor(zcoord, dtype=np.complex128, device=device)
        self.zbasis = zbasis = d3.ChebyshevT(zcoord, size=Nz, bounds=(0, 1))
        self.W = dist.Field(name='W', bases=zbasis)
        self.Theta = dist.Field(name='Theta', bases=zbasis)
        self.omega = dist.Field(name='omega')
        self.taus_W = [dist.Field(name=f'tw{i}') for i in range(4)]
        self.taus_T = [dist.Field(name=f'tt{i}') for i in range(2)]
        self.dz = lambda A: d3.Differentiate(A, zcoord)
        self.lift4 = lambda A, n: d3.Lift(A, zbasis.derivative_basis(4), n)
        self.lift2 = lambda A, n: d3.Lift(A, zbasis.derivative_basis(2), n)

    def problem(self, Ra, k):
        """The normal-mode EVP at Rayleigh number Ra and wavenumber k."""
        k2 = float(k)**2
        taus_W, taus_T = self.taus_W, self.taus_T
        ns = dict(W=self.W, Theta=self.Theta, omega=self.omega, dz=self.dz, lift4=self.lift4,
                  lift2=self.lift2, Ra=float(Ra), k2=k2, tw0=taus_W[0], tw1=taus_W[1],
                  tw2=taus_W[2], tw3=taus_W[3], tt0=taus_T[0], tt1=taus_T[1])
        problem = d3.EVP([self.W, self.Theta] + taus_W + taus_T, eigenvalue=self.omega,
                         namespace=ns)
        problem.add_equation(
            "omega*(dz(dz(W)) - k2*W)"
            " - (dz(dz(dz(dz(W)))) - 2*k2*dz(dz(W)) + k2*k2*W) + Ra*k2*Theta"
            " + lift4(tw0,-1) + lift4(tw1,-2) + lift4(tw2,-3) + lift4(tw3,-4) = 0")
        problem.add_equation(
            "omega*Theta - (dz(dz(Theta)) - k2*Theta) - W"
            " + lift2(tt0,-1) + lift2(tt1,-2) = 0")
        problem.add_equation("W(z=0) = 0")
        problem.add_equation("W(z=1) = 0")
        problem.add_equation("dz(dz(W))(z=0) = 0")
        problem.add_equation("dz(dz(W))(z=1) = 0")
        problem.add_equation("Theta(z=0) = 0")
        problem.add_equation("Theta(z=1) = 0")
        return problem

    def max_growth(self, Ra, k, **kw):
        """The largest growth rate of the four modes about 0.1 (the
        example's sparse solve; `kw` to solve_sparse, such as v0)."""
        solver = self.problem(Ra, k).build_solver()
        solver.solve_sparse(N=4, target=0.1, **kw)
        return np.max(solver.eigenvalues.real)

    def critical_rayleigh(self, k=RB_KC, bracket=(400, 900), xtol=1e-6, **kw):
        """The neutral Rayleigh number at k by Brent's method (the
        example's root-find)."""
        from scipy import optimize
        return optimize.brentq(lambda Ra: self.max_growth(Ra, k, **kw), *bracket, xtol=xtol)
