"""
The eigenvalue problems of the examples, with an explicit torch device:

  * waves on a clamped string (examples/evp_1d_waves_on_a_string.py):
    lam*u + u_xx = 0, u(0) = u(1) = 0, whose eigenvalues are (n pi)^2;
  * the linear stability of stress-free Rayleigh-Benard convection at one
    horizontal wavenumber (examples/evp_1d_rayleigh_benard.py, complex128),
    whose critical Rayleigh number at k = pi/sqrt(2) is 27 pi^4 / 4;
  * the Mathieu equation u'' + (a - 2 q cos 2x) u = 0 on a ComplexFourier
    axis (examples/evp_1d_mathieu.py): an NCC couples the whole axis into
    one pencil, and the eigenvalues are scipy's mathieu_a / mathieu_b;
  * the linear stability of pipe flow on the disk (examples/
    evp_disk_pipe_flow.py, complex128): the Poiseuille profile w0 = 1 - r^2
    as an axisymmetric NCC, with the dot product u@grad(w0) on the LHS;
  * rotating convection in a spherical shell (examples/
    evp_shell_rotating_convection.py, complex128): the NCC rvec and
    dot(rvec, u), the Coriolis term as SphericalZCross, solved sparse near
    a target; ROTATING_SHELL_MARTI is the example's published configuration
    (Marti, Calkins & Julien 2016, Table 1).

Their pencil pairs solve on the host with scipy (solver.solve_dense,
solver.solve_sparse); set_state writes an eigenmode into the fields on
`device`.
"""

import numpy as np

import dedalus_tpu_torch.public as d3
from dedalus_tpu_torch.core.operators_ball import SphericalZCross

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


class MathieuEVP:
    """The Mathieu example's fields on a ComplexFourier basis of Nx modes on
    [0, 2 pi] (complex128), and its problem built anew for each q."""

    def __init__(self, Nx=64, device=None):
        self.xcoord = xcoord = d3.Coordinate('x')
        self.dist = dist = d3.Distributor(xcoord, dtype=np.complex128, device=device)
        self.xbasis = xbasis = d3.ComplexFourier(xcoord, size=Nx, bounds=(0, 2 * np.pi))
        self.u = dist.Field(name='u', bases=xbasis)
        self.a = dist.Field(name='a')
        self.cos2x = dist.Field(name='cos2x', bases=xbasis)
        self.x = dist.local_grid(xbasis, scale=1).ravel()
        self.dx = lambda A: d3.Differentiate(A, xcoord)

    def problem(self, q):
        """The example's EVP in a at this q."""
        self.cos2x['g'] = np.cos(2 * self.x)
        problem = d3.EVP([self.u], eigenvalue=self.a, namespace=dict(
            u=self.u, a=self.a, q=q, cos2x=self.cos2x, dx=self.dx))
        problem.add_equation("dx(dx(u)) - 2*q*cos2x*u + a*u = 0")
        return problem

    def spectrum(self, q):
        """The example's dense solve: (sorted finite real eigenvalues, solver)."""
        solver = self.problem(q).build_solver()
        evals, _ = mathieu_solve(solver)
        return evals, solver


def mathieu_solve(solver):
    """The example's dense solve of a built Mathieu solver: (sorted finite
    real eigenvalues, the index of the lowest in solver.eigenvalues)."""
    solver.solve_dense()
    finite = np.isfinite(solver.eigenvalues)
    index = int(np.argmin(np.where(finite, solver.eigenvalues.real, np.inf)))
    return np.sort(solver.eigenvalues[finite].real), index


def mathieu_exact(q):
    """The first seven characteristic values at q (scipy): a_0..a_3, b_1..b_3."""
    from scipy.special import mathieu_a, mathieu_b
    return np.sort(np.concatenate([[mathieu_a(m, q) for m in range(4)],
                                   [mathieu_b(m, q) for m in range(1, 4)]]))


# The pipe-flow example's parameters
PIPE_RE = 1e4
PIPE_KZ = 1
PIPE_M = 5
# The JAX package's s at Nr = 64, as its run of the example printed it
# (-0.0725274157945179-0.8985611581580982j, drift 1.0e-15): a recorded value,
# which the card's run is held to without JAX
PIPE_FLOW_S64 = -0.0725274157945179 - 0.8985611581580982j


def build_pipe_flow_problem(Nr, device=None):
    """The pipe-flow example's EVP on a disk of Nphi = 2 m + 2 azimuthal and
    Nr radial modes (complex128). Returns the problem and a dict of its
    dist, disk, u, w, p, w0 and s."""
    Nphi = 2 * PIPE_M + 2
    dtype = np.complex128
    coords = d3.PolarCoordinates('phi', 'r')
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    disk = d3.DiskBasis(coords, shape=(Nphi, Nr), radius=1, dtype=dtype)
    phi, r = dist.local_grids(disk, scales=1)
    s = dist.Field(name='s')
    u = dist.VectorField(coords, name='u', bases=disk)
    w = dist.Field(name='w', bases=disk)
    p = dist.Field(name='p', bases=disk)
    tau_u = dist.VectorField(coords, name='tau_u', bases=disk.edge)
    tau_w = dist.Field(name='tau_w', bases=disk.edge)
    dt = lambda A: s * A
    dz = lambda A: 1j * PIPE_KZ * A
    lift = lambda A: d3.Lift(A, disk, -1)
    w0 = dist.Field(name='w0', bases=disk)
    w0['g'] = np.broadcast_to(1 - r**2, w0['g'].shape)
    ns = dict(u=u, w=w, p=p, tau_u=tau_u, tau_w=tau_w, w0=w0, dt=dt, dz=dz, lift=lift,
              Re=PIPE_RE, div=d3.div, grad=d3.grad, lap=d3.lap)
    problem = d3.EVP([u, w, p, tau_u, tau_w], eigenvalue=s, namespace=ns)
    problem.add_equation("div(u) + dz(w) = 0")
    problem.add_equation(
        "dt(u) + w0*dz(u) + grad(p) - (1/Re)*(lap(u) + dz(dz(u))) + lift(tau_u) = 0")
    problem.add_equation(
        "dt(w) + w0*dz(w) + u@grad(w0) + dz(p) - (1/Re)*(lap(w) + dz(dz(w))) + lift(tau_w) = 0")
    problem.add_equation("u(r=1) = 0")
    problem.add_equation("w(r=1) = 0")
    return problem, dict(dist=dist, disk=disk, u=u, w=w, p=p, w0=w0, s=s)


def pipe_flow_solve(solver):
    """The example's dense solve of a built pipe-flow solver on its m
    subproblem, the first with sp.group[0] == m: (finite eigenvalues
    slowest-decaying first, the index of the slowest in solver.eigenvalues,
    sp_index)."""
    sp_index = next(i for i, sp in enumerate(solver.subproblems) if sp.group[0] == PIPE_M)
    solver.solve_dense(sp_index=sp_index)
    evals = solver.eigenvalues[np.isfinite(solver.eigenvalues)]
    evals = evals[np.argsort(-evals.real)]
    return evals, int(np.argmin(np.abs(solver.eigenvalues - evals[0]))), sp_index


def pipe_flow_modes(Nr, device=None):
    """The example at Nr: (finite eigenvalues slowest-decaying first,
    solver, sp_index, fields)."""
    problem, ctx = build_pipe_flow_problem(Nr, device=device)
    solver = problem.build_solver()
    evals, _, sp_index = pipe_flow_solve(solver)
    return evals, solver, sp_index, ctx


# The rotating-shell example's fixed parameters (stress-free walls), its
# default configuration and its published one (MARTI=1)
SHELL_PRANDTL = 1.0
SHELL_RADII = (0.35, 1.0)
ROTATING_SHELL = dict(Ekman=1e-3, Rayleigh=6.0e4, m_crit=3, target=50.0,
                      resolutions=((8, 16, 16), (8, 20, 20)))
ROTATING_SHELL_MARTI = dict(Ekman=1e-5, Rayleigh=2.1029e7, m_crit=13, target=963.765,
                            resolutions=((28, 64, 64),))


def build_rotating_shell_problem(shape, Ekman=1e-3, Rayleigh=6.0e4, device=None):
    """The rotating-shell example's EVP on a shell of (Nphi, Ntheta, Nr)
    modes (complex128). Returns the problem and a dict of its dist, shell,
    u, p, T, rvec and om."""
    Nphi, Ntheta, Nr = shape
    Ri, Ro = SHELL_RADII
    dtype = np.complex128
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    shell = d3.ShellBasis(coords, shape=(Nphi, Ntheta, Nr), radii=(Ri, Ro), dtype=dtype)
    outer = shell.outer_surface
    phi, theta, r = dist.local_grids(shell, scales=1)
    om = dist.Field(name='om')
    u = dist.VectorField(coords, name='u', bases=shell)
    p = dist.Field(name='p', bases=shell)
    T = dist.Field(name='T', bases=shell)
    tau_u1 = dist.VectorField(coords, name='tau_u1', bases=outer)
    tau_u2 = dist.VectorField(coords, name='tau_u2', bases=outer)
    tau_T1 = dist.Field(name='tau_T1', bases=outer)
    tau_T2 = dist.Field(name='tau_T2', bases=outer)
    tau_p = dist.Field(name='tau_p')
    dt = lambda A: -1j * om * A
    rvec = dist.VectorField(coords, name='rvec', bases=shell.radial_basis)
    rvec.change_scales(1)
    rvec.require_grid_space()
    d = np.zeros(tuple(rvec['g'].shape))
    d[2] = np.broadcast_to(r, d[2].shape)
    rvec['g'] = d
    rvec.require_coeff_space()
    zcross = lambda A: SphericalZCross(A)
    lift_basis = shell.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)
    # First-order reduction: the tau terms on the gradients put a tau in the
    # divergence constraint, as this geometry requires
    grad_u = d3.grad(u) + rvec * lift(tau_u1)
    grad_T = d3.grad(T) + rvec * lift(tau_T1)
    strain = d3.grad(u) + d3.TransposeComponents(d3.grad(u))
    ns = dict(p=p, u=u, T=T, tau_u1=tau_u1, tau_u2=tau_u2, tau_T1=tau_T1, tau_T2=tau_T2,
              tau_p=tau_p, dt=dt, rvec=rvec, zcross=zcross, lift=lift, grad_u=grad_u,
              grad_T=grad_T, strain=strain, grad=d3.grad, div=d3.div, trace=d3.Trace,
              dot=d3.dot, radial=d3.RadialComponent, angular=d3.AngularComponent,
              integ=d3.integ, Ekman=Ekman, Rayleigh=Rayleigh, Prandtl=SHELL_PRANDTL, Ri=Ri,
              Ro=Ro)
    problem = d3.EVP([p, u, T, tau_u1, tau_u2, tau_T1, tau_T2, tau_p], eigenvalue=om,
                     namespace=ns)
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(u) + (1/Ekman)*zcross(u) + grad(p) - Rayleigh*T*rvec"
                         " - div(grad_u) + lift(tau_u2) = 0")
    problem.add_equation("Prandtl*dt(T) - dot(rvec, u) - div(grad_T) + lift(tau_T2) = 0")
    problem.add_equation("radial(u(r=Ri)) = 0")
    problem.add_equation("radial(u(r=Ro)) = 0")
    problem.add_equation("angular(radial(strain(r=Ri), 0), 0) = 0")
    problem.add_equation("angular(radial(strain(r=Ro), 0), 0) = 0")
    problem.add_equation("T(r=Ri) = 0")
    problem.add_equation("T(r=Ro) = 0")
    problem.add_equation("integ(p) = 0")
    return problem, dict(dist=dist, shell=shell, u=u, p=p, T=T, rvec=rvec, om=om)


def rotating_shell_solve(solver, cfg, v0_seed):
    """The example's sparse solve of a built rotating-shell solver: 8
    eigenvalues near cfg's target on its m_crit subproblem, from a start
    vector seeded by v0_seed (ARPACK's own is random): (finite eigenvalues
    nearest the target first, the index of the nearest in
    solver.eigenvalues)."""
    sp = solver.subproblems_by_group[(cfg['m_crit'], None, None)]
    solver.solve_sparse(sp, 8, cfg['target'], v0=rotating_shell_v0(solver, sp, v0_seed))
    evals = solver.eigenvalues[np.isfinite(solver.eigenvalues)]
    evals = evals[np.argsort(np.abs(evals - cfg['target']))]
    return evals, int(np.argmin(np.abs(solver.eigenvalues - evals[0])))


def rotating_shell_v0(solver, sp, seed):
    """A seeded complex start vector of the size of sp's sparse pair (for
    comparing ARPACK runs)."""
    n = solver._sparse_pair(solver.subproblems.index(sp))[0].shape[0]
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)
