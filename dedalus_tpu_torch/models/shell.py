"""
The shell example of the repository as functions that build its problem:
examples/ivp_shell_convection.py, rotating Boussinesq convection in the
spherical shell 7 <= r <= 10 with a no-slip inner wall, a stress-free outer
wall and the Coriolis force -2 Omega ez x u on the right-hand side, in the
first-order tau formulation (grad_u = grad(u) + rvec*lift(tau_u1)),
stepped with SBDF2 at dt = 2e-3.

The equations, parameters and initial condition are the example's (its HDF5
snapshots are left out). The functions are written against the public API
only: `d3` is the public module to build with (this port's by default;
dedalus_tpu.public builds the JAX reference from the same lines), and
`device` goes to the Distributor (default: the current CUDA card; pass
device='cpu' for the CPU).
"""

import numpy as np

RADII = (7, 10)
TIMESTEP = 2e-3


def build_shell_problem(Nphi, Ntheta, Nr, Rayleigh=3500, Prandtl=1, Ekman=1e-1,
                        dealias=3 / 2, dtype=np.float64, device=None, d3=None):
    """The example's IVP: (problem, ctx)."""
    if d3 is None:
        import dedalus_tpu_torch.public as d3
    Ri, Ro = RADII
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    kw = {} if device is None else dict(device=device)
    dist = d3.Distributor(coords, dtype=dtype, **kw)
    shell = d3.ShellBasis(coords, (Nphi, Ntheta, Nr), radii=(Ri, Ro), dealias=dealias,
                          dtype=dtype)
    outer = shell.outer_surface
    p = dist.Field(name='p', bases=shell)
    b = dist.Field(name='b', bases=shell)
    u = dist.VectorField(coords, name='u', bases=shell)
    tau_p = dist.Field(name='tau_p')
    tau_b1 = dist.Field(name='tau_b1', bases=outer)
    tau_b2 = dist.Field(name='tau_b2', bases=outer)
    tau_u1 = dist.VectorField(coords, name='tau_u1', bases=outer)
    tau_u2 = dist.VectorField(coords, name='tau_u2', bases=outer)
    kappa = (Rayleigh * Prandtl)**(-1 / 2)
    nu = (Rayleigh / Prandtl)**(-1 / 2)
    Omega = nu / Ekman / 2
    phi, theta, r = dist.local_grids(shell, scales=1)
    shp = np.broadcast_shapes(phi.shape, theta.shape, r.shape)
    # The unit vectors and the position vector, set on the grid
    er = dist.VectorField(coords, name='er', bases=shell)
    ez = dist.VectorField(coords, name='ez', bases=shell)
    rvec = dist.VectorField(coords, name='rvec', bases=shell)
    d_er, d_ez, d_rvec = (np.zeros((3,) + shp) for _ in range(3))
    d_er[2] = 1.0
    d_ez[1] = -np.sin(theta) * np.ones_like(phi) * np.ones_like(r)
    d_ez[2] = np.cos(theta) * np.ones_like(phi) * np.ones_like(r)
    d_rvec[2] = r * np.ones_like(phi) * np.ones_like(theta)
    for field, data in ((er, d_er), (ez, d_ez), (rvec, d_rvec)):
        field.change_scales(1)
        field['g'] = data
    lift_basis = shell.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)
    grad_u = d3.grad(u) + rvec * lift(tau_u1)
    grad_b = d3.grad(b) + rvec * lift(tau_b1)
    strain_rate = d3.grad(u) + d3.transpose(d3.grad(u))
    shear_stress = d3.angular(d3.radial(strain_rate(r=Ro), index=1))
    problem = d3.IVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2], namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*div(grad_b) + lift(tau_b2) = - u@grad(b)")
    problem.add_equation("dt(u) - nu*div(grad_u) + grad(p) - b*er + lift(tau_u2)"
                         " = - u@grad(u) - 2*Omega*cross(ez, u)")
    problem.add_equation("b(r=Ri) = 1")
    problem.add_equation("u(r=Ri) = 0")
    problem.add_equation("b(r=Ro) = 0")
    problem.add_equation("radial(u(r=Ro)) = 0")
    problem.add_equation("shear_stress = 0")
    problem.add_equation("integ(p) = 0")
    return problem, dict(locals())


def set_initial_condition(ctx, seed=42, scale=1e-3):
    """The example's initial buoyancy: seeded noise shaped by (r-Ri)(Ro-r)
    plus the conductive background (Ri - Ri Ro / r) / (Ri - Ro)."""
    b, r, shp = ctx['b'], ctx['r'], ctx['shp']
    Ri, Ro = ctx['Ri'], ctx['Ro']
    b.fill_random('g', seed=seed, distribution='normal', scale=scale)
    b.change_scales(1)
    background = (Ri - Ri * Ro / r) / (Ri - Ro)
    b['g'] = b.allgather_data('g') * (r - Ri) * (Ro - r) + np.broadcast_to(background, shp)


def add_flow_property(solver, ctx, d3=None):
    """The example's GlobalFlowProperty: u@u every 10 iterations."""
    if d3 is None:
        import dedalus_tpu_torch.public as d3
    u = ctx['u']
    flow = d3.GlobalFlowProperty(solver, cadence=10)
    flow.add_property(u @ u, name='u2')
    return flow


def wall_residuals(ctx):
    """Max |coefficient| of u(r=Ri), radial(u(r=Ro)) and the shear stress at
    Ro, evaluated on the current state (numpy scalars)."""
    u, Ri, Ro = ctx['u'], ctx['Ri'], ctx['Ro']
    out = []
    for expr in (u(r=Ri), ctx['d3'].radial(u(r=Ro)), ctx['shear_stress']):
        f = expr.evaluate()
        f.require_coeff_space()
        out.append(float(np.abs(f.allgather_data()).max()))
    return out
