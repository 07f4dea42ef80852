"""
The polar examples of the repository as functions that build their problems:

  * examples/ivp_annulus_convection.py: centrifugal convection in an
    annulus, Ra=1e5, Pr=1, radii (1, 2), RK222 in the example;
  * examples/ivp_disk_libration.py: libration in a disk around the Bessel
    background flow, Ekman=1/800, Ro=40, SBDF2 in the example.

The equations, parameters and initial conditions are the examples'. The
functions are written against the public API only: `d3` is the public
module to build with (this port's by default; dedalus_tpu.public builds the
JAX reference from the same lines), and `device` goes to the Distributor
(default: the current CUDA card; pass device='cpu' for the CPU).
"""

import numpy as np
from scipy.special import jv


def _setup(d3, device):
    if d3 is None:
        import dedalus_tpu_torch.public as d3
    coords = d3.PolarCoordinates('phi', 'r')
    kw = {} if device is None else dict(device=device)
    return d3, coords, d3.Distributor(coords, dtype=np.float64, **kw)


def build_annulus_problem(Nphi, Nr, Rayleigh=1e5, Prandtl=1, radii=(1.0, 2.0), dealias=1.5,
                          device=None, d3=None):
    """The annulus example's IVP: (problem, ctx)."""
    d3, coords, dist = _setup(d3, device)
    Ri, Ro = radii
    annulus = d3.AnnulusBasis(coords, shape=(Nphi, Nr), radii=(Ri, Ro), dealias=dealias,
                              dtype=np.float64)
    edge = annulus.S1_basis()
    u = dist.VectorField(coords, name='u', bases=annulus)
    p = dist.Field(name='p', bases=annulus)
    T = dist.Field(name='T', bases=annulus)
    tau_u1 = dist.VectorField(coords, name='tau_u1', bases=edge)
    tau_u2 = dist.VectorField(coords, name='tau_u2', bases=edge)
    tau_T1 = dist.Field(name='tau_T1', bases=edge)
    tau_T2 = dist.Field(name='tau_T2', bases=edge)
    tau_p = dist.Field(name='tau_p')
    phi, r = annulus.global_grids(scales=(1, 1))
    phi, r = phi.reshape(-1, 1), r.reshape(1, -1)
    nu = (Rayleigh / Prandtl)**(-1/2)
    kappa = (Rayleigh * Prandtl)**(-1/2)
    lift_basis = annulus.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)
    # Radial buoyancy field r*er
    rvec = dist.VectorField(coords, name='rvec', bases=annulus)
    rdata = np.zeros((2,) + np.broadcast_shapes(phi.shape, r.shape))
    rdata[1] = r * np.ones_like(phi)
    rvec['g'] = rdata
    problem = d3.IVP([p, T, u, tau_p, tau_T1, tau_T2, tau_u1, tau_u2], namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("dt(T) - kappa*lap(T) + lift(tau_T1,-1) + lift(tau_T2,-2) = - u@grad(T)")
    problem.add_equation("dt(u) - nu*lap(u) + grad(p) + lift(tau_u1,-1) + lift(tau_u2,-2) "
                         "= - u@grad(u) + rvec*T")
    problem.add_equation("T(r=Ri) = 1")
    problem.add_equation("u(r=Ri) = 0")
    problem.add_equation("T(r=Ro) = 0")
    problem.add_equation("u(r=Ro) = 0")
    problem.add_equation("integ(p) = 0")
    return problem, dict(coords=coords, dist=dist, basis=annulus, u=u, p=p, T=T, r=r,
                         radii=(Ri, Ro), nu=nu, kappa=kappa)


def annulus_initial_condition(ctx, seed=42):
    """The example's T: seeded noise times (r - Ri)(Ro - r) on the
    conduction profile, at scale 1."""
    T, r = ctx['T'], ctx['r']
    Ri, Ro = ctx['radii']
    T.fill_random('g', seed=seed, distribution='normal', scale=1e-3)
    T.change_scales(1)
    T['g'] = T.allgather_data('g') * (r - Ri) * (Ro - r) + (Ro - r) / (Ro - Ri)


def build_disk_problem(Nphi, Nr, Ekman=1 / 2 / 20**2, Ro=40, dealias=1.5, device=None,
                       d3=None):
    """The disk libration example's IVP: (problem, ctx)."""
    d3, coords, dist = _setup(d3, device)
    disk = d3.DiskBasis(coords, shape=(Nphi, Nr), radius=1, dealias=dealias, dtype=np.float64)
    edge = disk.edge
    u = dist.VectorField(coords, name='u', bases=disk)
    p = dist.Field(name='p', bases=disk)
    tau_u = dist.VectorField(coords, name='tau_u', bases=edge)
    tau_p = dist.Field(name='tau_p')
    phi, r = disk.global_grids(scales=(1, 1))
    phi, r = phi.reshape(-1, 1), r.reshape(1, -1)
    nu = Ekman
    lift = lambda A: d3.Lift(A, disk, -1)
    # Background librating flow
    u0_real = dist.VectorField(coords, name='u0r', bases=disk)
    u0_imag = dist.VectorField(coords, name='u0i', bases=disk)
    profile = jv(1, (1 - 1j) * r / np.sqrt(2 * Ekman)) / jv(1, (1 - 1j) / np.sqrt(2 * Ekman))
    data_r = np.zeros((2,) + np.broadcast_shapes(phi.shape, r.shape))
    data_i = np.zeros_like(data_r)
    data_r[0] = Ro * np.real(profile) * np.ones_like(phi)
    data_i[0] = Ro * np.imag(profile) * np.ones_like(phi)
    u0_real['g'] = data_r
    u0_imag['g'] = data_i
    t = dist.Field(name='t')
    u0 = np.cos(t) * u0_real - np.sin(t) * u0_imag
    problem = d3.IVP([p, u, tau_u, tau_p], time=t, namespace=locals())
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("dt(u) - nu*lap(u) + grad(p) + lift(tau_u) = - u@grad(u0) - u0@grad(u)")
    problem.add_equation("u(r=1) = 0")
    problem.add_equation("integ(p) = 0")
    return problem, dict(coords=coords, dist=dist, basis=disk, u=u, p=p, u0=u0, nu=nu)


def disk_initial_condition(ctx, seed=42):
    """The example's u: seeded standard-normal noise, low-pass filtered to
    (8, 16) modes."""
    u = ctx['u']
    u.fill_random('g', seed=seed, distribution='standard_normal')
    u.low_pass_filter(shape=(8, 16))
