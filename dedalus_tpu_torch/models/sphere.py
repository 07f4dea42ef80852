"""
The sphere example of the repository as functions that build its problems:
examples/ivp_sphere_shallow_water.py, rotating shallow water on the sphere
with the Galewsky et al. (2004) zonal jet. The height field that balances
the jet is solved as an LBVP, perturbed, and evolved with RK222 in the
example at a fixed timestep of 600 s.

The equations, units, parameters and initial conditions are the example's.
The functions are written against the public API only: `d3` is the public
module to build with (this port's by default; dedalus_tpu.public builds the
JAX reference from the same lines), and `device` goes to the Distributor
(default: the current CUDA card; pass device='cpu' for the CPU).
"""

import numpy as np

# Units
meter = 1 / 6.37122e6
hour = 1
second = hour / 3600
TIMESTEP = 600 * second


def build_shallow_water(Nphi, Ntheta, dealias=1.5, hyperdiffusion_ell=32, device=None, d3=None):
    """The example's two problems on one pair of fields: (lbvp, ivp, ctx).
    The LBVP balances h against the u held at the time of its solve; the
    hyperdiffusion is matched at ell = `hyperdiffusion_ell`."""
    if d3 is None:
        import dedalus_tpu_torch.public as d3
    R = 6.37122e6 * meter
    Omega = 7.292e-5 / second
    nu = 1e5 * meter**2 / second / hyperdiffusion_ell**2
    g = 9.80616 * meter / second**2
    H = 1e4 * meter
    coords = d3.S2Coordinates('phi', 'theta')
    kw = {} if device is None else dict(device=device)
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    basis = d3.SphereBasis(coords, (Nphi, Ntheta), radius=R, dealias=dealias, dtype=np.float64)
    u = dist.VectorField(coords, name='u', bases=basis)
    h = dist.Field(name='h', bases=basis)
    c = dist.Field(name='c')
    zcross = lambda A: d3.MulCosine(d3.skew(A))
    lbvp = d3.LBVP([h, c], namespace=locals())
    lbvp.add_equation("g*lap(h) + c = - div(u@grad(u) + 2*Omega*zcross(u))")
    lbvp.add_equation("ave(h) = 0")
    ivp = d3.IVP([u, h], namespace=locals())
    ivp.add_equation("dt(u) + nu*lap(lap(u)) + g*grad(h) + 2*Omega*zcross(u) = - u@grad(u)")
    ivp.add_equation("dt(h) + nu*lap(lap(h)) + H*div(u) = - div(h*u)")
    phi, theta = basis.global_grids(scales=(1, 1))
    phi, theta = phi.reshape(-1, 1), theta.reshape(1, -1)
    return lbvp, ivp, dict(coords=coords, dist=dist, basis=basis, u=u, h=h, c=c, phi=phi,
                           lat=np.pi / 2 - theta + 0 * phi, R=R, Omega=Omega, nu=nu, g=g, H=H)


def set_jet(ctx):
    """The example's zonal jet in u, at scale 1."""
    lat = ctx['lat']
    umax = 80 * meter / second
    lat0 = np.pi / 7
    lat1 = np.pi / 2 - lat0
    en = np.exp(-4 / (lat1 - lat0)**2)
    jet = (lat0 <= lat) * (lat <= lat1)
    u_data = np.zeros((2,) + lat.shape)
    u_data[0][jet] = umax / en * np.exp(1 / (lat[jet] - lat0) / (lat[jet] - lat1))
    ctx['u'].change_scales(1)
    ctx['u']['g'] = u_data


def perturb_height(ctx):
    """The example's height perturbation, added to h at scale 1."""
    h, lat, phi = ctx['h'], ctx['lat'], ctx['phi']
    lat2 = np.pi / 4
    hpert = 120 * meter
    alpha = 1 / 3
    beta = 1 / 15
    h.change_scales(1)
    h['g'] = h.allgather_data('g') + hpert * np.cos(lat) * np.exp(-(phi / alpha)**2) \
        * np.exp(-((lat2 - lat) / beta)**2)


def balanced_initial_condition(lbvp_solver, ctx):
    """The example's initial condition: the jet, the height that balances it
    (one LBVP solve), then the perturbation."""
    set_jet(ctx)
    lbvp_solver.solve()
    perturb_height(ctx)
