"""The Rayleigh-Benard example in complex128 on the PyTorch port against
dedalus_tpu: the example's own lines (examples/ivp_2d_rayleigh_benard.py)
with `dtype = np.complex128` and d3.ComplexFourier in x, at 32x16, built in
both packages from the same numpy-seeded real initial condition.

RK222 runs 10 steps of the example's CFL loop (initial_dt 0.125, cadence
10, safety 0.5) and SBDF2 10 steps at dt 1e-3, each under `[transforms]
fourier_library = jacobi_library = matrix` and `fast`. The port is held to
the JAX package, and to its own real form (RealFourier, float64) from the
same initial condition, at 1e-10 of the state's largest value, the rule
tests/test_torch_rbc_fast.py and PR 9's chip check set for RBC; the complex
state's imaginary part stays at roundoff. Both packages' configs are
restored by the fixture. ComplexWarning is an error here: a cast that drops
an imaginary part would pass silently otherwise.
"""

import numpy as np
import pytest
import torch

from dedalus_tpu.utils.config import config as jconfig
from dedalus_tpu_torch.utils.config import config as tconfig

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings('error::numpy.exceptions.ComplexWarning')

NX, NZ, RA = 32, 16, 2e6
STEPS, DT = 10, 1e-3
KEYS = ('fourier_library', 'jacobi_library')
TOL = 1e-10


def build(d3, dtype, scheme, **dist_kw):
    """The example's lines at NX x NZ with `dtype` (ComplexFourier in x for
    complex128, RealFourier for float64), its initial condition taken real:
    seeded numpy noise times z (Lz - z) on the conduction profile."""
    Lx, Lz = 4, 1
    Prandtl = 1
    dealias = 3 / 2
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=dtype, **dist_kw)
    Fourier = d3.ComplexFourier if np.dtype(dtype).kind == 'c' else d3.RealFourier
    xbasis = Fourier(coords['x'], size=NX, bounds=(0, Lx), dealias=dealias)
    zbasis = d3.ChebyshevT(coords['z'], size=NZ, bounds=(0, Lz), dealias=dealias)
    p = dist.Field(name='p', bases=(xbasis, zbasis))
    b = dist.Field(name='b', bases=(xbasis, zbasis))
    u = dist.VectorField(coords, name='u', bases=(xbasis, zbasis))
    tau_p = dist.Field(name='tau_p')
    tau_b1 = dist.Field(name='tau_b1', bases=xbasis)
    tau_b2 = dist.Field(name='tau_b2', bases=xbasis)
    tau_u1 = dist.VectorField(coords, name='tau_u1', bases=xbasis)
    tau_u2 = dist.VectorField(coords, name='tau_u2', bases=xbasis)
    kappa = (RA * Prandtl)**(-1/2)
    nu = (RA / Prandtl)**(-1/2)
    x, z = dist.local_grids(xbasis, zbasis, scales=1)
    ex, ez = coords.unit_vector_fields(dist)
    lift_basis = zbasis.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)
    grad_u = d3.grad(u) + ez * lift(tau_u1)
    grad_b = d3.grad(b) + ez * lift(tau_b1)
    problem = d3.IVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2], namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*div(grad_b) + lift(tau_b2) = - u@grad(b)")
    problem.add_equation("dt(u) - nu*div(grad_u) + grad(p) - b*ez + lift(tau_u2) = - u@grad(u)")
    problem.add_equation("b(z=0) = Lz")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("b(z=Lz) = 0")
    problem.add_equation("u(z=Lz) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(getattr(d3, scheme))
    noise = np.random.default_rng(42).standard_normal((NX, NZ)) * 1e-3
    b['g'] = (noise * z * (Lz - z) + Lz - z).astype(dtype)
    CFL = d3.CFL(solver, initial_dt=0.125, cadence=10, safety=0.5, threshold=0.05,
                 max_change=1.5, min_change=0.5, max_dt=0.125)
    CFL.add_velocity(u)
    return solver, CFL


def advance(solver, CFL, scheme):
    """RK222: the example's CFL loop for STEPS steps; SBDF2: STEPS steps at DT."""
    if scheme == 'SBDF2':
        solver.run_steps(DT, STEPS)
        return
    while solver.iteration < STEPS:
        dt = CFL.compute_timestep()
        solver.run_steps(dt, min(CFL.chunk_steps(), STEPS - solver.iteration))


def grid_state(solver):
    out = {}
    for f in solver.state:
        f.change_scales(1)
        out[f.name] = np.array(f['g'])
    return out


@pytest.fixture(scope='module')
def runs():
    """{(scheme, library): (JAX complex, port complex, port real)} grid
    states after the run."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    saved = {k: (jconfig.get('transforms', k), tconfig.get('transforms', k)) for k in KEYS}
    out = {}
    try:
        for library in ('matrix', 'fast'):
            for cfg in (jconfig, tconfig):
                for k in KEYS:
                    cfg.set('transforms', k, library)
            for scheme in ('RK222', 'SBDF2'):
                states = []
                for d3, dtype, kw in ((jd3, np.complex128, {}),
                                      (td3, np.complex128, dict(device='cpu')),
                                      (td3, np.float64, dict(device='cpu'))):
                    solver, CFL = build(d3, dtype, scheme, **kw)
                    advance(solver, CFL, scheme)
                    states.append(grid_state(solver))
                out[scheme, library] = states
    finally:
        for k, (j, t) in saved.items():
            jconfig.set('transforms', k, j)
            tconfig.set('transforms', k, t)
    return out


def _err(a, b):
    """max over fields of |a - b|, relative to b's largest value."""
    top = max(np.abs(v).max() for v in b.values())
    return max(np.abs(a[k] - b[k]).max() for k in b) / top


@pytest.mark.parametrize('library', ['matrix', 'fast'])
@pytest.mark.parametrize('scheme', ['RK222', 'SBDF2'])
def test_complex_rbc_matches_jax(runs, scheme, library):
    ref, port, _ = runs[scheme, library]
    assert all(np.iscomplexobj(v) for v in port.values())
    assert _err(port, ref) <= TOL


@pytest.mark.parametrize('library', ['matrix', 'fast'])
@pytest.mark.parametrize('scheme', ['RK222', 'SBDF2'])
def test_complex_rbc_matches_real_form(runs, scheme, library):
    _, port, real = runs[scheme, library]
    assert _err(port, real) <= TOL
    top = max(np.abs(v).max() for v in real.values())
    assert max(np.abs(v.imag).max() for v in port.values()) <= 1e-12 * top


def test_complex_rbc_pencils_are_complex_and_dense():
    """One signed wavenumber a group (G = NX, the Nyquist group invalid),
    complex dense stacks under the default matsolver, and the sampled
    separable assembly on the complex entries."""
    import dedalus_tpu_torch.public as td3
    solver, _ = build(td3, np.complex128, 'RK222', device='cpu')
    pencil = solver.pencil
    assert solver.matsolver == 'inverse_refined'
    assert pencil.G == NX and pencil.matrices['M'].dtype == torch.complex128
    assert pencil.separable is not None
    nyquist = (NX - 1) // 2 + 1
    assert not pencil.row_valid[nyquist].any() and not pencil.col_valid[nyquist].any()
    assert pencil.row_valid[nyquist - 1].any()
    waves = [sp.group_dict['nx'] for sp in pencil.subproblems]
    assert waves == list((np.arange(NX) + (NX - 1) // 2) % NX - (NX - 1) // 2)
    for name in ('M', 'L'):
        for g in (1, NX - 1, NX // 3):
            exact = pencil.assemble_group(g, [name])[name].toarray()
            assert np.abs(pencil.matrices_scipy[name][g].toarray() - exact).max() <= 1e-12
