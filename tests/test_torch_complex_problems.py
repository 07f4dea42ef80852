"""Complex problems on the PyTorch port against dedalus_tpu, and the complex
forms of the dense-path kernels' plain twins.

The JAX package's own complex cases, with their tolerances:
tests/test_ivp.py:196 (test_complex_fourier_ivp: RK443 advection, < 1e-8
of the exact phase), tests/test_lbvp.py:171 (conditions read the signed
ComplexFourier wavenumber, < 1e-13), tests/test_random.py:51 (complex draws,
here through Field.fill_random, bit for bit), and the complex cases of
tests/test_cartesian_ncc.py :21, :44, :96, :121 (1e-9, 1e-10, 1e-11,
1e-12); each also against the JAX package's own result.

Where the reference raises on complex data, the port raises: complex
stacks past [memory] max_dense_stack_gb (RK222 and SBDF2: the reference has
no complex banded or poly solver), `poly` on a complex stack, and
GlobalFlowProperty.max of complex data (TypeError). The port also refuses
`mixed` and `matrix_free` on complex stacks, whose float32 inverse would
drop the imaginary part: the JAX package runs them and loses it.

The twins: KA, KB, KG, KD and K3 on complex inputs whose imaginary parts
are zero equal their float64 forms (K3, KG, KD exactly), and K7 and KC on
complex slots act on the two parts alike. ComplexWarning is an error here.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.utils.config import config as jconfig
from dedalus_tpu_torch.utils.config import config as tconfig

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings('error::numpy.exceptions.ComplexWarning')

PACKAGES = {'jax': (jd3, {}), 'torch': (td3, dict(device='cpu'))}


def both(fn):
    """fn(d3, dist_kw) run on both packages: {'jax': ..., 'torch': ...}."""
    return {name: fn(d3, kw) for name, (d3, kw) in PACKAGES.items()}


# ---------------------------------------------------------------------------
# Problems
# ---------------------------------------------------------------------------

def _advection(d3, kw):
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.complex128, **kw)
    xb = d3.ComplexFourier(c, size=16, bounds=(0, 2 * np.pi))
    u = dist.Field(name='u', bases=xb)
    v = 0.7
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.IVP([u], namespace=locals())
    problem.add_equation("dt(u) + v*dx(u) = 0")
    solver = problem.build_solver(d3.RK443)
    x = dist.local_grid(xb, scale=1).ravel()
    u['g'] = np.exp(2j * x)
    n, timestep = 100, 1e-3
    for _ in range(n):
        solver.step(timestep)
    u.change_scales(1)
    return np.array(u['g']), np.exp(2j * (x - v * n * timestep))


def test_complex_fourier_ivp():
    out = both(_advection)
    got, exact = out['torch']
    assert np.abs(got - exact).max() < 1e-8
    assert np.abs(got - out['jax'][0]).max() < 1e-12


def _signed_lbvp(d3, kw):
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.complex128, **kw)
    xb = d3.ComplexFourier(c, size=16, bounds=(0, 2 * np.pi))
    u = dist.Field(name='u', bases=xb)
    f = dist.Field(name='f', bases=xb)
    x = dist.local_grid(xb, scale=1).ravel()
    f['g'] = 2 * np.cos(x)
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.LBVP([u], namespace=locals())
    problem.add_equation("dx(dx(u)) = f", condition="nx > 0")
    problem.add_equation("u = 0", condition="nx <= 0")
    solver = problem.build_solver()
    solver.solve()
    u.change_scales(1)
    return np.array(u['g']), -np.exp(1j * x)


def test_conditions_complex_fourier_signed_wavenumbers():
    """Only k = +1 survives the condition nx > 0: with the storage index in
    place of the signed wavenumber, the k = -1 mode would leak into u."""
    out = both(_signed_lbvp)
    got, expect = out['torch']
    assert np.abs(got - expect).max() < 1e-13
    assert np.abs(got - out['jax'][0]).max() < 1e-13


def test_complex_fill_random_matches_jax():
    """tests/test_random.py:51 through Field.fill_random: the complex draw
    equals the JAX package's bit for bit, and is complex."""
    def draw(d3, kw):
        coords = d3.CartesianCoordinates('x', 'z')
        dist = d3.Distributor(coords, dtype=np.complex128, **kw)
        xb = d3.ComplexFourier(coords['x'], 12, (0, 1))
        zb = d3.ChebyshevT(coords['z'], 6, (0, 1))
        f = dist.Field(bases=(xb, zb))
        f.fill_random('g', seed=9, distribution='normal', scale=1e-3)
        return np.array(f['g'])
    out = both(draw)
    np.testing.assert_array_equal(out['torch'], out['jax'])
    assert np.any(out['torch'].imag != 0)


@pytest.mark.parametrize('a0, b0', [(-1/2, -1/2), (0, 0), (-1/2, 1/2)])
@pytest.mark.parametrize('k_ncc', [0, 1])
def test_jacobi_ncc_scalar_complex(a0, b0, k_ncc):
    """tests/test_cartesian_ncc.py:21, complex128."""
    dtype = np.complex128

    def solve(d3, kw):
        N = 32
        c = d3.Coordinate('z')
        dist = d3.Distributor(c, dtype=dtype, **kw)
        zb = d3.Jacobi(c, size=N, bounds=(0, 1), a=a0, b=b0, dtype=dtype)
        zb_ncc = d3.Jacobi(c, size=N, bounds=(0, 1), a=a0 + k_ncc, b=b0 + k_ncc,
                           a0=a0, b0=b0, dtype=dtype)
        z = dist.local_grid(zb, scale=1).ravel()
        w0 = dist.Field(name='w0', bases=zb_ncc)
        w0['g'] = np.sin(2 * z) + 0.3 * z**2
        target = np.cos(3 * z) * (1 + 0.5 * z)
        rhs = dist.Field(name='rhs', bases=zb)
        rhs['g'] = ((2 + np.sin(2 * z) + 0.3 * z**2) * target).astype(dtype)
        u = dist.Field(name='u', bases=zb)
        problem = d3.LBVP([u], namespace=locals())
        problem.add_equation("2*u + w0*u = rhs")
        problem.build_solver().solve()
        u.change_scales(1)
        return np.asarray(u['g']).ravel(), target

    out = both(solve)
    got, target = out['torch']
    assert np.abs(got - target).max() < 1e-9
    assert np.abs(got - out['jax'][0]).max() < 1e-12


@pytest.mark.parametrize('basis_name', ['ChebyshevT', 'Legendre', 'ChebyshevU'])
def test_jacobi_ncc_families_complex(basis_name):
    """tests/test_cartesian_ncc.py:44, complex128."""
    dtype = np.complex128

    def solve(d3, kw):
        N = 32
        c = d3.Coordinate('z')
        dist = d3.Distributor(c, dtype=dtype, **kw)
        zb = getattr(d3, basis_name)(c, size=N, bounds=(-1, 1), dtype=dtype)
        z = dist.local_grid(zb, scale=1).ravel()
        w0 = dist.Field(name='w0', bases=zb)
        w0['g'] = 0.5 * z**3 - z
        target = np.exp(-z**2) * np.sin(2 * z)
        rhs = dist.Field(name='rhs', bases=zb)
        rhs['g'] = ((3 + 0.5 * z**3 - z) * target).astype(dtype)
        u = dist.Field(name='u', bases=zb)
        problem = d3.LBVP([u], namespace=locals())
        problem.add_equation("3*u + w0*u = rhs")
        problem.build_solver().solve()
        u.change_scales(1)
        return np.asarray(u['g']).ravel(), target

    out = both(solve)
    got, target = out['torch']
    assert np.abs(got - target).max() < 1e-10
    assert np.abs(got - out['jax'][0]).max() < 1e-12


def test_2d_separable_ncc_vector_complex():
    """tests/test_cartesian_ncc.py:96, complex128: a z-dependent NCC times a
    vector on ComplexFourier x ChebyshevT."""
    dtype = np.complex128

    def solve(d3, kw):
        Nx, Nz = 16, 24
        coords = d3.CartesianCoordinates('x', 'z')
        dist = d3.Distributor(coords, dtype=dtype, **kw)
        xb = d3.ComplexFourier(coords['x'], size=Nx, bounds=(0, 2 * np.pi), dtype=dtype)
        zb = d3.ChebyshevT(coords['z'], size=Nz, bounds=(0, 1), dtype=dtype)
        x, z = dist.local_grids(xb, zb, scales=1)
        w0 = dist.Field(name='w0', bases=zb)
        w0['g'] = 2 + np.sin(np.pi * z)
        u = dist.VectorField(coords, name='u', bases=(xb, zb))
        tg = np.stack([np.cos(x) * z**2 + 0 * z, np.sin(2 * x) * (1 - z) + 0.1 * z])
        rhs = dist.VectorField(coords, name='rhs', bases=(xb, zb))
        rhs['g'] = ((3 + np.sin(np.pi * z)) * tg).astype(dtype)
        problem = d3.LBVP([u], namespace=locals())
        problem.add_equation("u + w0*u = rhs")
        problem.build_solver().solve()
        u.change_scales(1)
        return np.asarray(u['g']), tg

    out = both(solve)
    got, tg = out['torch']
    assert np.abs(got - tg).max() < 1e-11
    assert np.abs(got - out['jax'][0]).max() < 1e-12


def test_fourier_ncc_pseudospectral_complex():
    """tests/test_cartesian_ncc.py:121, complex128: a product of two
    ComplexFourier fields on the grid."""
    def product(d3, kw):
        N = 32
        c = d3.Coordinate('x')
        dist = d3.Distributor(c, dtype=np.complex128, **kw)
        xb = d3.ComplexFourier(c, size=N, bounds=(0, 2 * np.pi), dtype=np.complex128)
        x = dist.local_grid(xb, scale=1).ravel()
        f = dist.Field(name='f', bases=xb)
        g = dist.Field(name='g', bases=xb)
        f['g'] = np.sin(x) + 0.5 * np.cos(3 * x)
        g['g'] = np.cos(2 * x)
        w = (f * g).evaluate()
        w.change_scales(1)
        return np.asarray(w['g']).ravel(), (np.sin(x) + 0.5 * np.cos(3 * x)) * np.cos(2 * x)

    out = both(product)
    got, expect = out['torch']
    assert np.abs(got - expect).max() < 1e-12
    assert np.abs(got - out['jax'][0]).max() < 1e-14


def test_complex_constants_and_scalars():
    """A complex constant on the right (as_operand) and a complex scalar
    factor make complex expressions, as the JAX package's."""
    def run(d3, kw):
        c = d3.Coordinate('x')
        dist = d3.Distributor(c, dtype=np.complex128, **kw)
        xb = d3.ComplexFourier(c, size=8, bounds=(0, 2 * np.pi))
        u = dist.Field(name='u', bases=xb)
        x = dist.local_grid(xb, scale=1).ravel()
        u['g'] = np.exp(1j * x)
        w = ((2 + 1j) * u + 1j).evaluate()
        w.change_scales(1)
        return np.asarray(w['g']).ravel(), np.dtype(w.dtype)

    out = both(run)
    assert out['torch'][1] == out['jax'][1] == np.complex128
    assert np.abs(out['torch'][0] - out['jax'][0]).max() < 1e-15


# ---------------------------------------------------------------------------
# Where the reference raises on complex data, the port raises
# ---------------------------------------------------------------------------

def _tiny_complex_rbc(d3, kw, scheme, **solver_kw):
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.complex128, **kw)
    xbasis = d3.ComplexFourier(coords['x'], size=8, bounds=(0, 4), dealias=3 / 2)
    zbasis = d3.ChebyshevT(coords['z'], size=8, bounds=(0, 1), dealias=3 / 2)
    b = dist.Field(name='b', bases=(xbasis, zbasis))
    tau1 = dist.Field(name='tau1', bases=xbasis)
    tau2 = dist.Field(name='tau2', bases=xbasis)
    lift = lambda A, n: d3.Lift(A, zbasis.derivative_basis(2), n)
    problem = d3.IVP([b, tau1, tau2], namespace=locals())
    problem.add_equation("dt(b) - lap(b) + lift(tau1, -1) + lift(tau2, -2) = - b*b")
    problem.add_equation("b(z=0) = 1")
    problem.add_equation("b(z=1) = 0")
    solver = problem.build_solver(getattr(d3, scheme), **solver_kw)
    z = dist.local_grid(zbasis, scale=1)
    b['g'] = (1 - z) + 0 * dist.local_grid(xbasis, scale=1)
    return solver


@pytest.fixture
def no_dense_stacks():
    old = (jconfig.get('memory', 'max_dense_stack_gb'),
           tconfig.get('memory', 'max_dense_stack_gb'))
    jconfig.set('memory', 'max_dense_stack_gb', '0')
    tconfig.set('memory', 'max_dense_stack_gb', '0')
    yield
    jconfig.set('memory', 'max_dense_stack_gb', old[0])
    tconfig.set('memory', 'max_dense_stack_gb', old[1])


@pytest.mark.parametrize('scheme', ['RK222', 'SBDF2'])
def test_complex_stacks_past_the_dense_limit_raise(no_dense_stacks, scheme):
    for name, (d3, kw) in PACKAGES.items():
        with pytest.raises(ValueError) as err:
            _tiny_complex_rbc(d3, kw, scheme).step(1e-3)
        if name == 'torch':
            assert 'max_dense_stack_gb' in str(err.value)


def _complex_stack(G=4, P=6, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((G, P, P)) + 1j * rng.standard_normal((G, P, P)) + 4 * np.eye(P)
    R = rng.standard_normal((G, P)) + 1j * rng.standard_normal((G, P))
    return A, R


def test_poly_refuses_complex_stacks():
    from dedalus_tpu.ops.solve import FactorizedStack as JStack
    from dedalus_tpu_torch.ops.solve import FactorizedStack as TStack
    A, _ = _complex_stack(G=8)
    with pytest.raises(ValueError, match='real stack'):
        JStack(A, method='poly')
    with pytest.raises(ValueError, match='real stack'):
        TStack(torch.as_tensor(A), method='poly')


@pytest.mark.parametrize('method', ['mixed', 'matrix_free'])
def test_float32_inverses_refuse_complex_stacks(method):
    """The port refuses what the JAX package gets wrong: its float32
    inverse of a complex stack keeps only the real part (its mixed solve's
    residual is of the size of the right-hand side)."""
    from dedalus_tpu.ops.solve import FactorizedStack as JStack
    from dedalus_tpu_torch.ops.solve import FactorizedStack as TStack
    A, R = _complex_stack()
    with pytest.raises(ValueError, match='imaginary part'):
        TStack(torch.as_tensor(A), method=method)
    with pytest.raises(ValueError, match='imaginary part'):
        _tiny_complex_rbc(td3, dict(device='cpu'), 'SBDF2', matsolver=method).step(1e-3)
    if method == 'mixed':
        with pytest.warns(Warning):
            X = np.asarray(JStack(A, method=method).solve(R))
        assert np.abs(np.einsum('gij,gj->gi', A, X) - R).max() > 1e-3 * np.abs(R).max()


@pytest.mark.parametrize('method', ['lu', 'inverse', 'inverse_refined'])
def test_dense_matsolvers_solve_complex_stacks_as_jax(method):
    from dedalus_tpu.ops.solve import FactorizedStack as JStack
    from dedalus_tpu_torch.ops.solve import FactorizedStack as TStack
    A, R = _complex_stack()
    X = TStack(torch.as_tensor(A), method=method).solve(torch.as_tensor(R)).numpy()
    Xj = np.asarray(JStack(A, method=method).solve(R))
    assert np.abs(X - Xj).max() <= 1e-12 * np.abs(Xj).max()
    assert np.abs(np.einsum('gij,gj->gi', A, X) - R).max() <= 1e-12 * np.abs(R).max()


def test_global_flow_property_max_of_complex_data_raises():
    """dedalus_tpu/extras/flow_tools.py:39: float(jnp.max(...)) of complex
    data raises TypeError; the port's max and min raise it too."""
    for name, (d3, kw) in PACKAGES.items():
        solver = _tiny_complex_rbc(d3, kw, 'RK222')
        flow = d3.GlobalFlowProperty(solver, cadence=1)
        flow.add_property(solver.state[0] * 1, name='b')
        solver.step(1e-3)
        with pytest.raises(TypeError):
            flow.max('b')
        if name == 'torch':
            with pytest.raises(TypeError):
                flow.min('b')


# ---------------------------------------------------------------------------
# The complex forms of the dense-path kernels' twins
# ---------------------------------------------------------------------------

def _real_and_complex(*arrays):
    reals = [torch.as_tensor(a) for a in arrays]
    return reals, [r.to(torch.complex128) for r in reals]


def test_ka_kb_twins_on_real_valued_complex_stacks():
    from dedalus_tpu_torch.ops import solve as S
    rng = np.random.default_rng(4)
    G, P = 5, 9
    A = rng.standard_normal((G, P, P)) + 4 * np.eye(P)
    Ainv = np.linalg.inv(A)
    R = rng.standard_normal((G, P))
    (Ar, Air, Rr), (Ac, Aic, Rc) = _real_and_complex(A, Ainv, R)
    for passes in (0, 1):
        xr = S.dense_refined_solve(Air, Ar, Rr, passes)
        xc = S.dense_refined_solve(Aic, Ac, Rc, passes)
        assert float((xc - xr).abs().max()) <= 1e-15 * float(xr.abs().max())
        assert float(xc.imag.abs().max()) == 0.0
    y0, y1 = S.dense_matvec(Ac, Rc, Aic)
    r0, r1 = S.dense_matvec(Ar, Rr, Air)
    assert float((y0 - r0).abs().max()) <= 1e-15 * float(r0.abs().max())
    assert float((y1 - r1).abs().max()) <= 1e-15 * float(r1.abs().max())


def test_kg_kd_twins_on_real_valued_complex_grids():
    from dedalus_tpu_torch.ops import products as KG
    from dedalus_tpu_torch.csrc.cfl_max import cfl_max
    rng = np.random.default_rng(5)
    (a, b, c), (ac, bc, cc) = _real_and_complex(rng.standard_normal((2, 6, 5)),
                                                rng.standard_normal((2, 2, 6, 5)),
                                                rng.standard_normal((6, 5)))
    assert torch.equal(KG.grid_product(ac, bc, 1, 2, True).real, KG.grid_product(a, b, 1, 2, True))
    assert torch.equal(KG.grid_product(cc, ac, 0, 1, False, -0.5).real,
                       KG.grid_product(c, a, 0, 1, False, -0.5))
    assert float(cfl_max([ac[0].contiguous(), ac[1].contiguous()])) == \
        float(cfl_max([a[0].contiguous(), a[1].contiguous()]))
    # A complex scale on complex data is the complex product
    z = (ac + 1j * bc[0]).contiguous()
    out = KG.grid_product(z, z, 1, 1, True, 0.5 - 2j)
    assert torch.allclose(out, (0.5 - 2j) * (z * z).sum(0), rtol=1e-15, atol=0)


def test_k3_twins_on_complex_state_are_exact():
    """The pencil gather and scatter of a complex state equal those of its
    two parts taken apart, exactly (the constant fields' sums included)."""
    from dedalus_tpu_torch.core import subsystems as sub
    solver = _tiny_complex_rbc(td3, dict(device='cpu'), 'SBDF2')
    pencil = solver.pencil
    rng = np.random.default_rng(6)
    state = torch.as_tensor(rng.standard_normal(pencil.state_total)
                            + 1j * rng.standard_normal(pencil.state_total))
    X = pencil.gather_state(state)
    for part in ('real', 'imag'):
        Xp = pencil.gather_state(getattr(state, part).contiguous())
        assert torch.equal(getattr(X, part), Xp)
        assert torch.equal(getattr(pencil.scatter_state(X), part),
                           pencil.scatter_state(Xp))
    srcs = [torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n))
            for n in pencil.eq_gather.src_sizes]
    E = sub.pencil_gather(pencil.eq_gather, srcs)
    assert torch.equal(E.imag, sub.pencil_gather(pencil.eq_gather,
                                                 [s.imag.contiguous() for s in srcs]))


def test_k7_kc_twins_act_on_both_parts():
    from dedalus_tpu_torch.csrc.history_combine import history_combine
    from dedalus_tpu_torch.csrc.rk_combine import rk_stage_combine
    rng = np.random.default_rng(7)
    G, R = 4, 7
    c = [torch.as_tensor(rng.standard_normal((G, R)) + 1j * rng.standard_normal((G, R)))
         for _ in range(6)]
    rv = torch.as_tensor((rng.random((G, R)) > 0.2).astype(np.float64))
    coef = torch.as_tensor([0.5, -0.25, 1.0, 0.1, 1.5, -0.5])
    out = history_combine(c[0:2], c[2:4], c[4:6], rv, coef)
    for part in ('real', 'imag'):
        p = [getattr(t, part) for t in c]
        assert torch.equal(getattr(out, part), history_combine(p[0:2], p[2:4], p[4:6], rv, coef))
    coef2 = torch.as_tensor([0.3, 0.7, -0.2, 0.4])
    out = rk_stage_combine(c[0], c[1:3], c[3:5], rv, coef2)
    for part in ('real', 'imag'):
        p = [getattr(t, part) for t in c]
        assert torch.equal(getattr(out, part), rk_stage_combine(p[0], p[1:3], p[3:5], rv, coef2))
