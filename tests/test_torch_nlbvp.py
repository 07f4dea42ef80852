"""The nonlinear boundary value problem of the PyTorch port against
dedalus_tpu, each side built by the same lines (device='cpu' for the port):

  * the JAX package's own NLBVPs (tests/test_nlbvp.py's Riccati equation and
    nonlinear diffusion, tests/test_grid_operators.py's ufunc Bratu
    problem): every Newton iterate held to the JAX package's to 1e-12
    relative to the state's largest coefficient (a tau converges to
    round-off), the perturbation norms too;
  * the Lane-Emden example (examples/nlbvp_ball_lane_emden.py, built by
    dedalus_tpu_torch.models.lane_emden at Nr = 64): the dF pencil matrix
    of iterations 1 and 2 equal to the JAX package's to 1e-13, one Newton
    step from the JAX package's iterate k (k = 0, 2, 4) within 1e-12 of its
    iterate k + 1 (relative to the state's largest coefficient), the same iteration count to the example's 1e-10, and R
    within 1e-10 of Boyd's value and of the JAX package's R;
  * the Frechet differential of every linear operator the port has: each
    rebuilds itself on the perturbation (new_operands), so its differential
    evaluated at du = u equals the operator applied to u (1e-13), and the
    product, power and ufunc rules against finite differences of F.
"""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.models import lane_emden as le
from dedalus_tpu_torch.utils.interop import set_state_from_reference

torch.set_num_threads(1)

ITERATE_TOL = 1e-12
DF_TOL = 1e-13
STEP_TOL = 1e-12
R_TOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _scale(state):
    """The largest coefficient of a state: the scale its fields and its
    perturbation norms are held to (a tau that converges to round-off has
    no relative error of its own)."""
    return max(np.abs(a).max() for a in state.values())


def _state(fields):
    out = {}
    for f in fields:
        f.require_coeff_space()
        f.change_scales(1)
        out[f.name] = _np(f.data).copy()
    return out


# --- the JAX package's NLBVP tests, iterate by iterate ---

def _riccati(d3, **dkw):
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, **dkw)
    xb = d3.ChebyshevT(c, size=32, bounds=(0, 0.5), dealias=2)
    u = dist.Field(name='u', bases=xb)
    tau = dist.Field(name='tau')
    lift = lambda A: d3.Lift(A, xb.derivative_basis(1), -1)
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.NLBVP([u, tau], namespace=locals())
    problem.add_equation("dx(u) + lift(tau) - u**2 = 0")
    problem.add_equation("u(x=0) = 1")
    x = dist.local_grid(xb, scale=1).ravel()
    u['g'] = 1 + x
    return problem, 1 / (1 - x), u


def _nonlinear_diffusion(d3, **dkw):
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, **dkw)
    xb = d3.ChebyshevT(c, size=48, bounds=(0, 1), dealias=2)
    u = dist.Field(name='u', bases=xb)
    t1 = dist.Field(name='t1')
    t2 = dist.Field(name='t2')
    f = dist.Field(name='f', bases=xb)
    x = dist.local_grid(xb, scale=1).ravel()
    f['g'] = np.exp(x) + 2 * np.exp(2 * x)
    lift = lambda A, n: d3.Lift(A, xb.derivative_basis(2), n)
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.NLBVP([u, t1, t2], namespace=locals())
    problem.add_equation("dx(u*dx(u)) + lift(t1,-1) + lift(t2,-2) - f = 0")
    problem.add_equation("u(x=0) = 2")
    problem.add_equation("u(x=1) = 1 + np.e")
    u['g'] = 2 + x
    return problem, 1 + np.exp(x), u


def _bratu(d3, **dkw):
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, **dkw)
    xb = d3.ChebyshevT(c, size=32, bounds=(0, 1))
    u = dist.Field(name='u', bases=xb)
    t1 = dist.Field(name='t1')
    t2 = dist.Field(name='t2')
    lam = 1.0
    dx = lambda A: d3.Differentiate(A, c)
    lift = lambda A, n: d3.Lift(A, xb.derivative_basis(2), n)
    problem = d3.NLBVP([u, t1, t2], namespace=locals())
    problem.add_equation("dx(dx(u)) + lift(t1,-1) + lift(t2,-2) = -lam*np.exp(u)")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation("u(x=1) = 0")
    return problem, None, u


CASES = dict(riccati=(_riccati, 1e-12, 1e-12), nonlinear_diffusion=(_nonlinear_diffusion,
             1e-12, 1e-10), bratu=(_bratu, 1e-12, None))


@pytest.mark.parametrize('case', sorted(CASES))
def test_iterates_match_reference(case):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    build, stop, exact_tol = CASES[case]
    jproblem, _, ju = build(jd3)
    tproblem, exact, tu = build(td3, device='cpu')
    jsolver, tsolver = jproblem.build_solver(), tproblem.build_solver()
    for it in range(30):
        jn = jsolver.newton_iteration()
        tn = tsolver.newton_iteration()
        jstate, tstate = _state(jproblem.variables), _state(tproblem.variables)
        scale = _scale(jstate)
        assert abs(tn - jn) <= ITERATE_TOL * max(jn, scale), (it, tn, jn)
        for name, ref in jstate.items():
            assert np.abs(tstate[name] - ref).max() <= ITERATE_TOL * scale, (it, name)
        if jn < stop:
            break
    assert tn < stop and it < 12
    if exact_tol is not None:
        tu.change_scales(1)
        assert np.abs(_np(tu['g']) - exact).max() < exact_tol


# --- Lane-Emden ---

def _jax_lane_emden():
    """The example's lines in the JAX package."""
    import dedalus_tpu.public as d3
    Nr, n = 64, 3.0
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=np.float64)
    ball = d3.BallBasis(coords, shape=(1, 1, Nr), radius=1, dtype=np.float64, dealias=2)
    f = dist.Field(name='f', bases=ball)
    tau = dist.Field(name='tau', bases=ball.surface)
    lift = lambda A: d3.Lift(A, ball, -1)
    problem = d3.NLBVP([f, tau], namespace=locals())
    problem.add_equation("lap(f) + lift(tau) = - f**n")
    problem.add_equation("f(r=1) = 0")
    phi, theta, r = dist.local_grids(ball)
    f.change_scales(ball.dealias)
    f['g'] = 5**(2 / (n - 1)) * (1 - r**2)**2
    return problem, f


@pytest.fixture(scope='module')
def lane_emden_reference():
    """The JAX package's run: its iterates (coefficient data of f and tau,
    the initial guess first), its norms, the dF matrices of iterations 1 and
    2, and R."""
    problem, f = _jax_lane_emden()
    solver = problem.build_solver(ncc_cutoff=le.NCC_CUTOFF)
    iterates, norms, dF = [_state(problem.variables)], [], []
    while not norms or norms[-1] > le.TOLERANCE:
        norms.append(solver.newton_iteration())
        iterates.append(_state(problem.variables))
        if len(dF) < 2:
            dF.append(solver.pencil.matrices_scipy['dF'][0].toarray())
    f0 = f(r=0).evaluate()
    f0.change_scales(1)
    f0.require_grid_space()
    R = float(np.asarray(f0.data).ravel()[0]) ** ((3.0 - 1) / 2)
    return dict(iterates=iterates, norms=norms, dF=dF, R=R)


def test_lane_emden_dF_matches_reference(lane_emden_reference):
    problem, ctx = le.build_lane_emden_problem(device='cpu')
    solver = problem.build_solver(ncc_cutoff=le.NCC_CUTOFF)
    for k, ref in enumerate(lane_emden_reference['dF']):
        solver.newton_iteration()
        got = solver.pencil.matrices_scipy['dF'][0].toarray()
        assert _rel(got, ref) <= DF_TOL, k
        # the device stack the factorization read is the same matrix
        dense = _np(solver.pencil.matrices['dF'][0])
        assert np.array_equal(dense, got)


@pytest.mark.parametrize('k', [0, 2, 4])
def test_lane_emden_step_from_reference_iterate(lane_emden_reference, k):
    problem, ctx = le.build_lane_emden_problem(device='cpu')
    solver = problem.build_solver(ncc_cutoff=le.NCC_CUTOFF)
    set_state_from_reference(solver, lane_emden_reference['iterates'][k])
    norm = solver.newton_iteration()
    want = lane_emden_reference['iterates'][k + 1]
    scale = _scale(want)
    assert abs(norm - lane_emden_reference['norms'][k]) <= STEP_TOL * scale
    got = _state(problem.variables)
    for name, ref in want.items():
        assert np.abs(got[name] - ref).max() <= STEP_TOL * scale, name


def test_lane_emden_converges_as_reference(lane_emden_reference):
    problem, ctx = le.build_lane_emden_problem(device='cpu')
    solver = problem.build_solver(ncc_cutoff=le.NCC_CUTOFF)
    norms = le.solve(solver)
    assert len(norms) == len(lane_emden_reference['norms'])
    R = le.radius(ctx)
    assert abs(R - le.R_BOYD) < R_TOL
    assert abs(R - lane_emden_reference['R']) < R_TOL
    assert solver.perturbations[0].name == 'df' and solver.state == solver.perturbations


# --- the Frechet differentials ---

def _linear_cases(td3):
    """(label, u, expression linear in u) over every geometry's operators."""
    cases = []
    c = td3.Coordinate('x')
    dist = td3.Distributor(c, dtype=np.float64, device='cpu')
    xb = td3.ChebyshevT(c, size=16, bounds=(0, 1))
    u = dist.Field(name='u', bases=xb)
    tau = dist.Field(name='tau')
    dx = lambda A: td3.Differentiate(A, c)
    cases += [('cheb', u, dx(u)), ('cheb', u, td3.Convert(u, (xb.derivative_basis(2),))),
              ('cheb', u, u(x=0.3)), ('cheb', u, td3.Integrate(u, c)),
              ('cheb', tau, td3.Lift(tau, xb.derivative_basis(2), -1))]
    coords = td3.CartesianCoordinates('x', 'z')
    dist = td3.Distributor(coords, dtype=np.float64, device='cpu')
    fb = td3.RealFourier(coords['x'], 8, bounds=(0, 2 * np.pi))
    zb = td3.ChebyshevT(coords['z'], 8, bounds=(0, 1))
    v = dist.VectorField(coords, name='v', bases=(fb, zb))
    cases += [('box', v, td3.div(v)), ('box', v, td3.skew(v)),
              ('box', v, td3.trace(td3.grad(v)))]
    coords = td3.PolarCoordinates('phi', 'r')
    dist = td3.Distributor(coords, dtype=np.float64, device='cpu')
    disk = td3.DiskBasis(coords, (8, 8), radius=1, dtype=np.float64)
    s = dist.Field(name='s', bases=disk)
    w = dist.VectorField(coords, name='w', bases=disk)
    cases += [('disk', s, td3.lap(s)), ('disk', s, td3.grad(s)), ('disk', w, td3.div(w)),
              ('disk', w, td3.trace(td3.grad(w))), ('disk', s, s(r=1)),
              ('disk', s, td3.Lift(s(r=1), disk, -1)), ('disk', w, td3.azimuthal(w)),
              ('disk', s, td3.Convert(s, td3.lap(s).domain.bases))]
    coords = td3.S2Coordinates('phi', 'theta')
    dist = td3.Distributor(coords, dtype=np.float64, device='cpu')
    sph = td3.SphereBasis(coords, (8, 4), radius=1, dtype=np.float64)
    h = dist.Field(name='h', bases=sph)
    q = dist.VectorField(coords, name='q', bases=sph)
    cases += [('sphere', h, td3.lap(h)), ('sphere', h, td3.grad(h)),
              ('sphere', q, td3.div(q)), ('sphere', q, td3.skew(q)),
              ('sphere', h, td3.MulCosine(h)), ('sphere', h, td3.integ(h))]
    coords = td3.SphericalCoordinates('phi', 'theta', 'r')
    dist = td3.Distributor(coords, dtype=np.float64, device='cpu')
    ball = td3.BallBasis(coords, (8, 4, 6), radius=1, dtype=np.float64)
    shell = td3.ShellBasis(coords, (8, 4, 6), radii=(1, 2), dtype=np.float64)
    b = dist.Field(name='b', bases=ball)
    bv = dist.VectorField(coords, name='bv', bases=ball)
    sv = dist.VectorField(coords, name='sv', bases=shell)
    bt = dist.Field(name='bt', bases=ball.surface)
    c0 = dist.Field(name='c0')
    from dedalus_tpu_torch.core import operators_ball as ob
    ez = dist.VectorField(coords, name='ez', bases=ball.radial_basis)
    cases += [('ball', b, td3.lap(b)), ('ball', b, td3.grad(b)), ('ball', bv, td3.div(bv)),
              ('ball', bv, td3.curl(bv)), ('ball', bv, td3.transpose(td3.grad(bv))),
              ('ball', bv, td3.trace(td3.grad(bv))), ('ball', bv, td3.radial(bv)),
              ('ball', bv, td3.angular(bv)), ('ball', b, b(r=1)),
              ('ball', bt, td3.Lift(bt, ball, -1)), ('ball', b, td3.integ(b)),
              ('ball', bv, td3.SphericalEllProduct(bv, coords, lambda ell: ell + 1)),
              ('ball', bv, ob.SphericalZCross(bv)),
              ('ball', b, td3.Convert(b, td3.lap(b).domain.bases)),
              ('ball', c0, td3.Convert(c0, (ball,))),
              ('shell', sv, td3.div(sv)), ('shell', sv, td3.lap(sv)),
              ('shell', sv, td3.radial(sv)), ('shell', sv, sv(r=2))]
    return cases


def _random_fill(field, seed):
    field.require_grid_space()
    field.change_scales(1)
    field.preset_data(field.dist.grid_layout, torch.as_tensor(
        np.random.default_rng(seed).standard_normal(tuple(field.data.shape))))
    field.require_coeff_space()


def _eval_coeff(expr):
    out = expr.evaluate()
    out.require_coeff_space()
    out.change_scales(1)
    return _np(out.data)


def test_linear_operators_rebuild_on_the_perturbation():
    """Every linear operator's differential is itself applied to the
    perturbation: evaluated at du = u it equals the operator on u. Every
    LinearOperator subclass of the port with its own new_operands is
    reached."""
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu_torch.core.operators import LinearOperator
    seen = set()
    for i, (label, u, expr) in enumerate(_linear_cases(td3)):
        _random_fill(u, i)
        du = u.copy()
        du.name = 'd' + (u.name or '')
        d = expr.sym_diff([u], [du])
        assert type(d) is type(expr), (label, type(expr).__name__)
        assert d.has(du) and not d.has(u)
        got, ref = _eval_coeff(d), _eval_coeff(expr)
        assert _rel(got, ref) <= DF_TOL or np.abs(ref).max() < 1e-13, (label, type(expr))
        nodes = [expr]
        while nodes:
            node = nodes.pop()
            if isinstance(node, LinearOperator):
                seen.add(type(node))
            nodes += getattr(node, '_operands', [])
        assert expr.frechet_differential([u], [du], backgrounds=[u]) is not None
    def leaves(cls):
        out = set()
        for sub in cls.__subclasses__():
            if 'new_operands' in vars(sub) and sub.__module__.startswith('dedalus_tpu_torch'):
                out.add(sub)
            out |= leaves(sub)
        return out
    # TimeDerivative is linear by construction and only split, never differentiated
    missing = {c.__name__ for c in leaves(LinearOperator)
               if not any(issubclass(t, c) for t in seen)} - {'TimeDerivative'}
    assert not missing, missing


@pytest.mark.parametrize('expr_str', ['u**3', 'u*dx(u)', 'np.sin(u)', 'np.exp(u)*u',
                                      'np.sqrt(2 + u)', 'np.tanh(u)', 'np.log(3 + u)'])
def test_nonlinear_rules_against_finite_differences(expr_str):
    """Power, Multiply and the ufunc table: F(u + e du) - F(u - e du)
    over 2e against the differential at du."""
    import dedalus_tpu_torch.public as td3
    c = td3.Coordinate('x')
    dist = td3.Distributor(c, dtype=np.float64, device='cpu')
    xb = td3.ChebyshevT(c, size=24, bounds=(0, 1), dealias=2)
    u = dist.Field(name='u', bases=xb)
    du = dist.Field(name='du', bases=xb)
    dx = lambda A: td3.Differentiate(A, c)
    x = dist.local_grid(xb, scale=1).ravel()
    ns = dict(u=u, dx=dx, np=np)
    F = eval(expr_str, ns)
    dF = F.frechet_differential([u], [du])
    u0 = 0.3 * np.sin(2 * x)
    du['g'] = np.cos(3 * x)
    eps = 1e-6
    vals = []
    for sgn in (1, -1):
        u['g'] = u0 + sgn * eps * np.cos(3 * x)
        vals.append(_eval_coeff(F))
    u['g'] = u0
    fd = (vals[0] - vals[1]) / (2 * eps)
    assert _rel(_eval_coeff(dF), fd) < 1e-8


@pytest.mark.parametrize('expr_str', ['dot(v, v)', 'cross(v, grad(dot(v, v)))',
                                      'dot(v, grad(v))'])
def test_vector_products_against_finite_differences(expr_str):
    """DotProduct and CrossProduct: the product rule against finite
    differences on a small 3-D box."""
    import dedalus_tpu_torch.public as td3
    coords = td3.CartesianCoordinates('x', 'y', 'z')
    dist = td3.Distributor(coords, dtype=np.float64, device='cpu')
    xb = td3.RealFourier(coords['x'], 4, bounds=(0, 2 * np.pi), dealias=3 / 2)
    yb = td3.RealFourier(coords['y'], 4, bounds=(0, 2 * np.pi), dealias=3 / 2)
    zb = td3.ChebyshevT(coords['z'], 6, bounds=(0, 1), dealias=3 / 2)
    v = dist.VectorField(coords, name='v', bases=(xb, yb, zb))
    dv = dist.VectorField(coords, name='dv', bases=(xb, yb, zb))
    F = eval(expr_str, dict(v=v, dot=td3.dot, cross=td3.cross, grad=td3.grad))
    dF = F.frechet_differential([v], [dv])
    rng = np.random.default_rng(len(expr_str))
    shape = tuple(v['g'].shape)
    v0, dv0 = rng.standard_normal(shape), rng.standard_normal(shape)
    dv['g'] = dv0
    eps = 1e-6
    vals = []
    for sgn in (1, -1):
        v['g'] = v0 + sgn * eps * dv0
        vals.append(_eval_coeff(F))
    v['g'] = v0
    fd = (vals[0] - vals[1]) / (2 * eps)
    assert _rel(_eval_coeff(dF), fd) < 1e-8
