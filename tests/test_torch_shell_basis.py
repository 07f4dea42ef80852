"""The shell basis and operators of the PyTorch port against dedalus_tpu at
8x4x10 on radii (1, 2) and 12x6x8 on the example's radii (7, 10), dealias
3/2, float64, on numpy-seeded data: grids and the longdouble quadrature
weights, scalar, vector and rank-2 transforms at k = 0 and k = 1 (the
weight (dR/r)^k per k) and their round trips, grad, div, lap, trace,
transpose, interpolation at both radii, the radial and angular components of
the stress-free row, lift at both radial modes, integ, the spherical NCC
matrices of rvec*lift(tau) and b*er and of a scalar profile, cross(ez, u) on
random u, the subproblem matrices against eager evaluation, and the
analytic cases of tests/test_ball.py's shell section (round trip and
Laplacian 1e-13 and 1e-8, the NCC LBVP with two walls 1e-13, the nonlinear
IVP's wall 1e-12). Tolerance 1e-12 relative to max(1, |ref|) against the
JAX package, as tests/test_shell_operators.py (atol 1e-12); the NCC
matrices 1e-12 relative to their largest entry (tests/test_spherical_ncc.py
allows 1e-9)."""

import numpy as np
import pytest
import torch

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

DEALIAS = 1.5
TOL = 1e-12


def _bases(d3, shape, radii, **dkw):
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    shell = d3.ShellBasis(coords, shape, radii=radii, dealias=DEALIAS, dtype=np.float64)
    return coords, dist, shell


@pytest.fixture(scope='module', params=[((8, 4, 10), (1, 2)), ((12, 6, 8), (7, 10))],
                ids=['8x4x10', '12x6x8'])
def pair(request):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    shape, radii = request.param
    return _bases(jd3, shape, radii), _bases(td3, shape, radii, device='cpu')


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _fields(pair, rank, seed, layout='g', bases=None, name='f'):
    """The same numpy-seeded data in a field of each package."""
    import jax.numpy as jnp
    out = []
    for coords, dist, shell in pair:
        out.append(dist.Field(name=name, bases=bases(shell) if bases else shell,
                              tensorsig=(coords,) * rank))
    jf, tf = out
    lay = 'grid_layout' if layout == 'g' else 'coeff_layout'
    if layout == 'g':
        jf.change_scales(DEALIAS)
        tf.change_scales(DEALIAS)
    shape = tuple(jf.required_shape(getattr(pair[0][1], lay), jf.scales))
    data = np.random.default_rng(seed).standard_normal(shape)
    jf.preset_data(getattr(pair[0][1], lay), jnp.asarray(data))
    tf.preset_data(getattr(pair[1][1], lay), data)
    return jf, tf


def _coeffs(f):
    f.require_coeff_space()
    f.change_scales(1)
    return f.data


# --- grids, weights, transforms ---

def test_grids_and_weights_match_reference(pair):
    for scale in (1, DEALIAS):
        for jb, tb in zip(pair[0][2].sub_bases, pair[1][2].sub_bases):
            _close(tb.global_grid(scale), jb.global_grid(scale), 1e-15)
        _close(pair[1][2].radial_basis.global_weights(scale),
               pair[0][2].radial_basis.global_weights(scale), 1e-15)


@pytest.mark.parametrize('k', [0, 1])
@pytest.mark.parametrize('rank', [0, 1, 2])
@pytest.mark.parametrize('direction', ['forward', 'backward'])
def test_transforms_match_reference(pair, rank, direction, k):
    bases = (lambda shell: shell.derivative_basis(k)) if k else None
    if direction == 'forward':
        jf, tf = _fields(pair, rank, 10 + rank + 3 * k, 'g', bases=bases)
        jf.require_coeff_space()
        tf.require_coeff_space()
    else:
        jf, tf = _fields(pair, rank, 20 + rank + 3 * k, 'c', bases=bases)
        for f in (jf, tf):
            f.change_scales(DEALIAS)
            f.require_grid_space()
    _close(tf.data, jf.data)


@pytest.mark.parametrize('rank', [0, 1, 2])
def test_transform_round_trips(pair, rank):
    _, tf = _fields(pair, rank, 30 + rank, 'g')
    tf.require_coeff_space()
    c0 = tf.data.clone()
    tf.require_grid_space()
    g0 = tf.data.clone()
    tf.require_coeff_space()
    _close(tf.data, c0.numpy())
    tf.require_grid_space()
    _close(tf.data, g0.numpy())


# --- operators ---

def _surface(shell):
    return shell.outer_surface


def _stress(d3, f, Ro):
    strain = d3.grad(f) + d3.transpose(d3.grad(f))
    return d3.angular(d3.radial(strain(r=Ro), index=1))


OPERATORS = {
    'lap_scalar': (0, lambda d3, f, R: d3.lap(f)),
    'grad_scalar': (0, lambda d3, f, R: d3.grad(f)),
    'interp_inner_scalar': (0, lambda d3, f, R: f(r=R[0])),
    'interp_outer_scalar': (0, lambda d3, f, R: f(r=R[1])),
    'integ_scalar': (0, lambda d3, f, R: d3.integ(f)),
    'lap_vector': (1, lambda d3, f, R: d3.lap(f)),
    'grad_vector': (1, lambda d3, f, R: d3.grad(f)),
    'div_vector': (1, lambda d3, f, R: d3.div(f)),
    'interp_inner_vector': (1, lambda d3, f, R: f(r=R[0])),
    'radial_outer_vector': (1, lambda d3, f, R: d3.radial(f(r=R[1]))),
    'angular_outer_vector': (1, lambda d3, f, R: d3.angular(f(r=R[1]))),
    'div_tensor': (2, lambda d3, f, R: d3.div(f)),
    'trace_tensor': (2, lambda d3, f, R: d3.trace(f)),
    'transpose_tensor': (2, lambda d3, f, R: d3.transpose(f)),
    'interp_outer_tensor': (2, lambda d3, f, R: f(r=R[1])),
    'trace_grad_vector': (1, lambda d3, f, R: d3.trace(d3.grad(f))),
    'shear_stress_vector': (1, lambda d3, f, R: _stress(d3, f, R[1])),
}


@pytest.mark.parametrize('name', sorted(OPERATORS))
def test_operators_match_reference(pair, name):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    rank, op = OPERATORS[name]
    radii = pair[1][2].radii
    jf, tf = _fields(pair, rank, 40 + len(name), 'g')
    jr, tr = op(jd3, jf, radii).evaluate(), op(td3, tf, radii).evaluate()
    assert [type(cs).__name__ for cs in tr.tensorsig] == \
        [type(cs).__name__ for cs in jr.tensorsig]
    _close(_coeffs(tr), _coeffs(jr))


@pytest.mark.parametrize('index', [-1, -2])
@pytest.mark.parametrize('rank', [0, 1, 2])
def test_lift_of_surface_fields_matches_reference(pair, rank, index):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jf, tf = _fields(pair, rank, 50 + rank, 'c', bases=_surface, name='tau')
    jr = jd3.Lift(jf, pair[0][2].derivative_basis(1), index).evaluate()
    tr = td3.Lift(tf, pair[1][2].derivative_basis(1), index).evaluate()
    _close(_coeffs(tr), _coeffs(jr))


def test_constant_embedding_matches_reference(pair):
    """A constant embedded into the shell basis (the tau_p column)."""
    from dedalus_tpu.core.operators_ball import BallConstantEmbed as JEmbed
    from dedalus_tpu_torch.core.operators_ball import BallConstantEmbed as TEmbed
    jc, tc = pair[0][1].Field(name='c'), pair[1][1].Field(name='c')
    jc['g'] = 0.7
    tc['g'] = 0.7
    for k in (0, 1):
        jrb, trb = pair[0][2].radial_basis, pair[1][2].radial_basis
        je = JEmbed(jc, jrb.derivative_basis(k)).evaluate()
        te = TEmbed(tc, trb.derivative_basis(k)).evaluate()
        _close(te.data, je.data)


def _ncc(side, vals, name, rank):
    coords, dist, shell = side
    f = dist.Field(name=name, bases=shell, tensorsig=(coords,) * rank)
    f.change_scales(1)
    f['g'] = np.ascontiguousarray(vals)
    return f


def _profiles(side):
    coords, dist, shell = side
    phi, theta, r = dist.local_grids(shell, scales=1)
    shp = np.broadcast_shapes(phi.shape, theta.shape, r.shape)
    rvec = np.zeros((3,) + shp)
    rvec[2] = r
    er = np.zeros((3,) + shp)
    er[2] = 1.0
    return dict(rvec=rvec, er=er, prof=np.broadcast_to(1 + r**2, shp))


NCC_CASES = {
    # (NCC name and rank, operand: 'tau' rank-1 lift at k=1, or the scalar b)
    'rvec*lift(tau_u)': ('rvec', 1, 'tau_u'),
    'rvec*lift(tau_b)': ('rvec', 1, 'tau_b'),
    'b*er': ('er', 1, 'b'),
    'prof*b': ('prof', 0, 'b'),
}


@pytest.mark.parametrize('case', sorted(NCC_CASES))
def test_spherical_ncc_matrices_match_reference(pair, case):
    """The NCC product's pencil matrices of every azimuthal group against
    the JAX package's."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.core import subsystems as jsub
    from dedalus_tpu_torch.core import subsystems as tsub
    ncc_name, ncc_rank, operand = NCC_CASES[case]
    mats = []
    for side, d3, sub in ((pair[0], jd3, jsub), (pair[1], td3, tsub)):
        coords, dist, shell = side
        ncc = _ncc(side, _profiles(side)[ncc_name], ncc_name, ncc_rank)
        if operand.startswith('tau'):
            var = dist.Field(name='tau', bases=shell.outer_surface,
                             tensorsig=(coords,) if operand == 'tau_u' else ())
            expr = ncc * d3.Lift(var, shell.derivative_basis(1), -1)
        else:
            var = dist.Field(name='b', bases=shell)
            expr = ncc * var if ncc_name == 'prof' else var * ncc
        coupled, sps = sub.enumerate_subproblems(dist, [expr.domain, var.domain],
                                                 expr.matrix_coupling(var))
        mats.append([expr.expression_matrices(sp, [var])[var].toarray() for sp in sps])
    assert len(mats[0]) == len(mats[1]) > 1
    for got, ref in zip(mats[1], mats[0]):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_cross_product_matches_reference(pair):
    """cross(ez, u) on random u: the left-handed frame's sign and ez's
    (theta, r) components."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    ez = []
    for side in pair:
        coords, dist, shell = side
        phi, theta, r = dist.local_grids(shell, scales=1)
        shp = np.broadcast_shapes(phi.shape, theta.shape, r.shape)
        d = np.zeros((3,) + shp)
        d[1] = -np.sin(theta) * np.ones(shp)
        d[2] = np.cos(theta) * np.ones(shp)
        ez.append(_ncc(side, d, 'ez', 1))
    ju, tu = _fields(pair, 1, 80, 'g')
    jr, tr = jd3.cross(ez[0], ju).evaluate(), td3.cross(ez[1], tu).evaluate()
    for f in (jr, tr):
        f.change_scales(DEALIAS)
        f.require_grid_space()
    _close(tr.data, jr.data)
    # The product itself, pointwise: ez x u with the (phi, theta, r) frame's sign
    e, u = ez[1]['g', DEALIAS].numpy(), tu['g', DEALIAS].numpy()
    _close(tr.data, -np.cross(e, u, axis=0), 1e-14)
    _close(_coeffs(tr), _coeffs(jr))


# --- the port on its own: eager against matrices, analytic cases ---

@pytest.fixture(scope='module')
def unit():
    import dedalus_tpu_torch.public as d3
    return _bases(d3, (8, 6, 10), (1, 2), device='cpu')


def _grid(side, vals, rank=0, name='f'):
    coords, dist, shell = side
    f = dist.Field(name=name, bases=shell, tensorsig=(coords,) * rank)
    f.change_scales(1)
    f['g'] = np.broadcast_to(vals, (3,) * rank + shell.shape).copy()
    return f


def test_subproblem_matrices_match_eager(unit):
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.core import subsystems
    coords, dist, shell = unit
    phi, theta, r = dist.local_grids(shell, scales=1)
    s = _grid(unit, r * np.sin(theta) * np.cos(phi) * (2 - r) + np.cos(theta) * r**3)
    s.require_coeff_space()
    u = d3.grad(s).evaluate()
    u.require_coeff_space()
    u.change_scales(1)
    Ro = shell.radii[1]
    exprs = ((d3.lap(s), s), (d3.div(d3.grad(u)), u), (d3.trace(d3.grad(u)), u),
             (d3.transpose(d3.grad(u)), u), (_stress(d3, u, Ro), u),
             (d3.radial(u(r=Ro)), u), (d3.integ(s), s))
    for E, var in exprs:
        coupled, sps = subsystems.enumerate_subproblems(
            dist, [E.domain, var.domain], np.array([False, True, True]))
        eager = _coeffs(E.evaluate()).numpy()
        xd = var.data.numpy()
        for sp in sps:
            mats = E.expression_matrices(sp, [var])
            sl = sp.group_slice(shell.azimuth_basis, 0)
            ref = eager[..., sl, :, :].ravel() if E.domain.bases[0] is not None else \
                (eager.ravel() if sp.group[0] == 0 else 0 * eager.ravel())
            got = mats[var] @ xd[..., sl, :, :].ravel()
            assert np.abs(got - ref).max() < 1e-12 * max(1, np.abs(ref).max())


def test_round_trip_laplacian_and_integral_are_analytic():
    """tests/test_ball.py::test_shell_roundtrip_and_lap on the port, and
    integ(1) = the shell's volume."""
    import dedalus_tpu_torch.public as d3
    side = _bases(d3, (8, 4, 16), (1, 2), device='cpu')
    coords, dist, shell = side
    phi, theta, r = dist.local_grids(shell, scales=1)
    x = r * np.sin(theta) * np.cos(phi)
    zc = r * np.cos(theta)
    fg = 1.0 + x * (2 - r) + zc**2
    f = _grid(side, fg)
    f.require_coeff_space()
    f.require_grid_space()
    assert np.abs(f.data.numpy() - np.broadcast_to(fg, shell.shape)).max() < 1e-13
    g = d3.lap(f).evaluate()
    g.change_scales(1)
    assert np.abs(g['g'].numpy() - (2.0 - 4 * x / r)).max() < 1e-8
    one = _grid(side, np.ones(shell.shape))
    v = float(d3.integ(one).evaluate()['g'].reshape(-1)[0])
    assert abs(v - shell.volume) < 1e-12 * shell.volume


def test_ncc_lbvp_with_two_walls_is_analytic():
    """tests/test_ball.py::test_shell_ncc_lbvp_two_bcs on the port: a scalar
    NCC on the left-hand side, two taus on the outer surface."""
    import dedalus_tpu_torch.public as d3
    Nr = 24
    coords, dist, shell = _bases(d3, (4, 2, Nr), (1, 2), device='cpu')
    f = dist.Field(name='f', bases=shell)
    tau1 = dist.Field(name='tau1', bases=shell.outer_surface)
    tau2 = dist.Field(name='tau2', bases=shell.outer_surface)
    lift = lambda A, i: d3.Lift(A, shell, i)
    phi, theta, r = dist.local_grids(shell, scales=1)
    fstar = (r - 1) * (2 - r)
    ncc = _grid((coords, dist, shell), 1 + r, name='ncc')
    g = _grid((coords, dist, shell), (-6 + 6 / r) + (1 + r) * fstar, name='g')
    problem = d3.LBVP([f, tau1, tau2], namespace=locals())
    problem.add_equation("lap(f) + ncc*f + lift(tau1, -1) + lift(tau2, -2) = g")
    problem.add_equation("f(r=1) = 0")
    problem.add_equation("f(r=2) = 0")
    problem.build_solver().solve()
    f.change_scales(1)
    assert np.abs(f['g'].numpy() - np.broadcast_to(fstar, shell.shape)).max() < 1e-13


def test_nonlinear_ivp_holds_its_wall():
    """tests/test_ball.py::test_shell_nonlinear_ivp on the port."""
    import dedalus_tpu_torch.public as d3
    coords, dist, shell = _bases(d3, (8, 4, 12), (1, 2), device='cpu')
    f = dist.Field(name='f', bases=shell)
    tau1 = dist.Field(name='tau1', bases=shell.outer_surface)
    tau2 = dist.Field(name='tau2', bases=shell.outer_surface)
    lift = lambda A, i: d3.Lift(A, shell, i)
    problem = d3.IVP([f, tau1, tau2], namespace=locals())
    problem.add_equation("dt(f) - lap(f) + lift(tau1, -1) + lift(tau2, -2) = - f*f")
    problem.add_equation("f(r=1) = 0")
    problem.add_equation("f(r=2) = 0")
    solver = problem.build_solver(d3.SBDF2)
    phi, theta, r = dist.local_grids(shell, scales=1)
    x = r * np.sin(theta) * np.cos(phi)
    f.change_scales(1)
    f['g'] = np.broadcast_to(0.1 * x * (r - 1) * (2 - r), shell.shape).copy()
    solver.run_steps(1e-3, 20)
    assert torch.isfinite(_coeffs(f)).all()
    b = f(r=1).evaluate()
    b.change_scales(1)
    assert b['g'].abs().max() < 1e-12


def test_shell_basis_rejects_other_coordinates():
    import dedalus_tpu_torch.public as d3
    with pytest.raises(ValueError):
        d3.ShellBasis(d3.PolarCoordinates('phi', 'r'), (8, 4, 10))
