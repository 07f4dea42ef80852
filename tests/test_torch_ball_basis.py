"""The ball basis and operators of the PyTorch port against dedalus_tpu at
8x4x10 and 12x6x8, dealias 3/2, float64, on numpy-seeded data: the
per-(m, ell) Zernike stacks, the ell-aligned SWSH stacks and the
intertwiner stacks (1e-14: the same host arithmetic), the copy of the
intertwiner, scalar, vector and rank-2 transforms forward and backward and
their round trips, fields on the radial basis alone, grad, div, lap, the lift of surface fields,
interpolation at r=1 and integ, the analytic identities of
tests/test_ball.py, the subproblem matrices against eager evaluation, and
the plain twins of kernels KH, KI and the ball forms of KE and KF against
the JAX package's formulas. Tolerance 1e-12, relative to max(1, |ref|): the
reference's own tests allow 1e-10 to 1e-13 for transforms and operators."""

import numpy as np
import pytest
import torch

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

DEALIAS = 1.5
TOL = 1e-12


def _bases(d3, shape, **dkw):
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    ball = d3.BallBasis(coords, shape, radius=1.0, dealias=DEALIAS, dtype=np.float64)
    return coords, dist, ball


@pytest.fixture(scope='module', params=[(8, 4, 10), (12, 6, 8)], ids=['8x4x10', '12x6x8'])
def pair(request):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    return _bases(jd3, request.param), _bases(td3, request.param, device='cpu')


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
    for side in pair:
        coords, dist, ball = side
        f = dist.Field(name=name, bases=bases(ball) if bases else ball,
                       tensorsig=(coords,) * rank)
        out.append(f)
    jf, tf = out
    if layout == 'g':
        jf.change_scales(DEALIAS)
        tf.change_scales(DEALIAS)
        shape = tuple(jf.required_shape(pair[0][1].grid_layout, jf.scales))
        data = np.random.default_rng(seed).standard_normal(shape)
        jf.preset_data(pair[0][1].grid_layout, jnp.asarray(data))
        tf.preset_data(pair[1][1].grid_layout, data)
    else:
        shape = tuple(jf.required_shape(pair[0][1].coeff_layout, jf.scales))
        data = np.random.default_rng(seed).standard_normal(shape)
        jf.preset_data(pair[0][1].coeff_layout, jnp.asarray(data))
        tf.preset_data(pair[1][1].coeff_layout, data)
    return jf, tf


# --- host stacks and the intertwiner ---

def _per_slot(stack, KM, L):
    """The port's per-ell stack in the reference's per-(m, j) layout: entry
    (m, j) is the matrix of ell = m + j, zero where ell >= L."""
    out = np.zeros((KM + 1, L) + stack.shape[1:])
    for m in range(KM + 1):
        out[m, :L - m] = stack[m:L]
    return out


@pytest.mark.parametrize('reg', [-2, -1, 0, 1, 2])
@pytest.mark.parametrize('direction', ['f', 'b'])
def test_radial_stacks_match_reference(pair, reg, direction):
    jb, tb = pair[0][2].radial_basis, pair[1][2].radial_basis
    KM, L = (pair[1][2].azimuth_basis.size - 1) // 2, pair[1][2].colatitude_basis.size
    assert tb._transform_stacks(1, reg, direction).shape[0] == L
    for scale in (1, DEALIAS):
        _close(_per_slot(tb._transform_stacks(scale, reg, direction), KM, L),
               jb._transform_stacks(scale, reg, direction), 1e-14)
    for k in (1, 2):
        jk, tk = jb.derivative_basis(k), tb.derivative_basis(k)
        _close(_per_slot(tk._transform_stacks(1, reg, direction), KM, L),
               jk._transform_stacks(1, reg, direction), 1e-14)


@pytest.mark.parametrize('spin', [-2, -1, 0, 1, 2])
def test_ell_aligned_colatitude_stacks_match_reference(pair, spin):
    jc, tc = pair[0][2].colatitude_basis, pair[1][2].colatitude_basis
    assert tc._ell_aligned
    for scale in (1, DEALIAS):
        for direction in ('f', 'b'):
            _close(tc._transform_stacks(scale, spin, direction),
                   jc._transform_stacks(scale, spin, direction), 1e-14)
    M = pair[1][2].azimuth_basis.size
    for m in range((M - 1) // 2 + 1):
        for rank_sig in ((), (0,), (1,), (2,)):
            ts = (pair[1][0],) * len(rank_sig)
            js = (pair[0][0],) * len(rank_sig)
            assert np.array_equal(tc.component_valid_for_m(m, ts, rank_sig),
                                  jc.component_valid_for_m(m, js, rank_sig))


def test_intertwiner_copy_matches_reference(pair):
    from dedalus_tpu.spectral import intertwiner as jit_
    from dedalus_tpu_torch.spectral import intertwiner as tit
    for rank in (1, 2):
        for ell in range(7):
            assert np.array_equal(tit.Q_matrix(ell, rank), jit_.Q_matrix(ell, rank))
        for idx in np.ndindex(*(3,) * rank):
            assert tit.regtotal(idx) == jit_.regtotal(idx)
            for ell in range(4):
                assert tit.regularity_allowed(ell, idx) == jit_.regularity_allowed(ell, idx)
        _close(pair[1][2].radial_basis._Q_stack_host(rank),
               pair[0][2].radial_basis._Q_stack_host(rank), 0.0)


def test_grids_and_weights_match_reference(pair):
    for scale in (1, DEALIAS):
        for jb, tb in zip(pair[0][2].sub_bases, pair[1][2].sub_bases):
            _close(tb.global_grid(scale), jb.global_grid(scale), 1e-15)
        _close(pair[1][2].radial_basis.global_weights(scale),
               pair[0][2].radial_basis.global_weights(scale), 1e-15)


# --- transforms ---

@pytest.mark.parametrize('rank', [0, 1, 2])
@pytest.mark.parametrize('direction', ['forward', 'backward'])
def test_transforms_match_reference(pair, rank, direction):
    if direction == 'forward':
        jf, tf = _fields(pair, rank, 10 + rank, 'g')
        jf.require_coeff_space()
        tf.require_coeff_space()
    else:
        jf, tf = _fields(pair, rank, 20 + rank, 'c')
        jf.change_scales(DEALIAS)
        tf.change_scales(DEALIAS)
        jf.require_grid_space()
        tf.require_grid_space()
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


@pytest.mark.parametrize('rank', [0, 1])
def test_radial_only_fields_match_reference(pair, rank):
    """Fields on the radial basis alone (constant along the angles): their
    content sits in the (m = 0, ell = 0) entry of the per-(m, ell) stacks."""
    jf, tf = _fields(pair, rank, 35 + rank, 'g', bases=lambda ball: ball.radial_basis)
    jf.require_coeff_space()
    tf.require_coeff_space()
    _close(tf.data, jf.data)
    jf.require_grid_space()
    tf.require_grid_space()
    _close(tf.data, jf.data)


# --- operators ---

def _surface(ball):
    return ball.surface


OPERATORS = {
    'lap_scalar': (0, lambda d3, f: d3.lap(f)),
    'grad_scalar': (0, lambda d3, f: d3.grad(f)),
    'interp_scalar': (0, lambda d3, f: f(r=1)),
    'integ_scalar': (0, lambda d3, f: d3.integ(f)),
    'lap_vector': (1, lambda d3, f: d3.lap(f)),
    'grad_vector': (1, lambda d3, f: d3.grad(f)),
    'div_vector': (1, lambda d3, f: d3.div(f)),
    'interp_vector': (1, lambda d3, f: f(r=1)),
    'div_tensor': (2, lambda d3, f: d3.div(f)),
    'div_grad_vector': (1, lambda d3, f: d3.div(d3.grad(f))),
}


@pytest.mark.parametrize('name', sorted(OPERATORS))
def test_operators_match_reference(pair, name):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    rank, op = OPERATORS[name]
    jf, tf = _fields(pair, rank, 40 + len(name), 'g')
    jr, tr = op(jd3, jf).evaluate(), op(td3, tf).evaluate()
    for f in (jr, tr):
        f.require_coeff_space()
        f.change_scales(1)
    _close(tr.data, jr.data)


@pytest.mark.parametrize('rank', [0, 1])
def test_lift_of_surface_fields_matches_reference(pair, rank):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jf, tf = _fields(pair, rank, 50 + rank, 'c', bases=_surface, name='tau')
    jr = jd3.Lift(jf, pair[0][2], -1).evaluate()
    tr = td3.Lift(tf, pair[1][2], -1).evaluate()
    for f in (jr, tr):
        f.require_coeff_space()
    _close(tr.data, jr.data)


def test_constants_match_reference(pair):
    """A constant added to a ball field (grid space) and a constant embedded
    into the ball basis (BallConstantEmbed, the tau_p column)."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.core.operators_ball import BallConstantEmbed as JEmbed
    from dedalus_tpu_torch.core.operators_ball import BallConstantEmbed as TEmbed
    jc, tc = pair[0][1].Field(name='c'), pair[1][1].Field(name='c')
    jc['g'] = 0.7
    tc['g'] = 0.7
    jf, tf = _fields(pair, 0, 60, 'g')
    jr, tr = (jf + jc).evaluate(), (tf + tc).evaluate()
    for f in (jr, tr):
        f.require_coeff_space()
        f.change_scales(1)
    _close(tr.data, jr.data)
    je = JEmbed(jc, pair[0][2].radial_basis).evaluate()
    te = TEmbed(tc, pair[1][2].radial_basis).evaluate()
    _close(te.data, je.data)


@pytest.fixture(scope='module')
def unit():
    import dedalus_tpu_torch.public as d3
    return _bases(d3, (8, 6, 10), device='cpu')


def _grid(side, vals):
    coords, dist, ball = side
    f = dist.Field(name='f', bases=ball)
    f.change_scales(1)
    f['g'] = np.broadcast_to(vals, ball.shape).copy()
    return f


def test_gradient_and_laplacian_are_analytic(unit):
    import dedalus_tpu_torch.public as d3
    coords, dist, ball = unit
    phi, theta, r = dist.local_grids(ball, scales=1)
    x = r * np.sin(theta) * np.cos(phi)
    y = r * np.sin(theta) * np.sin(phi)
    zc = r * np.cos(theta)
    f = _grid(unit, x * (1 - r**2) + zc**2)
    Fx, Fy, Fz = (1 - r**2) - 2 * x**2, -2 * x * y, 2 * zc - 2 * x * zc
    exp = (-np.sin(phi) * Fx + np.cos(phi) * Fy,
           np.cos(theta) * np.cos(phi) * Fx + np.cos(theta) * np.sin(phi) * Fy
           - np.sin(theta) * Fz,
           np.sin(theta) * np.cos(phi) * Fx + np.sin(theta) * np.sin(phi) * Fy
           + np.cos(theta) * Fz)
    g = d3.grad(f).evaluate()
    g.change_scales(1)
    gd = g['g'].numpy()
    for i in range(3):
        assert np.abs(gd[i] - np.broadcast_to(exp[i], ball.shape)).max() < 1e-10
    lap = d3.lap(f).evaluate()
    lap.change_scales(1)
    assert np.abs(lap['g'].numpy() - (2.0 - 10.0 * x)).max() < 1e-8
    dg = d3.div(d3.grad(f)).evaluate()
    dg.change_scales(1)
    assert np.abs(dg['g'].numpy() - (2.0 - 10.0 * x)).max() < 1e-8


def test_interpolation_and_integral_are_analytic(unit):
    import dedalus_tpu_torch.public as d3
    coords, dist, ball = unit
    phi, theta, r = dist.local_grids(ball, scales=1)
    zc = r * np.cos(theta)
    f = _grid(unit, 1 - r**2 + zc)
    h = f(r=1).evaluate()
    h.change_scales(1)
    exp = np.cos(theta)[:, :, 0]
    assert np.abs(h['g'].numpy()[:, :, 0] - np.broadcast_to(exp, ball.shape[:2])).max() < 1e-12
    v = float(d3.integ(f).evaluate()['g'].reshape(-1)[0])
    assert abs(v - 8 * np.pi / 15) < 1e-12


def test_subproblem_matrices_match_eager(unit):
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.core import subsystems
    coords, dist, ball = unit
    phi, theta, r = dist.local_grids(ball, scales=1)
    s = _grid(unit, r * np.sin(theta) * np.cos(phi) * (1 - r**2) + np.cos(theta) * r**3)
    s.require_coeff_space()
    u = d3.grad(s).evaluate()
    u.require_coeff_space()
    u.change_scales(1)
    for E, var in ((d3.div(d3.grad(s)), s), (d3.lap(u), u), (d3.div(u), u), (d3.grad(s), s)):
        coupled, sps = subsystems.enumerate_subproblems(
            dist, [E.domain, var.domain], np.array([False, True, True]))
        res = E.evaluate()
        res.require_coeff_space()
        res.change_scales(1)
        eager = res.data.numpy()
        xd = var.data.numpy()
        for sp in sps:
            mats = E.expression_matrices(sp, [var])
            sl = sp.group_slice(ball.azimuth_basis, 0)
            ref = eager[..., sl, :, :].ravel()
            got = mats[var] @ xd[..., sl, :, :].ravel()
            assert np.abs(got - ref).max() < 1e-12 * max(1, np.abs(ref).max())


def test_ball_basis_rejects_other_coordinates():
    import dedalus_tpu_torch.public as d3
    polar = d3.PolarCoordinates('phi', 'r')
    with pytest.raises(ValueError):
        d3.BallBasis(polar, (8, 4, 10))


# --- the kernels' plain twins against the JAX package's formulas ---

@pytest.mark.parametrize('E', [3, 5, 9])
def test_kh_plain_twin_matches_reference_einsum(E):
    """KH's per-ell stack (E matrices: fewer than, as many as and more than
    the slots' ells) against the reference's per-(m, j) einsum."""
    from dedalus_tpu_torch.ops.ball import ball_radial_apply
    rng = np.random.default_rng(70)
    K, NP, L, N, O, C = 4, 2, 5, 7, 9, 3
    S = rng.standard_normal((E, O, N))
    x = rng.standard_normal((C, K, NP, L, N))
    base = rng.standard_normal((C, K, NP, L, O))
    Sm = np.zeros((K, L, O, N))
    for k in range(K):
        for j in range(L):
            if k + j < E:
                Sm[k, j] = S[k + j]
    out = torch.as_tensor(base.copy())
    ball_radial_apply(torch.as_tensor(S), torch.as_tensor(x), [(0, 1), (2, 0)], out,
                      accumulate=True)
    ref = base.copy()
    ref[1] += np.einsum('mlon,mpln->mplo', Sm, x[0])
    ref[0] += np.einsum('mlon,mpln->mplo', Sm, x[2])
    _close(out, ref, 1e-14)
    out = torch.as_tensor(base.copy())
    ball_radial_apply(torch.as_tensor(S), torch.as_tensor(x), [(1, 2)], out)
    _close(out[2], np.einsum('mlon,mpln->mplo', Sm, x[1]), 1e-14)
    with pytest.raises(ValueError):
        ball_radial_apply(torch.as_tensor(S), torch.as_tensor(x), [(0, 1), (2, 1)], out)


@pytest.mark.parametrize('C', [3, 9])
@pytest.mark.parametrize('forward', [True, False])
def test_ki_plain_twin_matches_reference_einsum(C, forward):
    from dedalus_tpu_torch.csrc.regularity_recombine import regularity_recombine
    rng = np.random.default_rng(71 + C)
    K, NP, L, N = 4, 2, 5, 7
    Q = rng.standard_normal((K, L, C, C))
    x = rng.standard_normal((C, K, NP, L, N))
    got = regularity_recombine(torch.as_tensor(x), torch.as_tensor(Q), forward)
    d = x.reshape(C, K, NP, L, N)
    eq = 'mlba,bmpln->ampln' if forward else 'mlab,bmpln->ampln'
    _close(got, np.einsum(eq, Q, d), 1e-14)


def test_ke_trailing_plain_twin_matches_reference_einsum():
    from dedalus_tpu_torch.ops.polar import trailing_apply
    rng = np.random.default_rng(72)
    K, O, I, T = 4, 9, 6, 5
    S = rng.standard_normal((K, O, I))
    x = rng.standard_normal((1, 2 * K, I, T))
    got = trailing_apply(torch.as_tensor(S), torch.as_tensor(x),
                         torch.empty((1, 2 * K, O, T), dtype=torch.float64), [0])
    ref = np.einsum('mon,mp...n->mp...o', S,
                    np.moveaxis(x[0].reshape(K, 2, I, T), 2, -1)).reshape(K, 2, T, O)
    _close(got[0], np.moveaxis(ref, -1, 2).reshape(2 * K, O, T), 1e-14)


@pytest.mark.parametrize('accumulate', [False, True])
def test_ke_trailing_grouped_components_match_one_by_one(accumulate):
    """The components of one spin in one call (the form the ball's
    colatitude transforms use) against one call per component."""
    from dedalus_tpu_torch.ops.polar import trailing_apply
    rng = np.random.default_rng(74)
    K, O, I, T, C = 4, 9, 6, 5, 5
    S = torch.as_tensor(rng.standard_normal((K, O, I)))
    x = torch.as_tensor(rng.standard_normal((C, 2 * K, I, T)))
    base = torch.as_tensor(rng.standard_normal((C, 2 * K, O, T)))
    comps = [0, 2, 3]
    got = trailing_apply(S, x, base.clone(), comps, accumulate=accumulate)
    ref = base.clone()
    for c in comps:
        trailing_apply(S, x, ref, [c], accumulate=accumulate)
    _close(got, ref.numpy(), 0.0)


@pytest.mark.parametrize('forward', [True, False])
def test_kf_spherical_rank_matches_reference(forward):
    """KF's twin on a spherical rank (4x4 angular W, the radial component
    passing through) against the JAX package's 6x6 recombination."""
    import jax.numpy as jnp
    import dedalus_tpu.public as jd3
    from dedalus_tpu.core.basis_polar import spin_recombine as jax_spin_recombine
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu_torch.core.basis_polar import spin_recombine
    jcs = jd3.SphericalCoordinates('phi', 'theta', 'r')
    tcs = td3.SphericalCoordinates('phi', 'theta', 'r')
    x = np.random.default_rng(73).standard_normal((3, 3, 8, 6, 5))
    for rank_sig in ((jcs,), (jcs, jcs)):
        data = x if len(rank_sig) == 2 else x[0]
        nt = len(rank_sig)
        ref = jax_spin_recombine(jcs, rank_sig, jnp.asarray(data), nt, forward, True)
        got = spin_recombine(tcs, (tcs,) * nt, torch.as_tensor(data), nt, forward)
        _close(got, ref, 1e-15)
