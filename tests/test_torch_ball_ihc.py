"""The ball's internally heated convection example
(examples/ivp_ball_internally_heated_convection.py) on the PyTorch port
against dedalus_tpu, built by models/ball.py's build_ball_ihc_problem from
the same lines in each package: the curl (SphericalCurl) of seeded vector
and rank-2 fields at 16x8x8 (1e-13 relative), the curl identities of
tests/test_ball.py::test_spherical_curl_identities at its bounds, the
curl's pencil matrices at every m (1e-13) and against the eager curl, the
plain twin of KH's pair-rotation form against the JAX package's einsum on
the rotated pair (1e-14), the ball tensor NCC r_vec*T against the eager
product (tests/test_spherical_ncc.py::test_ball_vector_ncc_times_scalar's
analogue, 1e-12) and against the JAX package's pencil matrices at every
(m, ell) (1e-13); then the example at 16x8x12 with SBDF2 at its dt = 2e-3:
the slot split (64 pencils of P = 129, as the JAX package logs), F on the
carried-over state (1e-12), the 5-step trajectory (1e-10 relative to each
field's own max), the walls, divergence and shear stress (1e-12) and the
wall flux (equal to the JAX package's). A complex radial matrix cast to a
real stack would drop the curl without an error: ComplexWarning fails here.
"""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.models import ball as mb
from dedalus_tpu_torch.utils.interop import set_state_from_reference

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings('error::numpy.exceptions.ComplexWarning')

SIZE = (16, 8, 12)
CURL_SIZE = (16, 8, 8)
STEPS = 5
# tau_p is the gauge tau: zero up to round-off, where a relative error means
# nothing; below this floor its error is held absolutely
GAUGE_FLOOR = 1e-20


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (err, np.abs(ref).max())


def _ball(d3, shape, dealias=1.5, **dkw):
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    ball = d3.BallBasis(coords, shape, radius=1.0, dealias=dealias, dtype=np.float64)
    return coords, dist, ball


@pytest.fixture(scope='module')
def curl_pair():
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    return _ball(jd3, CURL_SIZE), _ball(td3, CURL_SIZE, device='cpu')


def _seeded(pair, rank, seed, layout):
    """The same numpy-seeded data in a rank-`rank` field of each package."""
    import jax.numpy as jnp
    out = []
    for (coords, dist, ball) in pair:
        f = dist.Field(name='v', bases=ball, tensorsig=(coords,) * rank)
        if layout == 'g':
            f.change_scales(1.5)
        out.append(f)
    jf, tf = out
    lay = pair[0][1].grid_layout if layout == 'g' else pair[0][1].coeff_layout
    data = np.random.default_rng(seed).standard_normal(tuple(jf.required_shape(lay, jf.scales)))
    jf.preset_data(lay, jnp.asarray(data))
    tf.preset_data(pair[1][1].grid_layout if layout == 'g' else pair[1][1].coeff_layout, data)
    return jf, tf


# --- the curl ---

@pytest.mark.parametrize('rank,layout', [(1, 'g'), (1, 'c'), (2, 'g')])
def test_curl_matches_reference(curl_pair, rank, layout):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jf, tf = _seeded(curl_pair, rank, 80 + rank, layout)
    jr, tr = jd3.curl(jf).evaluate(), td3.curl(tf).evaluate()
    for f in (jr, tr):
        f.require_coeff_space()
        f.change_scales(1)
    assert np.abs(np.asarray(jr.data)).max() > 0.1
    _close(tr.data, jr.data, 1e-13)


def test_curl_identities():
    """curl(grad f) = 0, div(curl v) = 0 and curl(Omega ez x r) = 2 Omega ez
    on the port, at the reference test's size and bounds."""
    import dedalus_tpu_torch.public as d3
    coords, dist, ball = _ball(d3, CURL_SIZE, dealias=1, device='cpu')
    f = dist.Field(name='f', bases=ball)
    phi, theta, r = dist.local_grids(ball, scales=1)
    x = r * np.sin(theta) * np.cos(phi)
    z = r * np.cos(theta)
    f.change_scales(1)
    f['g'] = x * (x + z) + 0.3 * z**2
    cg = d3.curl(d3.grad(f)).evaluate()
    cg.require_coeff_space()
    assert cg.data.abs().max() < 1e-14
    dc = d3.div(d3.curl(d3.grad(f) + 2 * d3.grad(f * f))).evaluate()
    dc.require_coeff_space()
    assert dc.data.abs().max() < 1e-14
    Omega = 1.3
    urot = dist.VectorField(coords, name='urot', bases=ball)
    urot.change_scales(1)
    shape = np.broadcast_shapes(phi.shape, theta.shape, r.shape)
    data = np.zeros((3,) + shape)
    data[0] = Omega * r * np.sin(theta)
    urot['g'] = data
    w = d3.curl(urot).evaluate()
    w.change_scales(1)
    w.require_grid_space()
    exp = np.zeros((3,) + shape)
    exp[1] = np.broadcast_to(-2 * Omega * np.sin(theta), shape)
    exp[2] = np.broadcast_to(2 * Omega * np.cos(theta), shape)
    assert np.abs(w.data.numpy() - exp).max() < 1e-12


def test_curl_pencil_matrices_match_reference_and_eager(curl_pair):
    """The curl's subproblem matrix at every m equals the JAX package's, and
    applied to the field's coefficients equals the eager curl."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.core import subsystems as jsub
    from dedalus_tpu_torch.core import subsystems as tsub
    jf, tf = _seeded(curl_pair, 1, 85, 'g')
    for f in (jf, tf):
        f.require_coeff_space()
        f.change_scales(1)
    jE, tE = jd3.curl(jf), td3.curl(tf)
    coupling = np.array([False, True, True])
    _, jsps = jsub.enumerate_subproblems(curl_pair[0][1], [jE.domain, jf.domain], coupling)
    _, tsps = tsub.enumerate_subproblems(curl_pair[1][1], [tE.domain, tf.domain], coupling)
    assert len(jsps) == len(tsps) == CURL_SIZE[0] // 2
    eager = tE.evaluate()
    eager.require_coeff_space()
    eager.change_scales(1)
    ball = curl_pair[1][2]
    for jsp, tsp in zip(jsps, tsps):
        jm = jE.expression_matrices(jsp, [jf])[jf].toarray()
        tm = tE.expression_matrices(tsp, [tf])[tf].toarray()
        _close(tm, jm, 1e-13)
        sl = tsp.group_slice(ball.azimuth_basis, 0)
        ref = eager.data.numpy()[:, sl].ravel()
        _close(tm @ tf.data.numpy()[:, sl].ravel(), ref, 1e-12)


# --- KH's pair-rotation form against the reference's einsum on rot ---

@pytest.mark.parametrize('NP', [2, 1])
@pytest.mark.parametrize('accumulate', [False, True])
def test_kh_rotation_plain_twin_matches_reference_einsum(NP, accumulate):
    """Four terms with their own stacks, two sharing an output component
    (the curl's pattern), against the JAX package's per-(m, j) einsum on the
    rotated pair (core/operators_ball.py:214-227), which drops the
    imaginary part where the azimuth has one slot."""
    import jax.numpy as jnp
    from dedalus_tpu_torch.ops.ball import ball_radial_apply_rot
    rng = np.random.default_rng(75 + NP)
    K, L, N, O, C, E = 4, 5, 7, 9, 3, 6
    stacks = [rng.standard_normal((E, O, N)) for _ in range(4)]
    x = rng.standard_normal((C, K, NP, L, N))
    base = rng.standard_normal((C, K, NP, L, O))
    terms = [(0, 2), (1, 2), (2, 0), (2, 1)]
    ref = base.copy() if accumulate else np.zeros_like(base)
    for S, (ci, co) in zip(stacks, terms):
        Sm = np.zeros((K, L, O, N))
        for k in range(K):
            for j in range(L):
                if k + j < E:
                    Sm[k, j] = S[k + j]
        if NP == 2:
            dm = jnp.asarray(x[ci])
            rot = jnp.stack([-dm[:, 1], dm[:, 0]], axis=1)
            ref[co] += np.asarray(jnp.einsum('mlon,mpln->mplo', jnp.asarray(Sm), rot))
    out = torch.as_tensor(base.copy())
    ball_radial_apply_rot([(torch.as_tensor(S), ci, co) for S, (ci, co) in zip(stacks, terms)],
                          torch.as_tensor(x), out, accumulate=accumulate)
    _close(out, ref, 1e-14)
    with pytest.raises(ValueError):
        ball_radial_apply_rot([(torch.as_tensor(stacks[0]), 0, 0)] * 5, torch.as_tensor(x), out)


# --- the ball's tensor NCC r_vec*T ---

@pytest.mark.parametrize('triangular', [True, False])
def test_ball_vector_ncc_times_scalar(triangular):
    """r_vec * s on the ball (r_vec on the radial basis alone): the
    envelope-shifted Zernike products per (ell, regularity) against the
    eager grid product, as tests/test_spherical_ncc.py's reference test."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.core import subsystems
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, device='cpu')
    ball = d3.BallBasis(coords, (8, 6, 10), radius=1.0, dtype=np.float64,
                        dealias=(1.5, 1.5, 1.5), triangular=triangular)
    phi, theta, r = dist.local_grids(ball, scales=1)
    rvec = dist.VectorField(coords, name='rvec', bases=ball.radial_basis)
    rvec.change_scales(1)
    g = np.zeros(tuple(rvec['g'].shape))
    g[2] = r
    rvec['g'] = g
    s = dist.Field(name='s', bases=ball)
    x = r * np.sin(theta) * np.cos(phi)
    z = r * np.cos(theta)
    s.change_scales(1)
    s['g'] = np.broadcast_to(x * (1 - r**2) + 0.3 * z**2 + 0.1, ball.shape).copy()
    s.require_coeff_space()
    E = rvec * s
    ev = E.evaluate()
    ev.require_coeff_space()
    ev.change_scales(1)
    eager = ev.data.numpy()
    _, sps = subsystems.enumerate_subproblems(dist, [E.domain, s.domain],
                                              np.array([False, True, True]))
    for sp in sps:
        sl = sp.group_slice(ball.azimuth_basis, 0)
        got = E.expression_matrices(sp, [s])[s] @ s.data.numpy()[sl].ravel()
        assert np.abs(got - eager[:, sl].ravel()).max() < 1e-12


@pytest.mark.parametrize('ncc', ['profile', 'constant'])
def test_ball_scalar_ncc_times_vector_matches_reference(ncc):
    """A scalar NCC times a ball vector (each component's block in its
    regularity-shifted Zernike family; a constant NCC's block is its value
    times the conversion to the output's k) against the JAX package's
    matrices."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.core import subsystems as jsub
    from dedalus_tpu_torch.core import subsystems as tsub
    sides = []
    for d3, kw in ((jd3, {}), (td3, dict(device='cpu'))):
        coords, dist, ball = _ball(d3, (8, 6, 10), **kw)
        phi, theta, r = dist.local_grids(ball, scales=1)
        if ncc == 'profile':
            w = dist.Field(name='w', bases=ball.radial_basis)
            w.change_scales(1)
            w['g'] = 1 + 0.5 * r**2 + 0.1 * r**4
        else:
            w = dist.Field(name='w')
            w['g'] = 0.7
        u = dist.VectorField(coords, name='u', bases=ball)
        E = w * d3.lap(u) if ncc == 'constant' else w * u
        _, sps = (jsub if d3 is jd3 else tsub).enumerate_subproblems(
            dist, [E.domain, u.domain], np.array([False, True, True]))
        sides.append([E.expression_matrices(sp, [u])[u].toarray() for sp in sps])
        assert sides[-1][0].shape[0] == 3 * 2 * 6 * 10
    for jm, tm in zip(*sides):
        assert np.abs(jm).max() > 0
        _close(tm, jm, 1e-13)


# --- the example at 16x8x12 ---

def _build(side):
    if side == 'jax':
        import dedalus_tpu.public as d3
        problem, ctx = mb.build_ball_ihc_problem(*SIZE, d3=d3)
    else:
        import dedalus_tpu_torch.public as d3
        problem, ctx = mb.build_ball_ihc_problem(*SIZE, device='cpu')
    solver = problem.build_solver(d3.SBDF2)
    mb.set_ihc_ic(ctx)
    # The example's property, evaluated at the last of the steps run here
    flow = mb.add_ihc_flow_property(solver, ctx, cadence=STEPS)
    return solver, ctx, flow


@pytest.fixture(scope='module')
def built():
    js, jctx, jflow = _build('jax')
    ts, tctx, tflow = _build('torch')
    T0 = (np.asarray(jctx['T']['c']).copy(), tctx['T']['c'].numpy().copy())
    # Both packages go on from the same numpy arrays: the state (the surface
    # taus included) in coefficient layout, r_vec as the grid data it was
    # set from
    jctx['r_vec'].change_scales(1)
    set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
    set_state_from_reference(ts, {'r_vec': np.asarray(jctx['r_vec']['g'])},
                             fields=[tctx['r_vec']], layout='g')
    return dict(js=js, ts=ts, jctx=jctx, tctx=tctx, jflow=jflow, tflow=tflow, T0=T0)


@pytest.fixture(scope='module')
def stepped(built):
    js, ts = built['js'], built['ts']
    F = (np.asarray(js.traced_F(js.state_flat(), 0.0)), ts.traced_F(ts.state_flat(), 0.0))
    js.run_steps(mb.IHC_TIMESTEP, STEPS)
    ts.run_steps(mb.IHC_TIMESTEP, STEPS)
    return dict(built, F=F)


def test_default_matsolver_and_slot_split(built):
    """8 azimuthal groups x 8 ell slots; per slot p, T (12 radial modes, 2
    pair slots), u (3 components), tau_p, tau_T and tau_u: P = 129."""
    for solver in (built['ts'], built['js']):
        assert solver.pencil.slot_split == (8, 8)
        assert (solver.pencil.G, solver.pencil.R) == (64, 2 * 12 * 5 + 1 + 2 + 2 * 3)
    assert built['ts'].matsolver == 'inverse_refined'


def test_pencil_layouts_masks_and_stacks_equal(built):
    jp, tp = built['js'].pencil, built['ts'].pencil
    assert (tp.G, tp.R, tp.C) == (jp.G, jp.R, jp.C)
    assert np.array_equal(tp.var_index_map, np.asarray(jp.var_index_map))
    assert np.array_equal(tp.col_valid, np.asarray(jp.col_valid))
    assert np.array_equal(tp.row_valid, np.asarray(jp.row_valid))
    for name in ('M', 'L'):
        got, ref = tp.matrices[name].numpy(), np.asarray(jp.matrices[name])
        assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()


def test_rvec_T_pencil_matrices_match_reference(built):
    """The left-hand side's r_vec*T at every (m, ell) pencil: the blocks of
    each azimuthal group's matrix, one per ell slot, equal the JAX
    package's."""
    from dedalus_tpu.core import subsystems as jsub
    from dedalus_tpu_torch.core import subsystems as tsub
    mats = []
    for ctx, sub in ((built['jctx'], jsub), (built['tctx'], tsub)):
        E = ctx['r_vec'] * ctx['T']
        _, sps = sub.enumerate_subproblems(ctx['dist'], [E.domain, ctx['T'].domain],
                                           np.array([False, True, True]))
        mats.append([E.expression_matrices(sp, [ctx['T']])[ctx['T']].toarray() for sp in sps])
    assert len(mats[0]) == len(mats[1]) == SIZE[0] // 2
    for jm, tm in zip(*mats):
        assert jm.shape == tm.shape == (3 * 2 * SIZE[1] * SIZE[2], 2 * SIZE[1] * SIZE[2])
        _close(tm, jm, 1e-13)


def test_initial_condition_and_F_match(stepped):
    jT0, tT0 = stepped['T0']
    assert np.abs(tT0 - jT0).max() <= 1e-15 * np.abs(jT0).max()
    jF, tF = stepped['F']
    assert np.abs(jF).max() > 0
    assert np.abs(tF.numpy() - jF).max() <= 1e-12 * np.abs(jF).max()


def test_trajectory_matches_reference(stepped):
    for jf, tf in zip(stepped['js'].state, stepped['ts'].state):
        ref = np.asarray(jf['c'])
        got = tf['c'].numpy()
        assert np.isfinite(got).all()
        scale = np.abs(ref).max()
        err = np.abs(got - ref).max()
        if scale > GAUGE_FLOOR:
            assert err <= 1e-10 * scale, (tf.name, err, scale)
        else:
            assert err <= 1e-10 * GAUGE_FLOOR, (tf.name, err)


def test_walls_divergence_and_shear_stress(stepped):
    """radial(u(r=1)), div(u) and the shear stress in coefficient space
    after 5 steps: 1e-12 on the port, as in the JAX package."""
    got = mb.ihc_residuals(stepped['tctx'])
    ref = mb.ihc_residuals(stepped['jctx'])
    assert max(got) <= 1e-12 and max(ref) <= 1e-12, (got, ref)


def test_wall_flux_matches_reference(stepped):
    """radial(grad(T)(r=1)) holds -2 in its ell = 0 coefficient (the grid
    value is -2 Y00 = -1.414: a constant on the surface lands in the
    coefficient unnormalized, in the JAX package too)."""
    got, ref = mb.ihc_wall_flux(stepped['tctx']), mb.ihc_wall_flux(stepped['jctx'])
    _close(got, ref, 1e-12)
    nz = ref[np.abs(ref) > 1e-12]
    assert nz.size == 1 and abs(nz[0] + 2) < 1e-12


def test_flow_property_matches_reference(stepped):
    ref, got = stepped['jflow'].max('u2'), stepped['tflow'].max('u2')
    assert 0 < ref and abs(got - ref) <= 1e-10 * ref


def test_build_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError):
        mb.build_ball_ihc_problem(*SIZE)
