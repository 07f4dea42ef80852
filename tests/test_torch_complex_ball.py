"""The ball convection model in complex128 on the PyTorch port against
dedalus_tpu at 8x4x10 (the size of tests/test_torch_ball_ivp.py), built by
each package's build_ball_problem with dtype=complex128 on the default
dense matsolver with SBDF2: the per-(m, ell) slot split of complex pencils
(16 pencils of P = 109, the JAX package's), the validity masks with the
dead -0 slot, the M and L stacks (equal), the initial condition (complex
noise, drawn alike), F (1e-12), the 20-step trajectory at dt=2e-3 (1e-10
of each field's own max) and the wall and divergence residuals (1e-14, as
the real form's test). Then the ball's internally heated convection
example (models/ball.py build_ball_ihc_problem, the example's lines with
dtype = complex128) at the same size: the curl of seeded complex vector
fields (1e-13; on complex data the curl takes KH's rotation form as the
product by i), F on the carried-over state (1e-12), the 5-step trajectory
at the example's dt (1e-10 of each field's own max, the gauge tau_p
absolutely below 1e-20) and its radial(u(r=1)), div(u) and shear stress
(1e-12). ComplexWarning is an error here."""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.utils.interop import set_state_from_reference

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings('error::numpy.exceptions.ComplexWarning')

SIZE = (8, 4, 10)
DT, STEPS = 2e-3, 20


def _build(side):
    if side == 'jax':
        import dedalus_tpu.public as d3
        from dedalus_tpu.models import ball as mb
        problem, ctx = mb.build_ball_problem(*SIZE, dtype=np.complex128)
    else:
        import dedalus_tpu_torch.public as d3
        from dedalus_tpu_torch.models import ball as mb
        problem, ctx = mb.build_ball_problem(*SIZE, dtype=np.complex128, device='cpu')
    solver = problem.build_solver(d3.SBDF2)
    mb.set_conductive_ic(ctx, seed=42)
    return solver, ctx


@pytest.fixture(scope='module')
def stepped():
    js, jctx = _build('jax')
    ts, tctx = _build('torch')
    T0 = (np.asarray(jctx['T']['c']).copy(), tctx['T']['c'].numpy().copy())
    set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
    F = (np.asarray(js.traced_F(js.state_flat(), 0.0)), ts.traced_F(ts.state_flat(), 0.0))
    js.run_steps(DT, STEPS)
    ts.run_steps(DT, STEPS)
    return dict(js=js, ts=ts, jctx=jctx, tctx=tctx, T0=T0, F=F)


def test_slot_split_masks_and_stacks(stepped):
    jp, tp = stepped['js'].pencil, stepped['ts'].pencil
    assert tp.slot_split == jp.slot_split == (4, 4)
    assert (tp.G, tp.R, tp.C) == (jp.G, jp.R, jp.C) == (16, 109, 109)
    assert np.array_equal(tp.col_valid, np.asarray(jp.col_valid))
    assert np.array_equal(tp.row_valid, np.asarray(jp.row_valid))
    # the dead -0 slot: no valid column in the m = 0 pencils' second slot
    assert tp.col_valid[:4].sum() < tp.col_valid[4:8].sum()
    for name in ('M', 'L'):
        got, ref = tp.matrices[name].numpy(), np.asarray(jp.matrices[name])
        assert got.dtype == np.complex128
        assert np.array_equal(got, ref)


def test_initial_condition_and_F(stepped):
    ref, got = stepped['T0']
    assert np.abs(ref.imag).max() > 0
    assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()
    jF, tF = stepped['F']
    assert np.abs(tF.numpy() - jF).max() <= 1e-12 * max(1, np.abs(jF).max())


@pytest.mark.parametrize('name', ['p', 'u', 'T', 'tau_p', 'tau_u', 'tau_T'])
def test_trajectory_matches_reference(stepped, name):
    jf = next(f for f in stepped['js'].state if f.name == name)
    tf = next(f for f in stepped['ts'].state if f.name == name)
    ref, got = np.asarray(jf['c']), tf['c'].numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-10 * max(np.abs(ref).max(), 1e-20)


@pytest.mark.parametrize('which', ['wall', 'divergence'])
def test_wall_and_divergence_residuals(stepped, which):
    import dedalus_tpu_torch.public as d3
    u = stepped['tctx']['u']
    res = (u(r=1) if which == 'wall' else d3.div(u)).evaluate()
    res.require_coeff_space()
    assert float(res.data.abs().max()) < 1e-14


# --- the internally heated convection example in complex128 ---

IHC_STEPS = 5
# tau_p is the gauge tau: zero up to round-off, held absolutely below this
GAUGE_FLOOR = 1e-20


def _ihc(side):
    from dedalus_tpu_torch.models import ball as mb
    if side == 'jax':
        import dedalus_tpu.public as d3
        problem, ctx = mb.build_ball_ihc_problem(*SIZE, dtype=np.complex128, d3=d3)
    else:
        import dedalus_tpu_torch.public as d3
        problem, ctx = mb.build_ball_ihc_problem(*SIZE, dtype=np.complex128, device='cpu')
    solver = problem.build_solver(d3.SBDF2)
    mb.set_ihc_ic(ctx)
    return solver, ctx


@pytest.fixture(scope='module')
def ihc():
    from dedalus_tpu_torch.models import ball as mb
    js, jctx = _ihc('jax')
    ts, tctx = _ihc('torch')
    # Both go on from the same numpy arrays: the state in coefficient
    # layout, r_vec as the grid data it was set from
    jctx['r_vec'].change_scales(1)
    set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
    set_state_from_reference(ts, {'r_vec': np.asarray(jctx['r_vec']['g'])},
                             fields=[tctx['r_vec']], layout='g')
    F = (np.asarray(js.traced_F(js.state_flat(), 0.0)), ts.traced_F(ts.state_flat(), 0.0))
    js.run_steps(mb.IHC_TIMESTEP, IHC_STEPS)
    ts.run_steps(mb.IHC_TIMESTEP, IHC_STEPS)
    return dict(js=js, ts=ts, jctx=jctx, tctx=tctx, F=F)


@pytest.mark.parametrize('layout', ['g', 'c'])
def test_ihc_complex_curl_matches_reference(layout):
    """curl(v) of the same seeded complex vector data, in grid or
    coefficient layout, in both packages."""
    import jax.numpy as jnp
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    fields = []
    for d3, kw in ((jd3, {}), (td3, dict(device='cpu'))):
        coords = d3.SphericalCoordinates('phi', 'theta', 'r')
        dist = d3.Distributor(coords, dtype=np.complex128, **kw)
        ball = d3.BallBasis(coords, SIZE, radius=1.0, dealias=1.5, dtype=np.complex128)
        f = dist.VectorField(coords, name='v', bases=ball)
        if layout == 'g':
            f.change_scales(1.5)
        fields.append((d3, dist, f))
    lays = [dist.grid_layout if layout == 'g' else dist.coeff_layout for _, dist, _ in fields]
    shape = tuple(fields[0][2].required_shape(lays[0], fields[0][2].scales))
    rng = np.random.default_rng(90)
    data = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    fields[0][2].preset_data(lays[0], jnp.asarray(data))
    fields[1][2].preset_data(lays[1], data)
    jr, tr = (d3.curl(f).evaluate() for d3, _, f in fields)
    for f in (jr, tr):
        f.require_coeff_space()
        f.change_scales(1)
    ref, got = np.asarray(jr.data), tr.data.numpy()
    assert got.dtype == np.complex128 and np.abs(ref.imag).max() > 0.1
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


def test_ihc_F_matches_reference(ihc):
    jF, tF = ihc['F']
    assert np.abs(tF.numpy() - jF).max() <= 1e-12 * max(1, np.abs(jF).max())


@pytest.mark.parametrize('name', ['p', 'u', 'T', 'tau_p', 'tau_u', 'tau_T'])
def test_ihc_trajectory_matches_reference(ihc, name):
    jf = next(f for f in ihc['js'].state if f.name == name)
    tf = next(f for f in ihc['ts'].state if f.name == name)
    ref, got = np.asarray(jf['c']), tf['c'].numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max()
    if np.abs(ref).max() < GAUGE_FLOOR:
        assert err < GAUGE_FLOOR
    else:
        assert err <= 1e-10 * np.abs(ref).max()


def test_ihc_residuals(ihc):
    from dedalus_tpu_torch.models import ball as mb
    assert max(mb.ihc_residuals(ihc['tctx'])) < 1e-12
