"""The ball convection model on the PyTorch port against dedalus_tpu at
8x4x10 (the size of tests/test_ball.py::test_ball_convection_gating), built
by each package's build_ball_problem on the default dense matsolver with
SBDF2: the slot-split pencil layouts, validity masks and M, L stacks
(equal), the initial condition, F (1e-12), the 20-step trajectory at
dt=2e-3 (1e-11 max(1, |ref|)) and the wall and divergence residuals
(1e-14, as the reference's test).

Also the two repairs of this slice's ROADMAP queue: the plateau rule of the
banded refinement count against the reference's rule (synthetic curves, and
a banded RBC trajectory at the count the new rule reads off its own probe),
and the eviction of Runge-Kutta stage factorizations (bit for bit against
keeping every one)."""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.utils.config import config as tconfig
from dedalus_tpu_torch.utils.interop import set_state_from_reference

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

SIZE = (8, 4, 10)
DT, STEPS = 2e-3, 20


def _build(side, scheme='SBDF2'):
    if side == 'jax':
        import dedalus_tpu.public as d3
        from dedalus_tpu.models import ball as mb
        problem, ctx = mb.build_ball_problem(*SIZE)
    else:
        import dedalus_tpu_torch.public as d3
        from dedalus_tpu_torch.models import ball as mb
        problem, ctx = mb.build_ball_problem(*SIZE, device='cpu')
    solver = problem.build_solver(getattr(d3, scheme))
    mb.set_conductive_ic(ctx, seed=42)
    return solver, ctx


@pytest.fixture(scope='module')
def built():
    js, jctx = _build('jax')
    ts, tctx = _build('torch')
    T0 = (np.asarray(jctx['T']['c']).copy(), tctx['T']['c'].numpy().copy())
    # Both packages start from the same numpy arrays
    set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
    return dict(js=js, ts=ts, jctx=jctx, tctx=tctx, T0=T0)


@pytest.fixture(scope='module')
def stepped(built):
    js, ts = built['js'], built['ts']
    F = (np.asarray(js.traced_F(js.state_flat(), 0.0)), ts.traced_F(ts.state_flat(), 0.0))
    js.run_steps(DT, STEPS)
    ts.run_steps(DT, STEPS)
    return dict(built, F=F)


def test_default_matsolver_and_slot_split(built):
    ts = built['ts']
    assert ts.matsolver == 'inverse_refined'
    # 4 azimuthal groups x 4 ell slots; p, u, T (10 radial modes, 2 pair
    # slots), tau_p, tau_u, tau_T per slot
    assert ts.pencil.slot_split == (4, 4)
    assert (ts.pencil.G, ts.pencil.R) == (16, 2 * 10 * 5 + 1 + 3 * 2 + 2)


def test_pencil_layouts_masks_and_stacks_equal(built):
    jp, tp = built['js'].pencil, built['ts'].pencil
    assert (tp.G, tp.R, tp.C) == (jp.G, jp.R, jp.C)
    assert np.array_equal(tp.var_index_map, np.asarray(jp.var_index_map))
    assert np.array_equal(tp.col_valid, np.asarray(jp.col_valid))
    assert np.array_equal(tp.row_valid, np.asarray(jp.row_valid))
    for a, b in zip(tp.eq_index_maps, jp.eq_index_maps):
        assert np.array_equal(a, np.asarray(b))
    for name in ('M', 'L'):
        assert np.array_equal(tp.matrices[name].numpy(), np.asarray(jp.matrices[name]))


def test_initial_condition_matches_reference(built):
    ref, got = built['T0']
    assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()


def test_traced_F_matches_reference(stepped):
    ref, got = stepped['F']
    got = got.numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * max(1, np.abs(ref).max())


@pytest.mark.parametrize('name', ['p', 'u', 'T', 'tau_p', 'tau_u', 'tau_T'])
def test_trajectory_matches_reference(stepped, name):
    jf = next(f for f in stepped['js'].state if f.name == name)
    tf = next(f for f in stepped['ts'].state if f.name == name)
    ref, got = np.asarray(jf['c']), tf['c'].numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-11 * max(1, np.abs(ref).max())
    assert stepped['ts'].iteration == stepped['js'].iteration == STEPS


@pytest.mark.parametrize('which', ['wall', 'divergence'])
def test_wall_and_divergence_residuals(stepped, which):
    import dedalus_tpu_torch.public as d3
    u = stepped['tctx']['u']
    res = (u(r=1) if which == 'wall' else d3.div(u)).evaluate()
    res.require_coeff_space()
    assert float(res.data.abs().max()) < 1e-14


def test_entry_point_defaults_to_the_card():
    from dedalus_tpu_torch.models.ball import build_ball_problem
    if torch.cuda.is_available():
        problem, ctx = build_ball_problem(*SIZE)
        assert ctx['dist'].device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_ball_problem(*SIZE)


# --- F1: the refinement count read off the probed residual curve ---

CURVES = {
    # still falling at the last pass: the minimum is the level
    'falling': ([1e-3, 1e-6, 1e-9, 1e-12, 1e-15, 1e-16, 5e-17, 3e-17, 2e-17], 4, 4),
    # a clean plateau from pass 3
    'plateau': ([1e-3, 1e-6, 1e-9, 2e-11, 1.8e-11, 2.2e-11, 1.9e-11, 2.1e-11, 2.0e-11], 3, 3),
    # the 2048x2048 shape: 1.4e-11 to 4.8e-11 from pass 3, an outlier low
    # last entry (3.9e-12)
    'outlier': ([2.1e-3, 1.9e-6, 1.7e-9, 3.3e-11, 4.8e-11, 1.4e-11, 2.6e-11, 3.0e-11, 3.9e-12],
                3, 8),
    # the inner probes of RBC 2048x2048 and 2048x512 on an H100 (K5's f32
    # sweeps, the default matsolver's banded path)
    'rbc2048x2048': ([2.9617163518322385, 2.0646387896718162e-06, 1.063360426060864e-09,
                      3.7617767107894226e-11, 1.4038507220956117e-11, 2.752469082238937e-11,
                      2.7467788089902803e-11, 4.7714042533197866e-11, 3.945067355942425e-12],
                     3, 8),
    # a pass that stalls before the curve falls on to its floor
    'early_stall': ([1e-3, 9e-4, 1e-6, 1e-9, 1e-12, 1e-15, 2e-16, 2e-16, 2e-16], 5, 5),
    'rbc2048x512': ([0.06865595848482156, 4.488271909854831e-08, 2.1045275794936922e-11,
                     2.774974298608843e-11, 1.446748247348333e-11, 1.517940042336137e-11,
                     1.6871093172732098e-11, 1.5025673287570337e-11, 1.4189161780335722e-11],
                    2, 2),
}


@pytest.mark.parametrize('name', sorted(CURVES))
def test_refinement_rules_on_probe_curves(name):
    from dedalus_tpu_torch.ops.banded import refinements_from_curve
    curve, plateau, reference = CURVES[name]
    assert refinements_from_curve(curve, 1e-15, rule='plateau') == plateau
    assert refinements_from_curve(curve, 1e-15, rule='reference') == reference
    assert tconfig.get('linear algebra', 'refinement_rule') == 'plateau'
    assert refinements_from_curve(curve, 1e-15) == plateau
    # Targets above the plateau: both rules stop where the target is met
    for target in (1e-10, 1e-7):
        assert (refinements_from_curve(curve, target, rule='plateau')
                == refinements_from_curve(curve, target, rule='reference'))


def test_plateau_rule_banded_trajectory_matches_reference():
    """RBC 32x16 on the banded matsolver, the port's main factorization at
    the count the plateau rule reads off its own inner probe: the last
    solve's residual and the 20-step trajectory against the reference."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    from dedalus_tpu_torch.ops.banded import refinements_from_curve
    from dedalus_tpu.utils.config import config as jconfig
    nx, nz, dt = 32, 16, 1e-3
    old = (jconfig.get('memory', 'max_dense_stack_gb'),
           jconfig.get('matrix assembly', 'sampled_min_groups'),
           tconfig.get('matrix assembly', 'sampled_min_groups'))
    jconfig.set('memory', 'max_dense_stack_gb', '0')
    jconfig.set('matrix assembly', 'sampled_min_groups', '8')
    tconfig.set('matrix assembly', 'sampled_min_groups', '8')
    try:
        jp, jctx = jbuild(nx, nz, Rayleigh=1e5)
        js = jp.build_solver(jd3.SBDF2, matsolver='banded')
        tp, tctx = tbuild(nx, nz, Rayleigh=1e5, device='cpu')
        ts = tp.build_solver(td3.SBDF2, matsolver='banded')
        jctx['b'].fill_random('g', seed=42, distribution='normal', scale=1e-3)
        set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
        js.run_steps(dt, 1)
        ts.run_steps(dt, 1)
        a, b, _ = ts.timestepper.compute_coefficients([dt, dt], 2)
        fact = ts.timestepper._prepare(float(a[0]), float(b[0]))
        bb = fact.banded
        refs = refinements_from_curve(bb._probe_refinement_curve(), 1e-15)
        bb.refinements = refs
        ts.timestepper._banded_refs_floor = refs
        R = torch.as_tensor(np.random.default_rng(8).standard_normal((bb.blocks.G, bb.P)))
        R = R * ts.pencil.row_valid_dev
        X = bb.solve(R)
        resid = float((bb.exact_apply(X) - R).abs().max() / R.abs().max())
        assert resid <= 1e-9, resid
        js.run_steps(dt, 19)
        ts.run_steps(dt, 19)
    finally:
        jconfig.set('memory', 'max_dense_stack_gb', old[0])
        jconfig.set('matrix assembly', 'sampled_min_groups', old[1])
        tconfig.set('matrix assembly', 'sampled_min_groups', old[2])
    ref, got = np.asarray(js.state_flat()), ts.state_flat().numpy()
    assert np.abs(got - ref).max() < 1e-11 * max(1, np.abs(ref).max())


# --- F2: Runge-Kutta stage factorizations are evicted ---

def test_rk_stage_factorizations_evicted_bit_for_bit():
    """The ball on RK222 through five step sizes (two of them revisited):
    with [linear algebra] max_cached_factorizations = 1 the trajectory
    equals the run that keeps every factorization, bit for bit, and one
    factorization is kept instead of five."""
    dts = [1e-3, 2e-3, 1e-3, 3e-3, 1.5e-3, 2e-3, 2.5e-3]
    old = tconfig.get('linear algebra', 'max_cached_factorizations')
    states, kept = {}, {}
    try:
        for limit in ('1', '100'):
            tconfig.set('linear algebra', 'max_cached_factorizations', limit)
            solver, _ = _build('torch', scheme='RK222')
            for dt in dts:
                solver.step(dt)
            states[limit] = solver.state_flat()
            kept[limit] = len(solver.timestepper._stage_factors)
    finally:
        tconfig.set('linear algebra', 'max_cached_factorizations', old)
    assert torch.equal(states['1'], states['100'])
    assert torch.isfinite(states['1']).all()
    assert (kept['1'], kept['100']) == (1, len(set(dts)))
