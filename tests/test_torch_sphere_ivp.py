"""The sphere shallow-water example on the PyTorch port against dedalus_tpu
at 32x16 (the size of tests/test_sphere.py::test_shallow_water_gating, its
hyperdiffusion matched at ell = 8), built by the same lines
(dedalus_tpu_torch.models.sphere) in both packages on the default dense
matsolver: the pencil layouts, validity masks and M, L stacks (equal), the
balanced-height LBVP (1e-11), F (1e-12), the 20-step RK222 trajectory at the
example's 600 s timestep (1e-11) and the conservation of mass.

The example's units make h ~1e-3 and u ~1e-2, so every field is held
relative to its own max |ref|, not to max(1, |ref|).
"""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.models import sphere as ms

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

SIZE = (32, 16)
STEPS = 20


def _build(d3, **kw):
    lbvp, ivp, ctx = ms.build_shallow_water(*SIZE, hyperdiffusion_ell=8, d3=d3, **kw)
    return lbvp.build_solver(), ivp, ctx


def _pair():
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jl, jivp, jctx = _build(jd3)
    tl, tivp, tctx = _build(td3, device='cpu')
    ms.balanced_initial_condition(jl, jctx)
    ms.balanced_initial_condition(tl, tctx)
    js, ts = jivp.build_solver(jd3.RK222), tivp.build_solver(td3.RK222)
    return dict(jl=jl, tl=tl, js=js, ts=ts, jctx=jctx, tctx=tctx)


@pytest.fixture(scope='module')
def built():
    return _pair()


def _rel(got, ref):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _mass(d3, h):
    return float(np.asarray(d3.integ(h).evaluate()['g']).ravel()[0])


@pytest.mark.parametrize('which', ['lbvp', 'ivp'])
def test_pencil_layouts_masks_and_stacks_equal(built, which):
    js, ts = (built['jl'], built['tl']) if which == 'lbvp' else (built['js'], built['ts'])
    jp, tp = js.pencil, ts.pencil
    assert ts.matsolver == js.matsolver == 'inverse_refined'
    assert (tp.G, tp.R, tp.C) == (jp.G, jp.R, jp.C)
    np.testing.assert_array_equal(tp.row_valid, jp.row_valid)
    np.testing.assert_array_equal(tp.col_valid, jp.col_valid)
    np.testing.assert_array_equal(tp.var_index_map, jp.var_index_map)
    for mt, mj in zip(tp.eq_index_maps, jp.eq_index_maps):
        np.testing.assert_array_equal(mt, mj)
    for name in ts.matrix_names:
        np.testing.assert_array_equal(tp.matrices[name].numpy(), np.asarray(jp.matrices[name]))
        assert np.abs(tp.matrices[name].numpy()).max() > 0


def test_validity_is_per_component(built):
    """Slot j of spin s holds ell = max(|m|, |s|) + j: in group m the scalar
    h keeps Lmax + 1 - m slots and the vector u Lmax + 1 - max(m, 1); the
    (m = 0, ell = 0) sine slot of h drops, and the gauge c lives in m = 0."""
    ts, tl = built['ts'], built['tl']
    n = SIZE[1]
    p = ts.pencil
    u_off, h_off = p.var_offsets[0], p.var_offsets[1]
    for m in (0, 1, 2, 7, p.G - 1):
        for comp in range(2):
            for pair in range(2):
                sl = slice(u_off + (2 * comp + pair) * n, u_off + (2 * comp + pair + 1) * n)
                assert p.col_valid[m, sl].sum() == n - max(m, 1)
        hcos = p.col_valid[m, h_off:h_off + n]
        hsin = p.col_valid[m, h_off + n:h_off + 2 * n]
        assert hcos.sum() == n - m
        assert hsin.sum() == (n - 1 if m == 0 else n - m)
    assert not p.col_valid[0, h_off + n]
    c_col = tl.pencil.var_offsets[1]
    assert tl.pencil.col_valid[0, c_col] and not tl.pencil.col_valid[1:, c_col].any()


def test_balanced_height_lbvp_matches_reference(built):
    jctx, tctx = built['jctx'], built['tctx']
    for f in (jctx['h'], tctx['h'], jctx['u'], tctx['u']):
        f.change_scales(1)
    assert _rel(tctx['u']['c'], jctx['u']['c']) <= 1e-14
    assert _rel(tctx['h']['c'], jctx['h']['c']) <= 1e-11
    hg = tctx['h']['g'].numpy()
    assert np.isfinite(hg).all() and 1e-6 < np.abs(hg).max() < 1e-2
    cj = float(np.asarray(jctx['c']['c']).ravel()[0])
    assert abs(float(tctx['c']['c'].ravel()[0]) - cj) <= 1e-11 * np.abs(hg).max()


def test_lbvp_solve_from_carried_fields_matches_reference():
    """The reference's jet carried into the port through utils.interop; the
    LBVP solved once and again after rebuilding its matrices."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu_torch.utils.interop import set_state_from_reference
    jl, _, jctx = _build(jd3)
    tl, _, tctx = _build(td3, device='cpu')
    ms.set_jet(jctx)
    set_state_from_reference(tl, {'u': np.asarray(jctx['u']['c'])}, fields=[tctx['u']])
    jl.solve()
    tl.solve()
    ref = {f.name: np.asarray(f['c']) for f in jl.state}
    assert _rel(tctx['h']['c'], ref['h']) <= 1e-11
    tl.solve(rebuild_matrices=True)
    assert _rel(tctx['h']['c'], ref['h']) <= 1e-11
    set_state_from_reference(tl, ref)
    np.testing.assert_array_equal(tl.state_flat().numpy(), np.asarray(jl.state_flat()))


def test_lbvp_F_matches_reference(built):
    ref = np.asarray(built['jl'].evaluate_F(schedule=False))
    got = built['tl'].evaluate_F().numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_traced_F_matches_reference(built):
    js, ts = built['js'], built['ts']
    ref = np.asarray(js.traced_F(js.state_flat(), 0.0))
    got = ts.traced_F(ts.state_flat(), 0.0).numpy()
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_products_go_through_the_plain_twin_on_the_cpu(built):
    from dedalus_tpu_torch.ops.products import grid_product
    ts = built['ts']
    ts.traced_F(ts.state_flat(), 0.0)
    assert grid_product.launches == 0


def test_trajectory_and_mass_match_reference():
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    b = _pair()
    js, ts, jctx, tctx = b['js'], b['ts'], b['jctx'], b['tctx']
    mass0 = _mass(td3, tctx['h'])
    assert abs(mass0 - _mass(jd3, jctx['h'])) <= 1e-11 * np.abs(np.asarray(jctx['h']['g'])).max()
    for _ in range(STEPS):
        js.step(ms.TIMESTEP)
        ts.step(ms.TIMESTEP)
    assert ts.iteration == js.iteration == STEPS
    assert abs(ts.sim_time - js.sim_time) <= 1e-15
    for name in ('u', 'h'):
        jctx[name].change_scales(1)
        tctx[name].change_scales(1)
        got = tctx[name]['c']
        assert torch.isfinite(got).all()
        assert _rel(got, jctx[name]['c']) <= 1e-11
    mass1 = _mass(td3, tctx['h'])
    assert abs(mass1 - mass0) < 1e-12 + 1e-8 * abs(mass0)


def test_run_steps_equals_stepping():
    """solver.run_steps (the timed loop of chip_smoke.py) and solver.step
    (the example's loop) give the same state up to rounding: step makes a
    grid round trip of the state at iteration 0 (enforce_real_cadence)."""
    import dedalus_tpu_torch.public as td3
    states = []
    for stepper in ('step', 'run_steps'):
        tl, tivp, tctx = _build(td3, device='cpu')
        ms.balanced_initial_condition(tl, tctx)
        ts = tivp.build_solver(td3.RK222)
        if stepper == 'step':
            for _ in range(5):
                ts.step(ms.TIMESTEP)
        else:
            ts.run_steps(ms.TIMESTEP, 5)
        states.append(ts.state_flat())
    assert float((states[0] - states[1]).abs().max()) <= 1e-12 * float(states[0].abs().max())


def test_lbvp_checks_its_equations_and_matsolver():
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu_torch.core.problems import UnsupportedEquationError
    _, _, ctx = _build(td3, device='cpu')
    h, c, u = ctx['h'], ctx['c'], ctx['u']
    problem = td3.LBVP([h, c], namespace=dict(h=h, c=c, u=u))
    with pytest.raises(UnsupportedEquationError):
        problem.add_equation("lap(h) + c = h*h")        # RHS depends on a variable
    with pytest.raises(UnsupportedEquationError):
        problem.add_equation("h*lap(h) + c = 0")        # LHS not linear
    problem.add_equation("lap(h) + c = div(u)")
    problem.add_equation("ave(h) = 0")
    # 'banded' factors only stacks past [memory] max_dense_stack_gb: a
    # dense-sized stack is refused at the solve, as the JAX package does
    solver = problem.build_solver(matsolver='banded')
    with pytest.raises(ValueError, match='banded'):
        solver.solve()


def test_sphere_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        _, _, ctx = ms.build_shallow_water(*SIZE)
        assert ctx['dist'].device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ms.build_shallow_water(*SIZE)
    _, _, ctx = ms.build_shallow_water(*SIZE, device='cpu')
    assert ctx['dist'].device.type == 'cpu'


def test_sphere_diffusion_ivp_decays_at_the_analytic_rate():
    """dt(u) = lap(u) on the unit sphere with SBDF2 (tests/test_sphere.py):
    an l = 2 harmonic decays at rate 6. The file handler of the example is
    left out of the port."""
    import dedalus_tpu_torch.public as td3
    coords = td3.S2Coordinates('phi', 'theta')
    dist = td3.Distributor(coords, dtype=np.float64, device='cpu')
    basis = td3.SphereBasis(coords, (24, 12), radius=1, dealias=1.5)
    phi, theta = basis.global_grids(scales=(1, 1))
    fg = np.sin(theta[None, :]) * np.cos(theta[None, :]) * np.cos(phi[:, None])
    u = dist.Field(name='u', bases=basis)
    problem = td3.IVP([u], namespace=locals())
    problem.add_equation("dt(u) - lap(u) = 0")
    solver = problem.build_solver(td3.SBDF2)
    with pytest.raises(NotImplementedError):
        solver.evaluator.add_file_handler('snapshots_sw', sim_dt=1)
    u['g'] = fg
    n, timestep = 200, 1e-4
    for _ in range(n):
        solver.step(timestep)
    u.change_scales(1)
    assert np.abs(u['g'].numpy() - np.exp(-6 * n * timestep) * fg).max() < 1e-6
