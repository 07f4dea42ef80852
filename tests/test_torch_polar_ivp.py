"""The polar examples on the PyTorch port against dedalus_tpu: the annulus
convection example (32x16, RK222) and the disk libration example (16x32,
SBDF2), both on the default dense matsolver, built by the same lines
(dedalus_tpu_torch.models.polar) in both packages: the pencil stacks and
validity masks, the sampled assembly of the annulus at its own 64x32, F,
a 20-step trajectory within the RBC gate (1e-11 * max(1, |ref|),
tests/test_ivp.py:472) and the disk's analysis tasks.

The annulus example's m=0 pencil is singular in the reference itself
(condition ~1e16 at 32x16): its null vector carries p and the velocity
taus of m=0, which both packages fill with rounding amplified by the
inverse. Those entries are held after projecting out the null vector, at
the bound its conditioning allows (1e-5); every other entry is held to the
gate.
"""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.models import polar as mp

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

CASES = {
    'annulus': dict(size=(32, 16), scheme='RK222', dt=2e-3,
                    build=mp.build_annulus_problem, ic=mp.annulus_initial_condition),
    'disk': dict(size=(16, 32), scheme='SBDF2', dt=1e-3,
                 build=mp.build_disk_problem, ic=mp.disk_initial_condition),
}
STEPS = 20


def _solvers(geometry, size=None):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    case = CASES[geometry]
    size = size or case['size']
    jp, jctx = case['build'](*size, d3=jd3)
    tp, tctx = case['build'](*size, device='cpu')
    js = jp.build_solver(getattr(jd3, case['scheme']))
    ts = tp.build_solver(getattr(td3, case['scheme']))
    case['ic'](jctx)
    case['ic'](tctx)
    return js, ts, jctx, tctx


@pytest.fixture(scope='module', params=sorted(CASES))
def built(request):
    return (request.param,) + _solvers(request.param)


def _null_vector(pencil, dt):
    """Unit null vector of the m=0 pencil (None when it is regular)."""
    M, L = (pencil.matrices[k][0].numpy() for k in ('M', 'L'))
    A = M + dt * L
    rows, cols = pencil.pivot_pairs[0]
    A[rows, cols] = 1
    _, S, Vt = np.linalg.svd(A)
    return Vt[-1] if S[-1] < 1e-12 * S[0] else None


def _assert_states_close(pencil, got, ref, dt, tol, undetermined_tol):
    """Compare flat states in pencil form; entries in the support of the
    m=0 null vector are compared after projecting it out."""
    scale = max(1.0, np.abs(ref).max())
    D = pencil.gather_state(torch.as_tensor(got - ref)).numpy()
    v = _null_vector(pencil, dt)
    if v is not None:
        support = np.abs(v) > 1e-6 * np.abs(v).max()
        d0 = D[0] - (v @ D[0]) * v
        assert np.abs(d0[support]).max() <= undetermined_tol * scale
        D[0, support] = 0
    assert np.abs(D).max() <= tol * scale, np.abs(D).max()
    return v


def test_pencil_stacks_and_masks_equal(built):
    geometry, js, ts, _, _ = built
    jp, tp = js.pencil, ts.pencil
    assert ts.matsolver == js.matsolver == 'inverse_refined'
    assert (tp.G, tp.R, tp.C) == (jp.G, jp.R, jp.C)
    np.testing.assert_array_equal(tp.row_valid, jp.row_valid)
    np.testing.assert_array_equal(tp.col_valid, jp.col_valid)
    np.testing.assert_array_equal(tp.var_index_map, jp.var_index_map)
    for mt, mj in zip(tp.eq_index_maps, jp.eq_index_maps):
        np.testing.assert_array_equal(mt, mj)
    for name in ('M', 'L'):
        np.testing.assert_array_equal(tp.matrices[name].numpy(), np.asarray(jp.matrices[name]))


def test_radial_validity_per_group(built):
    """The disk keeps n < n_size(m) radial modes of group m, the annulus all."""
    geometry, js, ts, _, _ = built
    pencil = ts.pencil
    basis = ts.state[0].domain.bases[1]
    off = pencil.var_offsets[0]
    for g in (0, 1, pencil.G - 1):
        # the cos slot of p in group g
        cos = pencil.col_valid[g, off:off + basis.size]
        assert cos.sum() == (basis.n_size(g) if geometry == 'disk' else basis.size)


def test_traced_F_matches_reference(built):
    geometry, js, ts, _, _ = built
    ref = np.asarray(js.traced_F(js.state_flat(), 0.3))
    got = ts.traced_F(ts.state_flat(), 0.3).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize('geometry', sorted(CASES))
def test_trajectory_matches_reference(geometry):
    js, ts, jctx, tctx = _solvers(geometry)
    dt = CASES[geometry]['dt']
    js.run_steps(dt, STEPS)
    ts.run_steps(dt, STEPS)
    ref = np.asarray(js.state_flat())
    got = ts.state_flat().numpy()
    assert np.isfinite(got).all()
    v = _assert_states_close(ts.pencil, got, ref, dt, 1e-11, 1e-5)
    assert (v is not None) == (geometry == 'annulus')
    assert ts.iteration == js.iteration == STEPS
    assert abs(ts.sim_time - js.sim_time) <= 1e-15
    if geometry == 'disk':
        # The example's analysis: the KE task through the dictionary handler
        import dedalus_tpu.public as jd3
        import dedalus_tpu_torch.public as td3
        jke = jd3.integ(0.5 * jctx['u'] @ jctx['u']).evaluate()
        tke = td3.integ(0.5 * tctx['u'] @ tctx['u']).evaluate()
        kref = np.asarray(jke['g']).ravel()[0]
        assert abs(float(tke['g'].ravel()[0]) - kref) <= 1e-12 * max(1.0, abs(kref))


@pytest.mark.parametrize('geometry', sorted(CASES))
def test_analysis_handlers_match_reference(geometry):
    """The examples' analysis on both packages: the disk's KE task through
    the dictionary handler (sim_dt=0.01, as the example's file handler) and
    each example's GlobalFlowProperty of u@u, fired on the same schedule
    over 12 steps."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    js, ts, jctx, tctx = _solvers(geometry)
    out = {}
    for d3, solver, ctx in ((jd3, js, jctx), (td3, ts, tctx)):
        u = ctx['u']
        scalars = solver.evaluator.add_dictionary_handler(sim_dt=0.01)
        scalars.add_task(d3.integ(0.5 * u @ u), name='KE')
        flow = d3.GlobalFlowProperty(solver, cadence=5)
        flow.add_property(u @ u, name='u2')
        solver.run_steps(CASES[geometry]['dt'], 12)
        out[d3] = (float(flow.max('u2')), float(np.asarray(scalars['KE']['g']).ravel()[0]))
    (ju2, jke), (tu2, tke) = out[jd3], out[td3]
    assert ju2 > 0 and jke > 0
    # Scaled as the trajectory gate: the annulus velocity is ~1e-5 of T
    assert abs(tu2 - ju2) <= 1e-12 * max(1.0, ju2)
    assert abs(tke - jke) <= 1e-12 * max(1.0, jke)


def test_k3_plain_twins_match_generic_map_bit_for_bit(built):
    """K3's plain twins on the polar pencils (the disk's triangular
    truncation masks modes per group) against the generic index map."""
    from dedalus_tpu_torch.core import subsystems as tsub
    geometry, _, ts, _, _ = built
    p = ts.pencil
    rng = np.random.default_rng(6)
    flat = torch.as_tensor(rng.standard_normal(p.state_total))
    col_valid = torch.as_tensor(p.col_valid.astype(np.float64))
    generic = flat[torch.as_tensor(p.var_index_map.astype(np.int64))] * col_valid
    assert torch.equal(tsub.pencil_gather_plain(p.state_gather.to('cpu'), [flat]), generic)
    X = torch.as_tensor(rng.standard_normal((p.G, p.C))) * col_valid
    ref = torch.zeros(p.state_total, dtype=X.dtype).index_add_(
        0, torch.as_tensor(p.var_index_map.astype(np.int64)).reshape(-1), X.reshape(-1))
    assert torch.equal(tsub.pencil_scatter_plain(p.state_scatter.to('cpu'), X), ref)
    datas = [torch.as_tensor(rng.standard_normal(n)) for n in p.eq_gather.src_sizes]
    cols = [d[torch.as_tensor(m.astype(np.int64))] for d, m in zip(datas, p.eq_index_maps)]
    assert torch.equal(p.gather_eq_data(datas), torch.cat(cols, dim=1) * torch.as_tensor(p.row_valid.astype(np.float64)))
    # The scatter's CSR lists each target's sources in flat-position order
    offsets, entries = p.state_scatter.offsets.numpy(), p.state_scatter.entries.numpy()
    assert offsets[-1] == p.G * p.C
    for t in range(0, p.state_total, max(1, p.state_total // 50)):
        srcs = entries[offsets[t]:offsets[t + 1]]
        assert (np.diff(srcs) > 0).all()
        assert (p.var_index_map.reshape(-1)[srcs] == t).all()


def test_state_carries_across_as_a_copy(built):
    """The polar coefficient layout (components..., M, N) is the same array
    in both packages: the reference's coefficients set through
    utils.interop give the port the same flat state and the same F."""
    from dedalus_tpu_torch.utils.interop import set_state_from_reference
    geometry, js, ts, _, _ = built
    rng = np.random.default_rng(8)
    arrays = {}
    for jf, tf in zip(js.state, ts.state):
        assert tuple(tf['c'].shape) == np.asarray(jf['c']).shape
        jf['c'] = rng.standard_normal(np.asarray(jf['c']).shape)
        arrays[jf.name] = np.asarray(jf['c'])
    set_state_from_reference(ts, arrays)
    np.testing.assert_array_equal(ts.state_flat().numpy(), np.asarray(js.state_flat()))
    ref = np.asarray(js.traced_F(js.state_flat(), 0.1))
    got = ts.traced_F(ts.state_flat(), 0.1).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


def test_annulus_sampled_assembly_picks_reference_groups():
    """At the example's 64x32 (G=32) both packages fit the M and L stacks
    from the same 10 sampled groups, m=0 exceptional."""
    js, ts, _, _ = _solvers('annulus', size=(64, 32))
    jsep, tsep = js.pencil.separable, ts.pencil.separable
    assert jsep is not None and tsep is not None
    for name in ('M', 'L'):
        assert tsep[name].degree == jsep[name].degree
        assert sorted(tsep[name].bad) == sorted(jsep[name].bad) == [0]
        np.testing.assert_array_equal(tsep[name].ghat, jsep[name].ghat)
        for Bt, Bj in zip(tsep[name].B, jsep[name].B):
            np.testing.assert_array_equal(Bt.toarray(), Bj.toarray())
    assert [tsep[n].degree for n in ('M', 'L')] == [1, 2]


def test_polar_distributor_defaults_to_the_card():
    import dedalus_tpu_torch.public as td3
    coords = td3.PolarCoordinates('phi', 'r')
    if torch.cuda.is_available():
        assert td3.Distributor(coords).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            td3.Distributor(coords)
    assert td3.Distributor(coords, device='cpu').device.type == 'cpu'
