"""The Rayleigh-Benard main path of the PyTorch port against dedalus_tpu:
the nonlinear RHS on the same state, and the banded SBDF2 trajectory at
32x16 (Ra=1e5, 20 steps) within the bound of tests/test_ivp.py:472."""

import numpy as np
import pytest
import torch

from dedalus_tpu.utils.config import config as jconfig
from dedalus_tpu_torch.utils.config import config as tconfig
from dedalus_tpu_torch.utils.interop import set_state_from_reference

NX, NZ, RA, DT = 32, 16, 1e5, 1e-3

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


def _jax_ic(ctx):
    b = ctx['b']
    z = ctx['dist'].local_grid(ctx['zbasis'], scale=1)
    Lz = ctx['Lz']
    b.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    b['g'] = np.array(b['g']) * z * (Lz - z) + (Lz - z)


@pytest.fixture(scope='module', autouse=True)
def reference_refinement_rule():
    """This module compares resolved refinement counts with dedalus_tpu's:
    read them with its rule ([linear algebra] refinement_rule)."""
    old = tconfig.get('linear algebra', 'refinement_rule')
    tconfig.set('linear algebra', 'refinement_rule', 'reference')
    yield
    tconfig.set('linear algebra', 'refinement_rule', old)


@pytest.fixture(scope='module')
def overrides():
    old = (jconfig.get('memory', 'max_dense_stack_gb'),
           jconfig.get('matrix assembly', 'sampled_min_groups'),
           tconfig.get('matrix assembly', 'sampled_min_groups'))
    jconfig.set('memory', 'max_dense_stack_gb', '0')
    jconfig.set('matrix assembly', 'sampled_min_groups', '8')
    tconfig.set('matrix assembly', 'sampled_min_groups', '8')
    yield
    jconfig.set('memory', 'max_dense_stack_gb', old[0])
    jconfig.set('matrix assembly', 'sampled_min_groups', old[1])
    tconfig.set('matrix assembly', 'sampled_min_groups', old[2])


def _build(overrides_unused=None):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    from dedalus_tpu_torch.models.rbc import initial_condition
    jp, jctx = jbuild(NX, NZ, Rayleigh=RA)
    js = jp.build_solver(jd3.SBDF2, matsolver='banded')
    _jax_ic(jctx)
    tp, tctx = tbuild(NX, NZ, Rayleigh=RA, device='cpu')
    ts = tp.build_solver(td3.SBDF2, matsolver='banded')
    initial_condition(tctx, seed=42)
    return js, ts


@pytest.fixture(scope='module')
def trajectories(overrides):
    js, ts = _build()
    X0_j = np.asarray(js.state_flat())
    X0_t = ts.state_flat().numpy()
    js.run_steps(DT, 20)
    ts.run_steps(DT, 20)
    return dict(js=js, ts=ts, X0=(X0_j, X0_t),
                X=(np.asarray(js.state_flat()), ts.state_flat().numpy()))


def test_initial_state_equal(trajectories):
    X0_j, X0_t = trajectories['X0']
    assert np.abs(X0_t - X0_j).max() <= 1e-15 * np.abs(X0_j).max()


def test_trajectory_matches_reference(trajectories):
    ref, got = trajectories['X']
    err = np.abs(ref - got).max()
    assert np.isfinite(got).all()
    assert err < 1e-11 * max(1, np.abs(ref).max()), err


def test_refinement_count_matches_reference(trajectories):
    js, ts = trajectories['js'], trajectories['ts']
    a, b, _ = ts.timestepper.compute_coefficients([DT, DT], 2)
    key = (float(a[0]), float(b[0]))
    jref = js.timestepper._factorized[key].banded.refinements
    assert ts.timestepper._factorized[key].banded.refinements == jref
    assert len(ts.timestepper._factorized) == len(js.timestepper._factorized) == 1


def test_solver_state_stays_on_cpu(trajectories):
    ts = trajectories['ts']
    for f in ts.state:
        assert f.data.device == torch.device('cpu')
    assert ts.iteration == 20
    assert abs(ts.sim_time - 20 * DT) < 1e-15


@pytest.mark.parametrize('perturb', [0.0, 1e-2])
def test_rhs_matches_reference_on_same_state(overrides, perturb):
    js, ts = _build()
    rng = np.random.default_rng(17)
    arrays = {}
    for f in js.state:
        f.require_coeff_space()
        f.change_scales(1)
        c = np.array(f.data)
        arrays[f.name] = c + perturb * rng.standard_normal(c.shape)
        f.preset_data(f.dist.coeff_layout, arrays[f.name])
    set_state_from_reference(ts, arrays)
    ref = np.asarray(js.traced_F(js.state_flat(), 0.0))
    got = ts.traced_F(ts.state_flat(), 0.0).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
