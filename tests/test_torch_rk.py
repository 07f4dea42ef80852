"""The Runge-Kutta schemes and dense SBDF2 of the PyTorch port against
dedalus_tpu: RBC 32x16, Ra=1e5, dt=1e-3, 20 steps on the default dense
matsolver (inverse_refined), within the bound of tests/test_ivp.py:472;
and kernel KC's plain twin against the reference's stage combine."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

NX, NZ, RA, DT, STEPS = 32, 16, 1e5, 1e-3, 20

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


def _jax_ic(ctx):
    b = ctx['b']
    z = ctx['dist'].local_grid(ctx['zbasis'], scale=1)
    Lz = ctx['Lz']
    b.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    b['g'] = np.array(b['g']) * z * (Lz - z) + (Lz - z)


def _build(scheme):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    from dedalus_tpu_torch.models.rbc import initial_condition
    jp, jctx = jbuild(NX, NZ, Rayleigh=RA)
    js = jp.build_solver(getattr(jd3, scheme))
    _jax_ic(jctx)
    tp, tctx = tbuild(NX, NZ, Rayleigh=RA, device='cpu')
    ts = tp.build_solver(getattr(td3, scheme))
    initial_condition(tctx, seed=42)
    return js, ts


@pytest.mark.parametrize('scheme', ['RK111', 'RK222', 'RK443', 'SBDF2'])
def test_dense_trajectory_matches_reference(scheme):
    js, ts = _build(scheme)
    assert ts.matsolver == js.matsolver == 'inverse_refined'
    js.run_steps(DT, STEPS)
    ts.run_steps(DT, STEPS)
    ref = np.asarray(js.state_flat())
    got = ts.state_flat().numpy()
    assert np.isfinite(got).all()
    err = np.abs(ref - got).max()
    assert err < 1e-11 * max(1, np.abs(ref).max()), err
    assert ts.iteration == js.iteration == STEPS
    assert abs(ts.sim_time - js.sim_time) <= 1e-15


def test_rk_step_then_run_steps_matches_reference():
    """Single steps and a run of steps take the same path (and share the
    stage factorization of one dt)."""
    js, ts = _build('RK222')
    for s in (js, ts):
        s.step(DT)
        s.step(DT)
        s.run_steps(DT, 3)
    ref = np.asarray(js.state_flat())
    got = ts.state_flat().numpy()
    assert np.abs(ref - got).max() < 1e-11 * max(1, np.abs(ref).max())
    assert ts.iteration == js.iteration == 5
    assert len(ts.timestepper._stage_factors) == len(js.timestepper._stage_factors) == 1


@pytest.mark.parametrize('n', [1, 2, 3, 4])
def test_kc_plain_matches_reference_combine(n):
    from dedalus_tpu_torch.csrc.rk_combine import rk_stage_combine
    rng = np.random.default_rng(n)
    G, R = 8, 37
    MX0 = rng.standard_normal((G, R))
    F = rng.standard_normal((n, G, R))
    LX = rng.standard_normal((n, G, R))
    rv = (rng.random((G, R)) > 0.2).astype(np.float64)
    k = 1e-3
    Arow = rng.standard_normal(n)
    Hrow = rng.standard_normal(n)
    RHS = jnp.asarray(MX0)
    for j in range(n):
        RHS = RHS + (k * Arow[j]) * jnp.asarray(F[j]) - (k * Hrow[j]) * jnp.asarray(LX[j])
    ref = np.asarray(RHS * jnp.asarray(rv))
    t = torch.as_tensor
    coef = t(np.concatenate([k * Arow, k * Hrow]))
    got = rk_stage_combine(t(MX0), [t(f) for f in F], [t(x) for x in LX], t(rv), coef)
    assert np.abs(got.numpy() - ref).max() <= 1e-14 * max(1, np.abs(ref).max())
    assert rk_stage_combine.launches == 0
