"""Outer-refinement reuse of the main banded factorization in the PyTorch
port (the analogue of tests/test_ivp.py:475), and the per-step loop against
run_steps (the analogue of tests/test_ivp.py:218). RBC 32x16, Ra=1e5."""

import numpy as np
import pytest
import torch

from dedalus_tpu.utils.config import config as jconfig
from dedalus_tpu_torch.utils.config import config as tconfig

NX, NZ, RA, DT = 32, 16, 1e5, 1e-3

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def overrides():
    old = (jconfig.get('memory', 'max_dense_stack_gb'),
           jconfig.get('matrix assembly', 'sampled_min_groups'),
           tconfig.get('matrix assembly', 'sampled_min_groups'),
           tconfig.get('linear algebra', 'outer_reuse_rho'))
    jconfig.set('memory', 'max_dense_stack_gb', '0')
    jconfig.set('matrix assembly', 'sampled_min_groups', '8')
    tconfig.set('matrix assembly', 'sampled_min_groups', '8')
    yield
    jconfig.set('memory', 'max_dense_stack_gb', old[0])
    jconfig.set('matrix assembly', 'sampled_min_groups', old[1])
    tconfig.set('matrix assembly', 'sampled_min_groups', old[2])
    tconfig.set('linear algebra', 'outer_reuse_rho', old[3])


def _port_solver():
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem, initial_condition
    problem, ctx = build_rbc_problem(NX, NZ, Rayleigh=RA, device='cpu')
    solver = problem.build_solver(td3.SBDF2, matsolver='banded')
    initial_condition(ctx, seed=42)
    return solver


def _port_run(rho, n_steps=8):
    tconfig.set('linear algebra', 'outer_reuse_rho', str(rho))
    solver = _port_solver()
    solver.run_steps(DT, n_steps)
    ts = solver.timestepper
    return solver.state_flat().numpy(), len(ts._factorized), dict(ts._outer_for_key)


@pytest.fixture(scope='module')
def reuse_runs(overrides):
    return {rho: _port_run(rho) for rho in (0.55, 0.0)}


def test_outer_reuse_builds_one_factorization(reuse_runs):
    X1, nfacts1, omap1 = reuse_runs[0.55]
    X0, nfacts0, omap0 = reuse_runs[0.0]
    assert nfacts1 == 1 and nfacts0 == 2
    assert any(n > 0 for n in omap1.values()), omap1
    assert all(n == 0 for n in omap0.values()), omap0
    assert np.abs(X1 - X0).max() / max(1.0, np.abs(X0).max()) < 1e-11


def test_outer_reuse_matches_reference(reuse_runs):
    import dedalus_tpu.public as jd3
    from dedalus_tpu.models.rbc import build_rbc_problem
    problem, ctx = build_rbc_problem(NX, NZ, Rayleigh=RA)
    solver = problem.build_solver(jd3.SBDF2, matsolver='banded')
    b = ctx['b']
    z = ctx['dist'].local_grid(ctx['zbasis'], scale=1)
    Lz = ctx['Lz']
    b.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    b['g'] = np.array(b['g']) * z * (Lz - z) + (Lz - z)
    solver.run_steps(DT, 8)
    ref = np.asarray(solver.state_flat())
    assert len(solver.timestepper._factorized) == 1
    X1 = reuse_runs[0.55][0]
    assert np.abs(X1 - ref).max() / max(1.0, np.abs(ref).max()) < 1e-11


def test_step_loop_matches_run_steps(overrides):
    tconfig.set('linear algebra', 'outer_reuse_rho', '0.55')
    looped = _port_solver()
    for _ in range(6):
        looped.step(DT)
    ran = _port_solver()
    ran.run_steps(DT, 6)
    assert looped.iteration == ran.iteration == 6
    Xl = looped.state_flat().numpy()
    Xr = ran.state_flat().numpy()
    assert np.abs(Xl - Xr).max() / max(1.0, np.abs(Xr).max()) < 1e-11
