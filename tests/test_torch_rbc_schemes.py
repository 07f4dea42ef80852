"""RBC 32x16 under the banded matsolver with the three- and four-step BDF
schemes and CNAB2 in the PyTorch port, against the JAX package's same
scheme under 'lu' (as tests/test_ivp.py:440-472 holds banded against LU,
within 1e-11), with the lazy form forced ([matrix assembly]
sampled_min_groups = 8). Each scheme's startup steps are served by the main
factorization through outer refinement, so one factorization is built;
CNLF2's startup key (rho 1.0 against its main key) builds its own.

Where both packages run banded, the startup keys, their probed outer
curves and their outer pass counts are held against the JAX package's
(with its refinement rule, [linear algebra] refinement_rule = reference).
The counts agree within one pass, or both sit on the curves' roundoff
plateau (SBDF3's SBDF1 key: 38 passes on the port, 35 on the JAX package,
whose probe stops at a floor twice the port's; ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from dedalus_tpu.utils.config import config as jconfig
from dedalus_tpu_torch.utils.config import config as tconfig

NX, NZ, RA, DT, STEPS = 32, 16, 1e5, 1e-3, 10

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def overrides():
    old = (tconfig.get('matrix assembly', 'sampled_min_groups'),
           tconfig.get('linear algebra', 'refinement_rule'),
           jconfig.get('memory', 'max_dense_stack_gb'),
           jconfig.get('matrix assembly', 'sampled_min_groups'))
    tconfig.set('matrix assembly', 'sampled_min_groups', '8')
    tconfig.set('linear algebra', 'refinement_rule', 'reference')
    yield
    tconfig.set('matrix assembly', 'sampled_min_groups', old[0])
    tconfig.set('linear algebra', 'refinement_rule', old[1])
    jconfig.set('memory', 'max_dense_stack_gb', old[2])
    jconfig.set('matrix assembly', 'sampled_min_groups', old[3])


def jax_banded(scheme):
    """The JAX package's banded run, with its lazy form forced as in
    tests/test_ivp.py:440-472."""
    old = jconfig.get('memory', 'max_dense_stack_gb')
    jconfig.set('memory', 'max_dense_stack_gb', '0')
    jconfig.set('matrix assembly', 'sampled_min_groups', '8')
    try:
        return reference(scheme, 'banded')
    finally:
        jconfig.set('memory', 'max_dense_stack_gb', old)


def port_banded(scheme, n_steps=STEPS):
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem, initial_condition
    problem, ctx = build_rbc_problem(NX, NZ, Rayleigh=RA, device='cpu')
    solver = problem.build_solver(getattr(td3, scheme), matsolver='banded')
    initial_condition(ctx, seed=42)
    solver.run_steps(DT, n_steps)
    assert solver.matsolver == 'banded'
    return solver


def reference(scheme, matsolver, n_steps=STEPS):
    """The JAX package's run from the same initial condition."""
    import dedalus_tpu.public as jd3
    from dedalus_tpu.models.rbc import build_rbc_problem
    problem, ctx = build_rbc_problem(NX, NZ, Rayleigh=RA)
    solver = problem.build_solver(getattr(jd3, scheme), matsolver=matsolver)
    b = ctx['b']
    z = ctx['dist'].local_grid(ctx['zbasis'], scale=1)
    Lz = ctx['Lz']
    b.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    b['g'] = np.array(b['g']) * z * (Lz - z) + (Lz - z)
    solver.run_steps(DT, n_steps)
    return solver


@pytest.mark.parametrize('scheme', ['SBDF3', 'SBDF4', 'CNAB2'])
def test_banded_matches_reference_lu(overrides, scheme):
    solver = port_banded(scheme)
    ts = solver.timestepper
    assert len(ts._factorized) == 1
    main = next(iter(ts._factorized))
    assert ts._outer_for_key[main] == 0
    # every startup key was served by the main factorization
    startup = [k for k in ts._outer_for_key if k != main]
    assert len(startup) == (ts.steps - 1 if scheme != 'CNAB2' else 0)
    assert all(ts._outer_for_key[k] > 0 for k in startup)
    ref = np.asarray(reference(scheme, 'lu').state_flat())
    got = solver.state_flat().numpy()
    assert np.abs(got - ref).max() <= 1e-11 * max(1.0, np.abs(ref).max())


def test_cnlf2_startup_builds_its_own_factorization(overrides):
    """CNLF2's CNAB1 startup key sits at rho 1.0 from its main key, past
    [linear algebra] outer_reuse_rho: two factorizations, no outer passes."""
    ts = port_banded('CNLF2', n_steps=4).timestepper
    assert len(ts._factorized) == 2
    assert set(ts._outer_for_key.values()) == {0}


def _on_plateau(curve, passes):
    """Whether `passes` outer passes (curve index passes + 1) reach within
    4x of the curve's floor."""
    curve = np.asarray(curve)
    return curve[min(passes + 1, curve.size - 1)] <= 4 * curve.min()


@pytest.mark.parametrize('scheme', ['SBDF3', 'SBDF4'])
def test_startup_outer_passes_match_reference(overrides, scheme):
    port = port_banded(scheme).timestepper
    ref = jax_banded(scheme).timestepper
    assert len(ref._factorized) == len(port._factorized) == 1
    assert set(port._outer_for_key) == set(ref._outer_for_key)
    assert set(port._outer_curves) == set(ref._outer_curves)
    for ckey, jc in ref._outer_curves.items():
        pc, jc = np.asarray(port._outer_curves[ckey]), np.asarray(jc)
        n = min(pc.size, jc.size)
        above = jc[:n] > 1e-11
        assert np.all(np.abs(pc[:n] - jc[:n])[above] <= 0.05 * jc[:n][above]), ckey
    for key, jn in ref._outer_for_key.items():
        pn = port._outer_for_key[key]
        if abs(pn - jn) <= 1:
            continue
        rho = max(abs(key[0] - base[0]) / base[0] for base in port._factorized)
        ckey = min((ck for ck in port._outer_curves if ck[1] >= rho), key=lambda ck: ck[1])
        assert _on_plateau(port._outer_curves[ckey], pn), (key, pn, jn)
        assert _on_plateau(ref._outer_curves[ckey], jn), (key, pn, jn)
