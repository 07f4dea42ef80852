"""The lu, mixed and matrix_free matsolvers of the PyTorch port, and the
matsolver escalation, against dedalus_tpu.

The plain twins of kernels K14a (the batched LU solve) and K14b (the
mixed-precision solve) against dedalus_tpu.ops.solve on identical factors,
and the port's LU factors against host_lu_factor_stack's; RBC trajectories
under each matsolver with SBDF2 and RK222 against the JAX package's 'lu';
the LBVP under 'lu' and 'mixed'; and the order in which a matsolver that
cannot serve a pencil gives way (dense -> banded or poly, banded -> poly,
poly -> inverse_refined), as the JAX package's, under config overrides.

'mixed' and 'matrix_free' have no test in the JAX package. Their bounds here
are 10x the JAX package's own figures against its 'lu' at RBC 32x16 after 20
steps (SBDF2: mixed 1.36e-14, matrix_free 1.41e-4; RK222: mixed 1.68e-13,
matrix_free 1.06e-4): matrix_free's one refinement pass of an f32 inverse
leaves ~1e-4. Everything runs on the CPU, where the port's wrappers take
their plain twins. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import dedalus_tpu.public as jd3
from dedalus_tpu.ops import solve as jsolve
from dedalus_tpu.utils.config import config as jconfig

import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.ops import solve as tsolve
from dedalus_tpu_torch.utils.config import config as tconfig

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

G, P = 8, 40
# 10x the JAX package's own error against its 'lu' (module docstring)
BOUNDS = {('SBDF2', 'mixed'): 1.36e-13, ('SBDF2', 'matrix_free'): 1.41e-3,
          ('RK222', 'mixed'): 1.68e-12, ('RK222', 'matrix_free'): 1.06e-3,
          ('SBDF2', 'lu'): 1e-11, ('RK222', 'lu'): 1e-11}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _random_system(seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((G, P, P)) + 2 * np.eye(P)
    return A, rng.standard_normal((G, P))


def test_lu_factors_match_reference():
    A, _ = _random_system(0)
    jlu, jperm = jsolve.host_lu_factor_stack(A)
    tlu, tperm = tsolve.lu_factor_stack(torch.as_tensor(A))
    assert tperm.dtype == torch.int32
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    assert _rel(tlu.numpy(), jlu) <= 1e-13


def test_k14a_plain_matches_reference_on_identical_factors():
    A, R = _random_system(1)
    lu, perm = jsolve.host_lu_factor_stack(A)
    ref = jsolve.batched_lu_solve(lu, perm, jnp.asarray(R))
    got = tsolve.lu_solve(torch.as_tensor(np.array(lu)), torch.as_tensor(np.array(perm)),
                          torch.as_tensor(R))
    assert _rel(got.numpy(), ref) <= 1e-12
    X = np.linalg.solve(A, R[..., None])[..., 0]
    assert _rel(got.numpy(), X) <= 1e-10


def test_k14b_plain_matches_reference():
    A, R = _random_system(2)
    Ainv32 = np.linalg.inv(A).astype(np.float32)
    ref = jsolve.batched_mixed_solve(jnp.asarray(Ainv32), jnp.asarray(A), jnp.asarray(R))
    got = tsolve.mixed_solve(torch.as_tensor(Ainv32), torch.as_tensor(A), torch.as_tensor(R))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) <= 1e-12


def test_cpu_tensors_launch_no_kernel():
    A, R = _random_system(3)
    At, Rt = torch.as_tensor(A), torch.as_tensor(R)
    lu, perm = tsolve.lu_factor_stack(At)
    before = (tsolve.lu_solve.launches, tsolve.mixed_solve.launches)
    tsolve.lu_solve(lu, perm, Rt)
    tsolve.mixed_solve(torch.linalg.inv(At).float(), At, Rt)
    assert (tsolve.lu_solve.launches, tsolve.mixed_solve.launches) == before


def test_factorized_stack_solves_each_dense_method():
    A, R = _random_system(4)
    At, Rt = torch.as_tensor(A), torch.as_tensor(R)
    X = np.linalg.solve(A, R[..., None])[..., 0]
    for method, tol in (('lu', 1e-12), ('inverse', 1e-12), ('inverse_refined', 1e-12),
                        ('mixed', 1e-12), ('matrix_free', 1e-4)):
        fact = tsolve.FactorizedStack(At, method)
        assert _rel(fact.solve(Rt).numpy(), X) <= tol, method


# --- RBC trajectories ---

def _run_rbc(d3, build, scheme, matsolver, Nx=32, Nz=16, **kw):
    problem, ctx = build(Nx, Nz, Rayleigh=1e5, **kw)
    solver = problem.build_solver(getattr(d3, scheme), matsolver=matsolver)
    b = ctx['b']
    z = np.asarray(ctx['dist'].local_grid(ctx['zbasis'], scale=1))
    Lz = ctx['Lz']
    rng = np.random.default_rng(42)
    b.change_scales(1)
    b['g'] = 1e-3 * rng.standard_normal((Nx, Nz)) * z * (Lz - z) + (Lz - z)
    solver.run_steps(1e-3, 20)
    assert solver.matsolver == matsolver
    return np.asarray(solver.state_flat())


@pytest.fixture(scope='module')
def lu_references():
    from dedalus_tpu.models.rbc import build_rbc_problem
    return {key: _run_rbc(jd3, build_rbc_problem, *key)
            for key in (('SBDF2', 'lu'), ('RK222', 'lu'), ('SBDF2', 'lu', 16, 12))}


def test_rbc16_lu_trajectory_matches_reference(lu_references):
    """RBC 16x12 under 'lu', 20 steps, as tests/test_ivp.py:145."""
    from dedalus_tpu_torch.models.rbc import build_rbc_problem
    got = _run_rbc(td3, build_rbc_problem, 'SBDF2', 'lu', 16, 12, device='cpu')
    assert np.abs(got - lu_references[('SBDF2', 'lu', 16, 12)]).max() < 1e-11


@pytest.mark.parametrize('scheme, matsolver', sorted(BOUNDS))
def test_rbc32_trajectory_matches_reference_lu(lu_references, scheme, matsolver):
    from dedalus_tpu_torch.models.rbc import build_rbc_problem
    ref = lu_references[(scheme, 'lu')]
    got = _run_rbc(td3, build_rbc_problem, scheme, matsolver, device='cpu')
    err = np.abs(got - ref).max()
    assert err <= BOUNDS[(scheme, matsolver)] * max(1.0, np.abs(ref).max()), err


def test_rk_rejects_poly_as_the_reference():
    """'poly' is not an RK matsolver in the JAX package either."""
    from dedalus_tpu_torch.models.rbc import build_rbc_problem
    problem, _ = build_rbc_problem(16, 12, Rayleigh=1e5, device='cpu')
    solver = problem.build_solver(td3.RK222, matsolver='poly')
    with pytest.raises(ValueError, match='Unknown matsolver'):
        solver.step(1e-3)


def test_unknown_matsolver_raises():
    from dedalus_tpu_torch.models.rbc import build_rbc_problem
    problem, _ = build_rbc_problem(16, 12, Rayleigh=1e5, device='cpu')
    with pytest.raises(ValueError, match='Unknown matsolver'):
        problem.build_solver(td3.SBDF2, matsolver='qr')


# --- LBVP ---

def _poisson(d3, matsolver, **dkw):
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    xb = d3.RealFourier(coords['x'], size=16, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords['z'], size=24, bounds=(0, 1))
    u = dist.Field(name='u', bases=(xb, zb))
    tau1 = dist.Field(name='tau1', bases=xb)
    tau2 = dist.Field(name='tau2', bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)
    x, z = dist.local_grids(xb, zb, scales=1)
    F = dist.Field(name='F', bases=(xb, zb))
    F['g'] = -4 * np.sin(2 * x) * z * (1 - z) - 2 * np.sin(2 * x)
    problem = d3.LBVP([u, tau1, tau2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau1,-1) + lift(tau2,-2) = F")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("u(z=1) = 0")
    solver = problem.build_solver(matsolver=matsolver)
    solver.solve()
    u.change_scales(1)
    return np.asarray(u['g']), np.sin(2 * x) * z * (1 - z)


@pytest.mark.parametrize('matsolver', ['lu', 'mixed'])
def test_lbvp_matches_reference(matsolver):
    ref, exact = _poisson(jd3, 'lu')
    got, _ = _poisson(td3, matsolver, device='cpu')
    assert np.abs(got - ref).max() <= 1e-11
    assert np.abs(got - exact).max() <= 1e-12


def test_lbvp_rejects_matrix_free():
    with pytest.raises(ValueError, match='matrix_free'):
        _poisson(td3, 'matrix_free', device='cpu')


# --- escalation ---

def _escalated(d3, build, config, matsolver, lazy, no_banded_plan, Nx, **kw):
    """The matsolver a solver steps with after one step from a given one."""
    old = (config.get('memory', 'max_dense_stack_gb'),
           config.get('matrix assembly', 'sampled_min_groups'))
    try:
        config.set('matrix assembly', 'sampled_min_groups', '8')
        if lazy:
            config.set('memory', 'max_dense_stack_gb', '0')
        problem, ctx = build(Nx, 12, Rayleigh=1e5, **kw)
        solver = problem.build_solver(d3.SBDF2, matsolver=matsolver)
        if no_banded_plan:
            solver.pencil.banded_plan = lambda: None
        solver.step(1e-3)
        state = np.asarray(solver.state_flat())
        assert np.isfinite(state).all()
        return solver.matsolver
    finally:
        config.set('memory', 'max_dense_stack_gb', old[0])
        config.set('matrix assembly', 'sampled_min_groups', old[1])


def _no_banded_form(self):
    raise ValueError("pencil has no bordered-banded structure")


@pytest.mark.parametrize('matsolver, lazy, breaks, Nx, expected', [
    ('lu', True, None, 16, 'banded'),           # no dense stacks: banded plan
    ('mixed', True, 'plan', 32, 'poly'),        # no dense stacks, no banded plan
    ('banded', True, 'form', 32, 'poly'),       # the banded factorization refuses
    ('poly', False, None, 4, 'inverse_refined'),    # two groups: not separable
])
def test_escalation_order_matches_reference(monkeypatch, matsolver, lazy, breaks, Nx,
                                            expected):
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu.core.subsystems import LazyCombined as JLazy
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    from dedalus_tpu_torch.core.subsystems import LazyCombined as TLazy
    if breaks == 'form':
        for cls in (JLazy, TLazy):
            monkeypatch.setattr(cls, 'banded_form', _no_banded_form)
    no_plan = breaks == 'plan'
    got = _escalated(td3, tbuild, tconfig, matsolver, lazy, no_plan, Nx, device='cpu')
    # (the JAX package's banded factorization with its probes takes seconds
    # here: its switch to banded is read off dedalus_tpu/core/timesteppers.py
    # :385-391, and tests/test_torch_dense.py holds the port's)
    ref = (expected if expected == 'banded'
           else _escalated(jd3, jbuild, jconfig, matsolver, lazy, no_plan, Nx))
    assert got == ref == expected
