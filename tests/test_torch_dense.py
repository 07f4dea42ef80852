"""The dense matsolvers of the PyTorch port against dedalus_tpu.

The plain twins of kernels KA (refined inverse solve) and KB (batched
matvec) against dedalus_tpu.ops.solve on random stacks; the dense M and L
stacks, the pivoted combinations and the inverse_refined factorization on
the RBC 32x16 pencil of both packages; the default matsolver and its switch
to banded where the dense stacks are not built. Everything runs on the CPU:
the port's wrappers take their plain twins for CPU tensors, and launch
nothing. Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dedalus_tpu.ops import solve as jsolve
from dedalus_tpu.utils.config import config as jconfig

from dedalus_tpu_torch.ops import solve as tsolve
from dedalus_tpu_torch.utils.config import config as tconfig

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

G, P = 8, 40


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _random_system(seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((G, P, P)) + 8 * np.eye(P)
    R = rng.standard_normal((G, P))
    return A, np.linalg.inv(A), R


@pytest.mark.parametrize('seed', [0, 1])
def test_kb_plain_matches_reference_matvec(seed):
    A, _, R = _random_system(seed)
    ref = np.asarray(jsolve.batched_matvec(jnp.asarray(A), jnp.asarray(R)))
    got = tsolve.batched_matvec(torch.as_tensor(A), torch.as_tensor(R))
    assert _rel(got.numpy(), ref) <= 1e-13


def test_kb_pair_matches_two_reference_matvecs():
    A, Ainv, R = _random_system(2)
    refs = [np.asarray(jsolve.batched_matvec(jnp.asarray(M), jnp.asarray(R)))
            for M in (A, Ainv)]
    got = tsolve.dense_matvec(torch.as_tensor(A), torch.as_tensor(R), torch.as_tensor(Ainv))
    for g, r in zip(got, refs):
        assert _rel(g.numpy(), r) <= 1e-13


@pytest.mark.parametrize('passes', [0, 1])
def test_ka_plain_matches_reference_solves(passes):
    A, Ainv, R = _random_system(3)
    if passes:
        ref = jsolve.batched_refined_solve(jnp.asarray(Ainv), jnp.asarray(A), jnp.asarray(R))
        got = tsolve.batched_refined_solve(*map(torch.as_tensor, (Ainv, A, R)))
    else:
        ref = jsolve.batched_inverse_solve(jnp.asarray(Ainv), jnp.asarray(R))
        got = tsolve.batched_inverse_solve(torch.as_tensor(Ainv), torch.as_tensor(R))
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-13


def test_cpu_tensors_launch_no_kernel():
    A, Ainv, R = (torch.as_tensor(a) for a in _random_system(4))
    before = (tsolve.dense_refined_solve.launches, tsolve.dense_matvec.launches)
    tsolve.batched_refined_solve(Ainv, A, R)
    tsolve.dense_matvec(A, R, Ainv)
    assert (tsolve.dense_refined_solve.launches, tsolve.dense_matvec.launches) == before


# --- on the RBC 32x16 pencil of both packages ---

@pytest.fixture(scope='module')
def rbc_solvers():
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jp, _ = jbuild(32, 16, Rayleigh=1e5)
    tp, _ = tbuild(32, 16, Rayleigh=1e5, device='cpu')
    return jp.build_solver(jd3.RK222), tp.build_solver(td3.RK222)


def test_default_matsolver_is_inverse_refined(rbc_solvers):
    js, ts = rbc_solvers
    assert ts.matsolver == js.matsolver == 'inverse_refined'


@pytest.mark.parametrize('name', ['M', 'L'])
def test_dense_stacks_equal_reference(rbc_solvers, name):
    js, ts = rbc_solvers
    ref = np.asarray(js.pencil.matrices[name])
    got = ts.pencil.matrices[name]
    assert got.device == torch.device('cpu') and got.dtype == torch.float64
    assert _rel(got.numpy(), ref) <= 1e-15


@pytest.mark.parametrize('coeffs', [{'M': 1.0, 'L': 0.25}, {'M': 1000.0, 'L': 1.0}])
def test_combined_with_pivots_equals_reference(rbc_solvers, coeffs):
    js, ts = rbc_solvers
    ref = js.pencil.combined_with_pivots(coeffs)
    got = ts.pencil.combined_with_pivots(coeffs)
    assert got.device == torch.device('cpu')
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generic_pivots_equal_reference(rbc_solvers):
    js, ts = rbc_solvers
    for a, b in zip(ts.pencil.generic_pivots(), js.pencil.generic_pivots()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('method', ['inverse_refined', 'inverse'])
def test_factorized_solve_matches_reference(rbc_solvers, method):
    js, ts = rbc_solvers
    coeffs = {'M': 1.0, 'L': 1e-3 * (2 - np.sqrt(2)) / 2}
    jf = jsolve.FactorizedStack(js.pencil.combined_with_pivots(coeffs), method=method)
    tf = tsolve.FactorizedStack(ts.pencil.combined_with_pivots(coeffs), method=method)
    R = np.random.default_rng(6).standard_normal((ts.pencil.G, ts.pencil.R))
    R *= ts.pencil.row_valid
    if method == 'inverse_refined':
        ref = jsolve.batched_refined_solve(jf.Ainv, jf.A, jnp.asarray(R))
    else:
        ref = jsolve.batched_inverse_solve(jf.Ainv, jnp.asarray(R))
    got = tf.solve(torch.as_tensor(R))
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-12


def test_refined_solve_residual(rbc_solvers):
    _, ts = rbc_solvers
    A = ts.pencil.combined_with_pivots({'M': 1.0, 'L': 0.3})
    tf = tsolve.FactorizedStack(A, method='inverse_refined')
    R = torch.as_tensor(np.random.default_rng(7).standard_normal((ts.pencil.G, ts.pencil.R)))
    X = tf.solve(R)
    resid = torch.linalg.norm(A @ X[..., None] - R[..., None]) / torch.linalg.norm(R)
    assert float(resid) <= 1e-12


# --- the switch to banded where the dense stacks are not built ---

@pytest.fixture
def no_dense_stacks():
    old = (jconfig.get('memory', 'max_dense_stack_gb'),
           tconfig.get('memory', 'max_dense_stack_gb'))
    jconfig.set('memory', 'max_dense_stack_gb', '0')
    tconfig.set('memory', 'max_dense_stack_gb', '0')
    yield
    jconfig.set('memory', 'max_dense_stack_gb', old[0])
    tconfig.set('memory', 'max_dense_stack_gb', old[1])


def test_sbdf2_default_switches_to_banded_without_dense_stacks(no_dense_stacks):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    js = jbuild(32, 16, Rayleigh=1e5)[0].build_solver(jd3.SBDF2)
    ts = tbuild(32, 16, Rayleigh=1e5, device='cpu')[0].build_solver(td3.SBDF2)
    assert ts.pencil.matrices['M'] is None and js.pencil.matrices['M'] is None
    js.step(1e-3)
    ts.step(1e-3)
    assert ts.matsolver == js.matsolver == 'banded'


def test_full_size_rbc_keeps_no_dense_stacks():
    """RBC 2048x512: (1024, 4109, 4109) f64 stacks exceed 2 GiB, so the
    default matsolver runs banded (the switch happens at the first step)."""
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem
    ts = build_rbc_problem(2048, 512, Rayleigh=2e6, device='cpu')[0].build_solver(td3.SBDF2)
    assert ts.matsolver == 'inverse_refined'
    assert ts.pencil.matrices['M'] is None and ts.pencil.matrices['L'] is None
    assert ts.pencil.banded_plan() is not None


# --- the device default ---

def test_distributor_without_device_needs_a_card():
    import dedalus_tpu_torch.public as td3
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    coords = td3.CartesianCoordinates('x', 'z')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td3.Distributor(coords)
    assert td3.Distributor(coords, device='cpu').device == torch.device('cpu')
