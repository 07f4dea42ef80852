"""The poly matsolver of the PyTorch port against dedalus_tpu.

The plain twin of kernel K14c (the separable apply and its pair form)
against dedalus_tpu.ops.solve.separable_apply(_pair) on identical inputs;
the separable fit, the Chebyshev inverse fit, the fit geometry and the
lazy combined form against the JAX package's; the poly solve of an RBC
32x12 stack; and the RBC trajectories under 'poly', from the dense fit at
16x12 and from the lazy form at 32x16 (no dense stacks), held to the JAX
package's 'lu' as tests/test_ivp.py holds its own. Everything runs on the
CPU, where the port's wrappers take their plain twins. Inputs are made with
numpy from a seed and handed to both packages.
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


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _separable_inputs(seed, G=12, P=20, qs=(3, 2)):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((G, P))
    Bcat = rng.standard_normal((P, sum(qs) * P))
    ws = [rng.standard_normal((G, q)) for q in qs]
    bads = [(0, G - 1), (0,)]
    Abads = [rng.standard_normal((len(b), P, P)) for b in bads]
    return X, Bcat, ws, bads, Abads


def test_k14c_plain_matches_reference_apply():
    X, Bcat, (w, _), (bad, _), (Abad, _) = _separable_inputs(0)
    Bc = Bcat[:, :3 * X.shape[1]]
    ref = jsolve.separable_apply(jnp.asarray(X), jnp.asarray(w), jnp.asarray(Bc), bad,
                                 jnp.asarray(Abad))
    T = lambda a: torch.as_tensor(a)
    got = tsolve.separable_apply(T(X), T(w), T(Bc), bad, T(Abad))
    assert _rel(got.numpy(), ref) <= 1e-13


def test_k14c_plain_matches_reference_pair():
    X, Bcat, (wA, wB), (badA, badB), (CA, CB) = _separable_inputs(1)
    refs = jsolve.separable_apply_pair(jnp.asarray(X), jnp.asarray(Bcat), jnp.asarray(wA),
                                       badA, jnp.asarray(CA), jnp.asarray(wB), badB,
                                       jnp.asarray(CB))
    T = lambda a: torch.as_tensor(a)
    gots = tsolve.separable_apply_pair(T(X), T(Bcat), T(wA), badA, T(CA), T(wB), badB, T(CB))
    for got, ref in zip(gots, refs):
        assert _rel(got.numpy(), ref) <= 1e-13


def test_k14c_strided_view_equals_copy():
    """The M and L stacks apply through column views of one Bcat."""
    X, Bcat, (wA, wB), (badA, badB), (CA, CB) = _separable_inputs(2)
    P = X.shape[1]
    T = lambda a: torch.as_tensor(a)
    view = T(Bcat)[:, 3 * P:]
    assert not view.is_contiguous()
    a = tsolve.separable_apply(T(X), T(wB), view, badB, T(CB))
    b = tsolve.separable_apply(T(X), T(wB), view.contiguous(), badB, T(CB))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_k14c_cpu_tensors_launch_no_kernel():
    X, Bcat, (wA, wB), (badA, badB), (CA, CB) = _separable_inputs(3)
    T = lambda a: torch.as_tensor(a)
    before = (tsolve.separable_apply.launches, tsolve.separable_apply_pair.launches)
    tsolve.separable_apply(T(X), T(wA), T(Bcat)[:, :3 * X.shape[1]], badA, T(CA))
    tsolve.separable_apply_pair(T(X), T(Bcat), T(wA), badA, T(CA), T(wB), badB, T(CB))
    assert (tsolve.separable_apply.launches, tsolve.separable_apply_pair.launches) == before


def test_bcat_of_is_the_reference_layout():
    B = np.random.default_rng(4).standard_normal((3, 7, 7))
    ref = np.concatenate([B[p].T for p in range(3)], axis=1)
    np.testing.assert_array_equal(tsolve.bcat_of(torch.as_tensor(B)).numpy(), ref)


# --- fits on an RBC 32x12 pencil stack ---

@pytest.fixture(scope='module')
def rbc_stack():
    """The pivoted (M 1000, L 0.5) combination of the RBC 32x12 pencil, from
    the JAX package (the port's is equal: tests/test_torch_dense.py)."""
    from dedalus_tpu.models.rbc import build_rbc_problem
    prob, _ = build_rbc_problem(Nx=32, Nz=12)
    solver = prob.build_solver(jd3.SBDF2, matsolver='lu')
    solver.pencil.build_matrices(['M', 'L'])
    return np.asarray(solver.pencil.combined_with_pivots({'M': 1000.0, 'L': 0.5}))


def test_fit_separable_stack_matches_reference(rbc_stack):
    ref = jsolve.fit_separable_stack(rbc_stack)
    got = tsolve.fit_separable_stack(rbc_stack)
    assert got['bad_idx'] == ref['bad_idx']
    assert _rel(got['B_host'], ref['B_host']) <= 1e-15
    np.testing.assert_array_equal(got['weights'], np.asarray(ref['weights']))
    np.testing.assert_array_equal(got['Abad'], np.asarray(ref['Abad']))


def test_fit_chebyshev_inverse_matches_reference(rbc_stack):
    fit = jsolve.fit_separable_stack(rbc_stack)
    B = fit['B_host']
    A_eval = lambda x: sum(x**p * B[p] for p in range(len(B)))
    G = rbc_stack.shape[0]
    ref = jsolve.fit_chebyshev_inverse(A_eval, G, n_nodes=16, bad_idx=fit['bad_idx'])
    got = tsolve.fit_chebyshev_inverse(A_eval, G, n_nodes=16, bad_idx=fit['bad_idx'])
    np.testing.assert_array_equal(got['weights'], np.asarray(ref['weights']))
    assert _rel(got['coeffs'], ref['coeffs_host']) <= 1e-15


def test_fit_geometry_matches_reference():
    ghat = np.linspace(-1, 1, 17)
    good = list(range(1, 17))
    assert tsolve._fit_geometry(ghat, good) == jsolve._fit_geometry(ghat, good)


def test_poly_solve_on_rbc_stack(rbc_stack):
    """tests/test_ivp.py:148-163 on the port: the solve of A X = A X0."""
    A = torch.as_tensor(rbc_stack)
    fact = tsolve.FactorizedStack(A, 'poly')
    X = np.random.default_rng(0).standard_normal(rbc_stack.shape[:2])
    R = torch.as_tensor(np.einsum('gij,gj->gi', rbc_stack, X))
    Xs = fact.poly_solve(R).numpy()
    assert np.abs(Xs - X).max() / np.abs(X).max() < 1e-10
    assert fact.solve(R).numpy().tobytes() == Xs.tobytes()


# --- trajectories ---

def _set_noise_ic(b, dist, zbasis, Lz, nx, nz):
    zg = np.asarray(dist.local_grid(zbasis, scale=1))
    noise = np.random.default_rng(42).standard_normal((nx, nz))
    b.change_scales(1)
    b['g'] = Lz - zg + 1e-3 * noise * zg * (Lz - zg)


def _run_16x12(d3, build, matsolver, **kw):
    prob, ctx = build(Nx=16, Nz=12, Rayleigh=2e4, **kw)
    solver = prob.build_solver(d3.SBDF2, matsolver=matsolver)
    _set_noise_ic(ctx['b'], ctx['dist'], ctx['zbasis'], ctx["Lz"], 16, 12)
    solver.run_steps(1e-3, 20)
    assert solver.matsolver == matsolver
    out = {}
    for f in solver.state:
        f.require_coeff_space()
        f.change_scales(1)
        out[f.name] = np.asarray(f.data)
    return out


@pytest.fixture(scope='module')
def rbc16_lu_reference():
    from dedalus_tpu.models.rbc import build_rbc_problem
    return _run_16x12(jd3, build_rbc_problem, 'lu')


def test_rbc16_poly_trajectory_matches_reference_lu(rbc16_lu_reference):
    """tests/test_ivp.py:117-145 on the port: 'poly' from the dense fit."""
    from dedalus_tpu_torch.models.rbc import build_rbc_problem
    got = _run_16x12(td3, build_rbc_problem, 'poly', device='cpu')
    for name, ref in rbc16_lu_reference.items():
        assert np.abs(got[name] - ref).max() < 1e-11, name


def _run_32x16(d3, build, config, matsolver, lazy, **kw):
    old = (config.get('memory', 'max_dense_stack_gb'),
           config.get('matrix assembly', 'sampled_min_groups'))
    try:
        if lazy:
            config.set('memory', 'max_dense_stack_gb', '0')
            config.set('matrix assembly', 'sampled_min_groups', '8')
        problem, ctx = build(32, 16, Rayleigh=1e5, **kw)
        solver = problem.build_solver(d3.SBDF2, matsolver=matsolver)
        if lazy:
            assert solver.pencil.separable is not None
            assert solver.pencil.matrices['M'] is None
        b = ctx['b']
        z = np.asarray(ctx['dist'].local_grid(ctx['zbasis'], scale=1))
        Lz = ctx['Lz']
        rng = np.random.default_rng(42)
        b.change_scales(1)
        b['g'] = 1e-3 * rng.standard_normal((32, 16)) * z * (Lz - z) + (Lz - z)
        solver.run_steps(1e-3, 20)
        return solver, np.asarray(solver.state_flat())
    finally:
        config.set('memory', 'max_dense_stack_gb', old[0])
        config.set('matrix assembly', 'sampled_min_groups', old[1])


def test_rbc32_lazy_poly_trajectory_matches_reference_dense_lu():
    """tests/test_ivp.py:401-436 on the port: sampled assembly, no dense
    stacks, the poly solve from the lazy form, against the JAX package's
    dense 'lu'; no silent escalation."""
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    _, ref = _run_32x16(jd3, jbuild, jconfig, 'lu', lazy=False)
    solver, got = _run_32x16(td3, tbuild, tconfig, 'poly', lazy=True, device='cpu')
    assert solver.matsolver == 'poly'
    err = np.abs(got - ref).max()
    assert err < 1e-11 * max(1, np.abs(ref).max()), err
    fact = next(iter(solver.timestepper._factorized.values()))
    assert fact.q in (4, 8, 12, 16, 24, 32) and 1 <= fact.refinements <= 12


def test_lazy_poly_form_matches_reference():
    """LazyCombined.poly_form of both packages on the sampled RBC 32x16
    pencil."""
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu.core.subsystems import LazyCombined as JLazy
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    from dedalus_tpu_torch.core.subsystems import LazyCombined as TLazy
    forms = []
    for build, config, lazy_cls, d3, kw in ((jbuild, jconfig, JLazy, jd3, {}),
                                            (tbuild, tconfig, TLazy, td3, {'device': 'cpu'})):
        old = config.get('matrix assembly', 'sampled_min_groups')
        try:
            config.set('matrix assembly', 'sampled_min_groups', '8')
            prob, _ = build(32, 16, Rayleigh=1e5, **kw)
            solver = prob.build_solver(d3.SBDF2, matsolver='lu')
            assert solver.pencil.separable is not None
            forms.append(lazy_cls(solver.pencil, {'M': 500.0, 'L': 1.0}).poly_form())
        finally:
            config.set('matrix assembly', 'sampled_min_groups', old)
    ref, got = forms
    assert tuple(got['bad_idx']) == tuple(ref['bad_idx'])
    np.testing.assert_array_equal(got['weights'], ref['weights'])
    np.testing.assert_array_equal(got['ghat'], ref['ghat'])
    assert _rel(got['B'], ref['B']) <= 1e-15
    assert _rel(got['Abad'], ref['Abad']) <= 1e-15
