"""The eigenvalue problem of the PyTorch port against dedalus_tpu, each side
built by the same lines (device='cpu' for the port; the port's side through
dedalus_tpu_torch.models.evp, the JAX side by the examples' own lines here):

  * waves on a string (examples/evp_1d_waves_on_a_string.py) at Nx = 64 and
    128: the pencil matrices M and L equal to the JAX package's (and
    sparse), the dense eigenvalues within 1e-10 relative of the JAX
    package's and of (n pi)^2, the sparse solve with one seeded v0 in both
    packages within 1e-10, the left and modified left eigenvectors equal to
    the JAX package's (dense) and with the JAX tests' biorthogonality
    (tests/test_evp.py: sparse here, dense at its N = 32), set_state's field within
    1e-12 of the JAX package's with the eigenvalue field written;
  * IVP.build_EVP from the complex heat equation (tests/test_ivp.py's
    test_build_evp_from_ivp): every subproblem's eigenvalue against the JAX
    package's and -nu k^2;
  * the complex 1-D Rayleigh-Benard EVP (examples/evp_1d_rayleigh_benard.py,
    Nz = 48): max_growth at three Rayleigh numbers within 1e-8 of the JAX
    package's (one seeded v0 in both), and the critical Rayleigh number
    within 1e-6 relative of 27 pi^4 / 4.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dedalus_tpu_torch.models import evp as mevp

torch.set_num_threads(1)

EIG_TOL = 1e-10
STATE_TOL = 1e-12
GROWTH_TOL = 1e-8
RA_TOL = 1e-6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_waves(Nx):
    """The waves example's lines in the JAX package."""
    import dedalus_tpu.public as d3
    xcoord = d3.Coordinate('x')
    dist = d3.Distributor(xcoord, dtype=np.float64)
    xbasis = d3.ChebyshevT(xcoord, size=Nx, bounds=(0, 1))
    u = dist.Field(name='u', bases=xbasis)
    tau_1 = dist.Field(name='tau_1')
    tau_2 = dist.Field(name='tau_2')
    lam = dist.Field(name='lam')
    dx = lambda A: d3.Differentiate(A, xcoord)
    lift_basis = xbasis.derivative_basis(2)
    lift = lambda A, n: d3.Lift(A, lift_basis, n)
    problem = d3.EVP([u, tau_1, tau_2], eigenvalue=lam, namespace=locals())
    problem.add_equation("lam*u + dx(dx(u)) + lift(tau_1,-1) + lift(tau_2,-2) = 0")
    problem.add_equation("u(x=0) = 0")
    problem.add_equation("u(x=1) = 0")
    return problem, u


@pytest.fixture(scope='module', params=[64, 128], ids=['Nx64', 'Nx128'])
def waves(request):
    Nx = request.param
    jproblem, ju = _jax_waves(Nx)
    tproblem, ctx = mevp.build_waves_problem(Nx, device='cpu')
    return Nx, (jproblem, jproblem.build_solver(), ju), (tproblem, tproblem.build_solver(),
                                                        ctx['u'])


def _finite_sorted(evals):
    return np.sort(evals[np.isfinite(evals)].real)


def test_waves_matrices_match_reference(waves):
    Nx, (_, js, _), (_, ts, _) = waves
    for name in ('M', 'L'):
        got, ref = ts.pencil.matrices_scipy[name][0], js.pencil.matrices_scipy[name][0]
        assert sp.issparse(got)
        assert np.abs(got.toarray() - ref.toarray()).max() <= 1e-14 * abs(ref).max()
    assert np.array_equal(ts.pencil.row_valid, js.pencil.row_valid)
    assert np.array_equal(ts.pencil.col_valid, js.pencil.col_valid)
    L, M, rv, cv = ts._sparse_pair(0)
    assert sp.issparse(L) and sp.issparse(M)
    assert L.nnz < 0.5 * L.shape[0] * L.shape[1]


def test_waves_dense_matches_reference(waves):
    Nx, (_, js, _), (_, ts, _) = waves
    js.solve_dense()
    ts.solve_dense()
    got, ref = _finite_sorted(ts.eigenvalues), _finite_sorted(js.eigenvalues)
    assert got.shape == ref.shape
    assert np.abs(got / ref - 1).max() < EIG_TOL
    exact = (np.pi * np.arange(1, 9))**2
    assert np.abs(got[:8] / exact - 1).max() < EIG_TOL


def test_waves_sparse_with_one_v0(waves):
    Nx, (_, js, _), (_, ts, _) = waves
    n = ts._sparse_pair(0)[0].shape[0]
    v0 = np.random.default_rng(Nx).standard_normal(n)
    js.solve_sparse(N=4, target=50.0, v0=v0)
    ts.solve_sparse(N=4, target=50.0, v0=v0)
    got, ref = np.sort_complex(ts.eigenvalues), np.sort_complex(js.eigenvalues)
    assert np.abs(got - ref).max() < EIG_TOL * np.abs(ref).max()
    for e in (np.pi * np.arange(1, 4))**2:
        assert np.min(np.abs(got - e)) < 1e-8 * e


def test_waves_left_eigenvectors(waves):
    """The dense left and modified left eigenvectors equal to the JAX
    package's; the sparse ones with the JAX tests' biorthogonality
    (tests/test_evp.py::test_left_eigenvectors_sparse) and normalized."""
    Nx, (_, js, _), (_, ts, _) = waves
    ts.solve_dense(left=True)
    js.solve_dense(left=True)
    finite = np.isfinite(ts.eigenvalues)
    for name in ('left_eigenvectors', 'modified_left_eigenvectors'):
        got, ref = getattr(ts, name)[:, finite], getattr(js, name)[:, finite]
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), name
    n = ts._sparse_pair(0)[0].shape[0]
    v0 = np.random.default_rng(Nx + 1).standard_normal(n)
    ts.solve_sparse(N=4, target=10.0, left=True, v0=v0)
    assert np.allclose(np.sort_complex(ts.eigenvalues),
                       np.sort_complex(np.conj(ts.left_eigenvalues)))
    G = ts.modified_left_eigenvectors.conj().T @ ts.right_eigenvectors
    off = G - np.diag(np.diag(G))
    assert np.abs(off).max() < 1e-6 * np.abs(np.diag(G)).max()
    # normalized: <w_mod_i, v_i> is the same for every mode
    assert np.abs(np.diag(G) - np.diag(G)[0]).max() < 1e-8 * np.abs(np.diag(G)).max()


def test_dense_left_biorthogonality():
    """tests/test_evp.py::test_left_eigenvectors_dense at its own N = 32:
    the modified left eigenvectors biorthogonal to the right ones."""
    problem, ctx = mevp.build_waves_problem(32, device='cpu')
    solver = problem.build_solver()
    solver.solve_dense(left=True)
    finite = np.isfinite(solver.eigenvalues)
    G = (solver.modified_left_eigenvectors[:, finite].conj().T
         @ solver.right_eigenvectors[:, finite])
    d = np.abs(np.diag(G))
    mask = d > 1e-8
    off = G - np.diag(np.diag(G))
    assert np.abs(off[np.ix_(mask, mask)]).max() < 1e-6


def test_waves_set_state_matches_reference(waves):
    Nx, (jp, js, ju), (tp, ts, tu) = waves
    js.solve_dense()
    ts.solve_dense()
    idx = int(np.argmin(np.abs(ts.eigenvalues - np.pi**2)))
    assert idx == int(np.argmin(np.abs(js.eigenvalues - np.pi**2)))
    js.set_state(idx)
    ts.set_state(idx)
    for jf, tf in zip(jp.variables, tp.variables):
        jf.require_coeff_space()
        tf.require_coeff_space()
        ref = np.asarray(jf.data)
        assert np.abs(_np(tf.data) - ref).max() <= STATE_TOL * np.abs(ref).max()
    lam = _np(tp.eigenvalue['g']).ravel()[0]
    assert abs(lam - np.pi**2) < 1e-8 and tp.eigenvalue['g'].device.type == 'cpu'
    assert abs(lam - np.asarray(jp.eigenvalue['g']).ravel()[0]) <= 1e-14 * lam


def test_build_evp_from_complex_heat_ivp():
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    out = []
    for d3, kw in ((jd3, {}), (td3, dict(device='cpu'))):
        c = d3.Coordinate('x')
        dist = d3.Distributor(c, dtype=np.complex128, **kw)
        xb = d3.ComplexFourier(c, size=16, bounds=(0, 2 * np.pi))
        u = dist.Field(name='u', bases=xb)
        nu = 0.3
        dx = lambda A: d3.Differentiate(A, c)
        problem = d3.IVP([u], namespace=locals())
        problem.add_equation("dt(u) - nu*dx(dx(u)) = 0")
        evp = problem.build_EVP()
        solver = evp.build_solver()
        evals = []
        for g in range(len(solver.subproblems)):
            solver.solve_dense(sp_index=g)
            evals.append(solver.eigenvalues[np.isfinite(solver.eigenvalues)])
        out.append((evp, np.concatenate(evals)))
    (jevp, jevals), (tevp, tevals) = out
    assert [v.name for v in tevp.variables] == ['du'] and tevp.eigenvalue.name == 'lam'
    # a subproblem named by its group, as the EVP examples name it
    tsolver = tevp.build_solver()
    sp = tsolver.subproblems[3]
    assert tsolver.subproblems_by_group[sp.group] is sp
    tsolver.solve_dense(sp)
    assert tsolver.eigenvalue_subproblem == 3
    assert np.abs(tevals - jevals).max() < 1e-12
    expect = np.sort([-0.3 * k**2 for k in range(-7, 8)])
    got = np.sort(tevals.real)[:len(expect)]
    assert np.abs(got - expect).max() < EIG_TOL


def _jax_rb_max_growth(Ra, k, v0, Nz=48):
    """The Rayleigh-Benard example's max_growth in the JAX package."""
    import dedalus_tpu.public as d3
    zcoord = d3.Coordinate('z')
    dist = d3.Distributor(zcoord, dtype=np.complex128)
    zbasis = d3.ChebyshevT(zcoord, size=Nz, bounds=(0, 1))
    W = dist.Field(name='W', bases=zbasis)
    Theta = dist.Field(name='Theta', bases=zbasis)
    omega = dist.Field(name='omega')
    taus_W = [dist.Field(name=f'tw{i}') for i in range(4)]
    taus_T = [dist.Field(name=f'tt{i}') for i in range(2)]
    dz = lambda A: d3.Differentiate(A, zcoord)
    lift4 = lambda A, n: d3.Lift(A, zbasis.derivative_basis(4), n)
    lift2 = lambda A, n: d3.Lift(A, zbasis.derivative_basis(2), n)
    k2 = float(k)**2
    ns = dict(W=W, Theta=Theta, omega=omega, dz=dz, lift4=lift4, lift2=lift2,
              Ra=float(Ra), k2=k2, tw0=taus_W[0], tw1=taus_W[1], tw2=taus_W[2],
              tw3=taus_W[3], tt0=taus_T[0], tt1=taus_T[1])
    problem = d3.EVP([W, Theta] + taus_W + taus_T, eigenvalue=omega, namespace=ns)
    problem.add_equation(
        "omega*(dz(dz(W)) - k2*W)"
        " - (dz(dz(dz(dz(W)))) - 2*k2*dz(dz(W)) + k2*k2*W) + Ra*k2*Theta"
        " + lift4(tw0,-1) + lift4(tw1,-2) + lift4(tw2,-3) + lift4(tw3,-4) = 0")
    problem.add_equation(
        "omega*Theta - (dz(dz(Theta)) - k2*Theta) - W"
        " + lift2(tt0,-1) + lift2(tt1,-2) = 0")
    problem.add_equation("W(z=0) = 0")
    problem.add_equation("W(z=1) = 0")
    problem.add_equation("dz(dz(W))(z=0) = 0")
    problem.add_equation("dz(dz(W))(z=1) = 0")
    problem.add_equation("Theta(z=0) = 0")
    problem.add_equation("Theta(z=1) = 0")
    solver = problem.build_solver()
    solver.solve_sparse(N=4, target=0.1, v0=v0)
    return np.max(solver.eigenvalues.real)


def test_rayleigh_benard_evp():
    rb = mevp.RayleighBenardEVP(device='cpu')
    n = rb.problem(600, mevp.RB_KC).build_solver()._sparse_pair(0)[0].shape[0]
    v0 = np.random.default_rng(48).standard_normal(n).astype(np.complex128)
    for Ra in (500.0, 657.5, 800.0):
        got = rb.max_growth(Ra, mevp.RB_KC, v0=v0)
        ref = _jax_rb_max_growth(Ra, mevp.RB_KC, v0)
        assert abs(got - ref) < GROWTH_TOL, (Ra, got, ref)
    Ra_c = rb.critical_rayleigh(v0=v0)
    assert abs(Ra_c / mevp.RB_RA_CRITICAL - 1) < RA_TOL
