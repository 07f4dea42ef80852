"""The banded cold start of the PyTorch port against dedalus_tpu: the plain
twins of the kernels this path adds (K8b multi-column sweeps, K6 around the
sweeps, K9 residual and norm), the two refinement probes, and the slice as a
whole from build_rbc_problem through run_steps.

Everything runs on the CPU: the port's wrappers take their plain twins for
CPU tensors. Inputs are made with numpy from a seed and handed to both
packages; factorizations are carried over with banded_arrays_from_reference.
"""

import numpy as np
import pytest
import scipy.sparse as ss
import torch

import jax.numpy as jnp
import dedalus_tpu.ops.banded as jb
from dedalus_tpu.ops import solve as jsolve
from dedalus_tpu.core.subsystems import LazyCombined as JLazy
from dedalus_tpu.utils.config import config as jconfig

import dedalus_tpu_torch.ops.banded as tb
from dedalus_tpu_torch.ops import solve as tsolve
from dedalus_tpu_torch.core.subsystems import LazyCombined as TLazy
from dedalus_tpu_torch.utils.config import config as tconfig
from dedalus_tpu_torch.csrc.residual_norm import residual_norm, residual_norm_plain
from dedalus_tpu_torch.utils.interop import banded_arrays_from_reference

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

NX, NZ, RA, DT = 32, 16, 1e5, 1e-3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


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
           tconfig.get('memory', 'max_dense_stack_gb'),
           tconfig.get('matrix assembly', 'sampled_min_groups'))
    jconfig.set('memory', 'max_dense_stack_gb', '0')
    jconfig.set('matrix assembly', 'sampled_min_groups', '8')
    tconfig.set('matrix assembly', 'sampled_min_groups', '8')
    yield
    jconfig.set('memory', 'max_dense_stack_gb', old[0])
    jconfig.set('matrix assembly', 'sampled_min_groups', old[1])
    tconfig.set('memory', 'max_dense_stack_gb', old[2])
    tconfig.set('matrix assembly', 'sampled_min_groups', old[3])


# --- (a) K8b: the multi-column sweeps ---

def _random_blocks(G, Nb, nb, seed):
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((G, Nb, nb, nb)) + 4 * np.eye(nb)
    sub = rng.standard_normal((G, Nb, nb, nb))
    sub[:, 0] = 0
    sup = rng.standard_normal((G, Nb, nb, nb))
    sup[:, -1] = 0
    return diag, sub, sup


@pytest.mark.parametrize('G,Nb,nb,k', [(4, 6, 5, 3), (2, 4, 19, 26), (3, 1, 5, 2)])
def test_multi_rhs_solve_plain_matches_reference(G, Nb, nb, k):
    diag, sub, sup = _random_blocks(G, Nb, nb, seed=21)
    qr = tb.factor_block_tridiag_qr(*map(torch.as_tensor, (diag, sub, sup)))
    Rhs = np.random.default_rng(22).standard_normal((G, Nb, nb, k))
    ref = np.asarray(jb._multi_rhs_solve_device(
        *(jnp.asarray(qr[key].numpy()) for key in tb.FACTOR_KEYS), jnp.asarray(Rhs)))
    got = tb.multi_rhs_solve(qr, torch.as_tensor(Rhs)).numpy()
    assert _rel(got, ref) <= 1e-12
    # and it solves the block-tridiagonal system
    x = got.reshape(G, Nb * nb, k)
    A = np.zeros((G, Nb * nb, Nb * nb))
    for i in range(Nb):
        s = slice(i * nb, (i + 1) * nb)
        A[:, s, s] = diag[:, i]
        if i > 0:
            A[:, s, (i - 1) * nb:i * nb] = sub[:, i]
        if i < Nb - 1:
            A[:, s, (i + 1) * nb:(i + 2) * nb] = sup[:, i]
    assert _rel(A @ x, Rhs.reshape(G, Nb * nb, k)) <= 1e-11


def test_factor_writes_f32_copies_in_the_same_call():
    diag, sub, sup = _random_blocks(3, 5, 5, seed=23)
    t = list(map(torch.as_tensor, (diag, sub, sup)))
    plain = tb.factor_block_tridiag_qr_plain(*t)
    out32 = {k: torch.empty(plain[k].shape, dtype=torch.float32) for k in tb.FACTOR_KEYS}
    qr = tb.factor_block_tridiag_qr(*t, out32=out32)
    for k in tb.FACTOR_KEYS:
        assert torch.equal(qr[k], plain[k])
        assert torch.equal(out32[k], plain[k].to(torch.float32))


# --- (b) K6: around the sweeps, on identical factors ---

def _bordered_system(pinned):
    """A random bordered block-tridiagonal matrix (one border row and
    column); `pinned` adds the border-anchored kernel of
    tests/test_ivp.py:524, which the factorization repairs by pivot pinning."""
    rng = np.random.default_rng(3)
    nb, Nb, nbord = 4, 6, 1
    P = nb * Nb
    A = np.zeros((P, P))
    for i in range(Nb):
        r0 = i * nb
        A[r0:r0 + nb, r0:r0 + nb] = rng.normal(size=(nb, nb)) + (0 if pinned else 4 * np.eye(nb))
        if i > 0:
            A[r0:r0 + nb, r0 - nb:r0] = rng.normal(size=(nb, nb))
        if i < Nb - 1:
            A[r0:r0 + nb, r0 + nb:r0 + 2 * nb] = rng.normal(size=(nb, nb))
    A[0, :] = rng.normal(size=P)
    A[:, P - 1] = rng.normal(size=P)
    if pinned:
        A[1:, 13] = -2.0 * A[1:, 12]
        A[0, 13] = 1.7
    order = dict(col_perm=np.arange(P), row_perm=np.arange(P),
                 n_border=nbord, n_core=P - nbord, bcol_first=False)
    return A, order, nb


def _reference_arrays(jbanded):
    arrs = jbanded.solve_arrays()
    fac = {k: np.asarray(v) for k, v in arrs['fac'].items()}
    out = dict(fac=fac, row_perm=np.asarray(arrs['row_perm']),
               col_unperm=np.asarray(arrs['col_unperm']),
               Dr=np.asarray(arrs['Dr']), Dc=np.asarray(arrs['Dc']),
               bad_idx=jbanded.bad_idx)
    if 'Abad_inv' in arrs:
        out['Abad_inv'] = np.asarray(arrs['Abad_inv'])
    return out


def _shared_sweeps(*args):
    """The port's plain K5 in the reference's place, so that both packages'
    once() see the same f32 sweep output and only K6 is compared (the two
    f32 sweeps differ by their own rounding, ~1e-7)."""
    out = tb.block_tridiag_qr_solve_plain(*(torch.as_tensor(np.asarray(a)) for a in args))
    return jnp.asarray(out.numpy())


def _once_pair(jbb, tbb, seed, monkeypatch):
    """(reference once(R), the port's _once(R) on the reference's factors,
    R, the carried arrays)."""
    monkeypatch.setattr(jb, '_solve_sweeps_fn', lambda: _shared_sweeps)
    R = np.random.default_rng(seed).standard_normal((jbb.blocks.G, jbb.P))
    ref = np.asarray(jbb._once_fn()(jbb.solve_arrays(), jnp.asarray(R)))
    arrs = banded_arrays_from_reference(_reference_arrays(jbb))
    got = tbb._once(arrs, torch.as_tensor(R)).numpy()
    return ref, got, R, arrs


@pytest.mark.parametrize('pinned,branch', [(True, 'W1'), (False, 'W1T')])
def test_k6_twin_matches_reference_once_in_both_branches(pinned, branch, monkeypatch):
    A, order, nb = _bordered_system(pinned)

    def no_dense(g):
        raise AssertionError("no dense override expected")

    csr = [ss.csr_matrix(A)]
    jbb = jb.BorderedBandedSolver(jb.build_banded_blocks(None, None, None, order, nb, exact=csr),
                                  refinements=2, group_dense=no_dense)
    tbb = tb.BorderedBandedSolver(tb.build_banded_blocks(None, None, None, order, nb, exact=csr),
                                  'cpu', refinements=2, group_dense=no_dense)
    assert branch in jbb.fac and branch in tbb.arrs['fac']
    ref, got, R, arrs = _once_pair(jbb, tbb, 31, monkeypatch)
    # all-f64 correction: f64 rounding; W1T branch: the correction itself is
    # summed in f32, in another order in the two packages
    assert _rel(got, ref) <= (1e-11 if branch == 'W1' else 1e-6)
    # the port's own factorization solves the system too
    X = tbb.solve(torch.as_tensor(R), refinements=6).numpy()
    Xd = np.linalg.solve(A, R[0])
    assert np.abs(X[0] - Xd).max() < 1e-9 * max(1, np.abs(Xd).max())


@pytest.fixture(scope='module')
def rbc_factorizations(overrides):
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jp, _ = jbuild(NX, NZ, Rayleigh=RA)
    tp, _ = tbuild(NX, NZ, Rayleigh=RA, device='cpu')
    js = jp.build_solver(jd3.SBDF2, matsolver='banded')
    ts = tp.build_solver(td3.SBDF2, matsolver='banded')
    coeffs = {'M': 1500.0, 'L': 1.0}
    jf = jsolve.FactorizedStack(JLazy(js.pencil, coeffs), method='banded')
    tf = tsolve.FactorizedStack(TLazy(ts.pencil, coeffs), method='banded')
    return js, ts, jf, tf


def test_k6_twin_matches_reference_once_with_dense_override(rbc_factorizations, monkeypatch):
    _, _, jf, tf = rbc_factorizations
    jbb, tbb = jf.banded, tf.banded
    assert jbb.bad_idx and tbb.bad_idx == jbb.bad_idx      # the kx=0 group solves densely
    ref, got, R, arrs = _once_pair(jbb, tbb, 32, monkeypatch)
    assert 'Abad_inv' in arrs and 'W1' in arrs['fac']
    bad = list(jbb.bad_idx)
    good = [g for g in range(jbb.blocks.G) if g not in bad]
    # (all-f64 correction; this capacitance is ill-conditioned, which is why
    # it ships in f64, and amplifies the two packages' f64 rounding)
    assert _rel(got[good], ref[good]) <= 1e-10
    # the override rows are an f32 product (Abad_inv is kept in f32)
    assert _rel(got[bad], ref[bad]) <= 1e-6


def test_k6_accumulate_equals_sum_exactly(rbc_factorizations):
    _, _, _, tf = rbc_factorizations
    tbb = tf.banded
    rng = np.random.default_rng(33)
    R = torch.as_tensor(rng.standard_normal((tbb.blocks.G, tbb.P)))
    X = torch.as_tensor(rng.standard_normal((tbb.blocks.G, tbb.P)))
    want = X + tbb._once(tbb.arrs, R)
    got = tbb._once(tbb.arrs, R, accumulate=X.clone())
    assert torch.equal(got, want)
    # solve(accumulate=X) adds the refined solution
    want = X + tbb.solve(R)
    got = tbb.solve(R, accumulate=X.clone())
    assert torch.equal(got, want)


def test_k6_pre_twin_permutes_scales_pads_and_casts():
    rng = np.random.default_rng(34)
    G, P, Pp = 3, 10, 12
    R = rng.standard_normal((G, P))
    perm = rng.permutation(P)
    Dr = rng.random((G, Pp)) + 0.5
    got = tb.banded_solve_pre(torch.as_tensor(R), torch.as_tensor(perm), torch.as_tensor(Dr),
                              torch.float32)
    want = np.zeros((G, Pp))
    want[:, :P] = R[:, perm] * Dr[:, :P]
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, Pp)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# --- (d) K9: the residual and its norm ---

@pytest.mark.parametrize('form', ['inner', 'outer'])
def test_residual_norm_twin_matches_numpy(form):
    rng = np.random.default_rng(41)
    G, P = 7, 53
    R, Y0, Y1 = (rng.standard_normal((G, P)) for _ in range(3))
    rv = (rng.random((G, P)) > 0.2).astype(np.float64)
    t = torch.as_tensor
    if form == 'inner':
        scale = np.abs(R).max(axis=1)
        res, nrm = residual_norm(t(R), t(Y0), scale=t(scale))
        want = R - Y0
        want_n = (np.abs(want).max(axis=1) / scale).max()
    else:
        a, b = 1500.0, 1.0
        res, nrm = residual_norm(t(R), t(Y0), t(Y1), t(np.array([a, b])), t(rv))
        want = R - (a * Y0 + b * Y1) * rv
        want_n = (want * want).sum()
    assert res.dtype == torch.float64 and nrm.dim() == 0
    assert _rel(res.numpy(), want) <= 1e-15
    assert abs(float(nrm) - want_n) <= 1e-15 * abs(want_n)
    assert residual_norm.launches == 0          # CPU tensors take the twin
    res2, nrm2 = residual_norm_plain(t(R), t(Y0), scale=t(np.abs(R).max(axis=1)))
    assert torch.equal(res2, t(R - Y0))


# --- (c) K9: the two probes ---

def test_inner_probe_matches_reference(rbc_factorizations):
    _, _, jf, tf = rbc_factorizations
    ref = np.asarray(jf.banded._probe_refinement_curve())
    got = np.asarray(tf.banded._probe_refinement_curve())
    assert ref.shape == got.shape == (9,)
    # The first entries are the f32 direct solve's error in the worst group
    # (growth ~1e5 times f32 rounding): the two packages' f32 sweeps round
    # differently, so they agree within a decade, as the floor does
    for r, g in zip(ref, got):
        if r > 1e-9 or g > 1e-9:
            assert 0.1 <= g / r <= 10.0, (ref, got)
    assert 0.1 <= got.min() / ref.min() <= 10.0, (ref, got)
    # Above the plateau the rule resolves the same count; a target below it
    # is read off the plateau's noise (~1e-11 here) and may land one pass apart
    for target in (1e-10, 1e-8, 1e-6):
        assert tb.refinements_from_curve(got, target) == tb.refinements_from_curve(ref, target)
    assert abs(tb.refinements_from_curve(got, 1e-15)
               - tb.refinements_from_curve(ref, 1e-15)) <= 1


def test_outer_probe_matches_reference(rbc_factorizations):
    js, ts, jf, tf = rbc_factorizations
    old = (jf.banded.refinements, tf.banded.refinements)
    jf.banded.refinements = tf.banded.refinements = 3
    try:
        # the main factorization (a0 = 1.5/dt) serving the SBDF1 startup step (1/dt)
        ref = np.asarray(js.timestepper._probe_outer_curve(jf, 1000.0, 1.0))
        got = np.asarray(ts.timestepper._probe_outer_curve(tf, 1000.0, 1.0))
    finally:
        jf.banded.refinements, tf.banded.refinements = old
    assert abs(len(got) - len(ref)) <= 1, (ref, got)
    n = min(len(got), len(ref))
    for r, g in zip(ref[:n], got[:n]):
        if r > 1e-9 or g > 1e-9:
            assert 0.5 <= g / r <= 2.0, (ref, got)
    assert 0.1 <= got.min() / ref.min() <= 10.0, (ref, got)


# --- (e) the slice as a whole ---

def _jax_ic(ctx):
    b = ctx['b']
    z = ctx['dist'].local_grid(ctx['zbasis'], scale=1)
    Lz = ctx['Lz']
    b.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    b['g'] = np.array(b['g']) * z * (Lz - z) + (Lz - z)


@pytest.fixture(scope='module')
def cold_runs(overrides):
    """A cold run_steps(dt, 6) of RBC 32x16 in both packages: matsolver
    'banded' named, and the default matsolver with the dense stacks refused
    ([memory] max_dense_stack_gb = 0), which leaves the dense path by itself."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    from dedalus_tpu_torch.models.rbc import initial_condition
    tconfig.set('memory', 'max_dense_stack_gb', '0')
    out = {}
    for name, kw in (('named', dict(matsolver='banded')), ('default', {})):
        jp, jctx = jbuild(NX, NZ, Rayleigh=RA)
        js = jp.build_solver(jd3.SBDF2, **kw)
        _jax_ic(jctx)
        tp, tctx = tbuild(NX, NZ, Rayleigh=RA, device='cpu')
        ts = tp.build_solver(td3.SBDF2, **kw)
        initial_condition(tctx, seed=42)
        js.run_steps(DT, 6)
        ts.run_steps(DT, 6)
        out[name] = (js, ts)
    return out


@pytest.mark.parametrize('name', ['named', 'default'])
def test_cold_run_matches_reference(cold_runs, name):
    js, ts = cold_runs[name]
    ref = np.asarray(js.state_flat())
    got = ts.state_flat().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-11 * max(1.0, np.abs(ref).max())
    assert ts.iteration == js.iteration == 6


@pytest.mark.parametrize('name', ['named', 'default'])
def test_cold_run_builds_one_factorization(cold_runs, name):
    _, ts = cold_runs[name]
    stepper = ts.timestepper
    assert ts.matsolver == 'banded'
    assert ts.pencil.matrices.get('M') is None
    assert len(stepper._factorized) == 1
    a, b, _ = stepper.compute_coefficients([DT, DT], 2)
    assert list(stepper._factorized) == [(float(a[0]), float(b[0]))]
    # the SBDF1 startup step was served by outer refinement
    assert stepper._outer_for_key[(1.0 / DT, 1.0)] > 0


def test_cold_run_records_its_phases(cold_runs):
    for label in ('block extraction', 'equilibrate', 'factor (K8a)', 'W1 (K8b)',
                  'capacitance and Sinv', 'main factorization', 'outer probe', 'startup steps'):
        assert tb.phase_seconds.get(label, 0.0) > 0.0, label


# --- host setup at large Nz: O(N^2) forms equal to the dense longdouble products ---

@pytest.mark.parametrize('N,a0,b0,a1,b1', [(33, -0.5, -0.5, 0.5, 0.5), (20, -0.5, -0.5, 1.5, 1.5),
                                           (12, 0.0, 0.0, 1.0, 0.0), (2, -0.5, -0.5, 1.5, 1.5)])
def test_conversion_matrix_equals_dense_projection(N, a0, b0, a1, b1):
    import dedalus_tpu.spectral.jacobi as jj
    import dedalus_tpu_torch.spectral.jacobi as tj
    got = tj.conversion_matrix(N, a0, b0, a1, b1)
    # the dense quadrature projection, banded afterwards
    z, w = tj.quadrature(N + 1, a1, b1, dtype=tj.INTERNAL)
    P0 = tj.polynomials(N, a0, b0, z, dtype=tj.INTERNAL)
    P1 = tj.polynomials(N, a1, b1, z, dtype=tj.INTERNAL)
    dense = ((P1 * w) @ P0.T).astype(np.float64)
    band = np.triu(dense) - np.triu(dense, int(a1 - a0 + b1 - b0) + 1)
    np.testing.assert_array_equal(got.toarray(), band)
    np.testing.assert_array_equal(got.toarray(), jj.conversion_matrix(N, a0, b0, a1, b1).toarray())
    assert got.nnz == np.count_nonzero(band)


@pytest.mark.parametrize('size,a,scale', [(32, 0.5, 1.5), (17, 1.5, 1.0), (8, 1.5, 0.5)])
def test_forward_matrix_equals_dense_product(size, a, scale):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    import dedalus_tpu_torch.spectral.jacobi as tj
    tb_ = td3.Jacobi(td3.Coordinate('z'), size, (0, 1), a, a, a0=-0.5, b0=-0.5, dealias=1.5)
    jb_ = jd3.Jacobi(jd3.Coordinate('z'), size, (0, 1), a, a, a0=-0.5, b0=-0.5, dealias=1.5)
    got = tb_.forward_matrix(scale, np.float64)
    N = tb_.grid_size(scale)
    z, w = tj.quadrature(N, -0.5, -0.5, dtype=np.longdouble)
    proj = tj.polynomials(size, -0.5, -0.5, z, dtype=np.longdouble) * w
    proj[N:, :] = 0
    conv = tj.conversion_matrix(size, -0.5, -0.5, a, a)
    dense = (conv.toarray().astype(np.longdouble) @ proj).astype(np.float64)
    np.testing.assert_array_equal(got, dense)
    np.testing.assert_array_equal(got, np.asarray(jb_.forward_matrix(scale, np.float64)))


def test_component_selection_matrix(overrides):
    """The M and L stacks of RBC 32x16 (which select the components of u and
    of grad_u through Component) equal the reference's."""
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    js = jbuild(NX, NZ, Rayleigh=RA)[0].build_solver(jd3.SBDF2, matsolver='banded')
    ts = tbuild(NX, NZ, Rayleigh=RA, device='cpu')[0].build_solver(td3.SBDF2, matsolver='banded')
    for name in ('M', 'L'):
        for g in (0, 1, 7):
            ref = js.pencil.matrices_scipy[name][g].toarray()
            got = ts.pencil.matrices_scipy[name][g].toarray()
            np.testing.assert_array_equal(got, ref)


def test_equilibration_in_slabs_equals_whole_arrays(monkeypatch):
    """_equilibrate and _scaled go through slabs of groups on several host
    threads: the same values as over the whole arrays, and the reference's."""
    rng = np.random.default_rng(51)
    G, Nb, nb, nbord = 2 * tb.HOST_SLAB_G + 3, 5, 4, 2
    diag, sub, sup = (rng.standard_normal((G, Nb, nb, nb)) for _ in range(3))
    sub[:, 0] = 0
    sup[:, -1] = 0
    Ucol = rng.standard_normal((G, Nb * nb, nbord))
    Vrow = rng.standard_normal((G, nbord, Nb * nb))
    order = dict(n_border=nbord, bcol_first=False)
    solver = tb.BorderedBandedSolver
    blocks = tb.BandedBlocks(diag, sub, sup, Ucol, Vrow, order, nb, 0)
    Dr, Dc = solver._equilibrate(blocks)
    sb = solver._scaled(blocks, Dr, Dc)
    monkeypatch.setattr(tb, 'HOST_SLAB_G', G)
    Dr1, Dc1 = solver._equilibrate(blocks)
    sb1 = solver._scaled(blocks, Dr1, Dc1)
    jblocks = jb.BandedBlocks(diag, sub, sup, Ucol, Vrow, order, nb, 0)
    Drj, Dcj = jb.BorderedBandedSolver._equilibrate(jblocks)
    sbj = jb.BorderedBandedSolver._scaled(jblocks, Drj, Dcj)
    for got, whole, ref in ((Dr, Dr1, Drj), (Dc, Dc1, Dcj)) + tuple(
            (getattr(sb, k), getattr(sb1, k), getattr(sbj, k))
            for k in ('diag', 'sub', 'sup', 'Ucol', 'Vrow')):
        np.testing.assert_array_equal(got, whole)
        np.testing.assert_array_equal(got, np.asarray(ref))
