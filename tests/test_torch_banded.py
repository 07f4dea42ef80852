"""The banded solver of the PyTorch port against dedalus_tpu.ops.banded.

The kernels' plain twins (K5 sweeps, K4 exact applies, K7 history combine),
the torch f64 factorization, the full bordered solve on identical factors,
and pivot pinning. Everything runs on the CPU: the port's wrappers take
their plain twins for CPU tensors. Inputs are made with numpy from a seed
and handed to both packages.
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
from dedalus_tpu_torch.csrc.history_combine import history_combine
from dedalus_tpu_torch.utils.interop import banded_arrays_from_reference

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _random_blocks(G, Nb, nb, seed):
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((G, Nb, nb, nb)) + 4 * np.eye(nb)
    sub = rng.standard_normal((G, Nb, nb, nb))
    sub[:, 0] = 0
    sup = rng.standard_normal((G, Nb, nb, nb))
    sup[:, -1] = 0
    return diag, sub, sup


def _jax_blocks(diag, sub, sup):
    G, Nb, nb, _ = diag.shape
    P = Nb * nb
    order = dict(col_perm=np.arange(P), row_perm=np.arange(P), n_border=0,
                 n_core=P, bcol_first=False)
    return jb.BandedBlocks(diag, sub, sup, np.zeros((G, P, 0)),
                           np.zeros((G, 0, P)), order, nb, 0)


@pytest.mark.parametrize('G,Nb,nb', [(4, 6, 5), (4, 5, 19), (3, 1, 5)])
def test_k5_plain_matches_reference_sweeps(G, Nb, nb):
    diag, sub, sup = _random_blocks(G, Nb, nb, seed=1)
    qr = jb._factor_host(_jax_blocks(diag, sub, sup))
    keys = ('Qt', 'QtL', 'Rinv', 'R1', 'R2')
    f32 = [np.asarray(qr[k], dtype=np.float32) for k in keys]
    r = np.random.default_rng(2).standard_normal((G, Nb, nb)).astype(np.float32)
    ref = np.asarray(jb.block_tridiag_qr_solve(*map(jnp.asarray, f32), jnp.asarray(r)))
    got = tb.block_tridiag_qr_solve(*map(torch.as_tensor, f32), torch.as_tensor(r))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize('reference', ['host', 'device'])
@pytest.mark.parametrize('G,Nb,nb', [(4, 6, 5), (2, 4, 19)])
def test_torch_factorization_matches_reference(reference, G, Nb, nb):
    diag, sub, sup = _random_blocks(G, Nb, nb, seed=5)
    if reference == 'host':
        ref = jb._factor_host(_jax_blocks(diag, sub, sup))
    else:
        ref = {k: np.asarray(v) for k, v in jb._factor_device(
            jnp.asarray(diag), jnp.asarray(sub), jnp.asarray(sup)).items()}
    got = tb.factor_block_tridiag_qr(torch.as_tensor(diag), torch.as_tensor(sub),
                                     torch.as_tensor(sup))
    for k in ('Qt', 'QtL', 'Rinv', 'R1', 'R2', 'sigma'):
        assert _rel(got[k].numpy(), ref[k]) <= 1e-12 or np.abs(ref[k]).max() == 0, k
    np.testing.assert_array_equal(got['pins'].numpy(), ref['pins'])


@pytest.mark.parametrize('depth', [1, 2, 3, 4])
def test_k7_plain_matches_reference_combine(depth):
    """K7 over s-slot histories (newest first) against the JAX package's
    einsum form, with the uniform-step coefficients of the scheme of that
    depth."""
    import dedalus_tpu.core.timesteppers as jts
    scheme = {1: jts.SBDF1, 2: jts.SBDF2, 3: jts.SBDF3, 4: jts.SBDF4}[depth]
    rng = np.random.default_rng(9)
    G, R = 8, 37
    Fh, MXh, LXh = (rng.standard_normal((depth, G, R)) for _ in range(3))
    rv = rng.random((G, R)) > 0.2
    a, b, c = scheme.compute_coefficients([1e-3] * depth, depth)
    # CNAB's b is nonzero past slot 0: take it for b so every term counts
    b = b + np.arange(1, depth + 2) / 7
    ref = np.asarray((jnp.einsum('j,jgr->gr', c[1:], Fh)
                      - jnp.einsum('j,jgr->gr', a[1:], MXh)
                      - jnp.einsum('j,jgr->gr', b[1:], LXh)) * jnp.asarray(rv))
    t = torch.as_tensor
    coef = t(np.concatenate([a[1:], b[1:], c[1:]]), dtype=torch.float64)
    got = history_combine([t(f) for f in Fh], [t(m) for m in MXh], [t(x) for x in LXh],
                          t(rv.astype(np.float64)), coef)
    assert _rel(got.numpy(), ref) <= 1e-15


def test_k7_rejects_bad_depth_and_coefficients():
    t = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match='slots'):
        history_combine([t] * 5, [t] * 5, [t] * 5, t, torch.zeros(15, dtype=torch.float64))
    with pytest.raises(ValueError, match='slots'):
        history_combine([], [], [], t, torch.zeros(0, dtype=torch.float64))
    with pytest.raises(ValueError, match='coef'):
        history_combine([t] * 2, [t] * 2, [t] * 2, t, torch.zeros(6 + 1, dtype=torch.float64))


@pytest.fixture(scope='module', autouse=True)
def reference_refinement_rule():
    """This module compares resolved refinement counts with dedalus_tpu's:
    read them with its rule ([linear algebra] refinement_rule)."""
    old = tconfig.get('linear algebra', 'refinement_rule')
    tconfig.set('linear algebra', 'refinement_rule', 'reference')
    yield
    tconfig.set('linear algebra', 'refinement_rule', old)


# --- on the RBC 32x16 pencil of both packages ---

@pytest.fixture(scope='module')
def rbc_pencils():
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    old = (jconfig.get('memory', 'max_dense_stack_gb'),
           jconfig.get('matrix assembly', 'sampled_min_groups'),
           tconfig.get('matrix assembly', 'sampled_min_groups'))
    jconfig.set('memory', 'max_dense_stack_gb', '0')
    jconfig.set('matrix assembly', 'sampled_min_groups', '8')
    tconfig.set('matrix assembly', 'sampled_min_groups', '8')
    try:
        jp, _ = jbuild(32, 16, Rayleigh=1e5)
        tp, _ = tbuild(32, 16, Rayleigh=1e5, device='cpu')
        js = jp.build_solver(jd3.SBDF2, matsolver='banded')
        ts = tp.build_solver(td3.SBDF2, matsolver='banded')
        yield js.pencil, ts.pencil
    finally:
        jconfig.set('memory', 'max_dense_stack_gb', old[0])
        jconfig.set('matrix assembly', 'sampled_min_groups', old[1])
        tconfig.set('matrix assembly', 'sampled_min_groups', old[2])


def _pencil_X(pencil, seed):
    return np.random.default_rng(seed).standard_normal((pencil.G, pencil.R))


@pytest.mark.parametrize('name', ['M', 'L'])
def test_k4_separable_apply_matches_reference(rbc_pencils, name):
    jp, tp = rbc_pencils
    X = _pencil_X(jp, 3)
    jop = jp.banded_operator(name)
    ref = np.asarray(jop.apply_fn()(jop.arrs, jnp.asarray(X)))
    got = tp.banded_operator(name).apply(torch.as_tensor(X)).numpy()
    assert tp.banded_operator(name).bad_idx == jop.bad_idx
    assert _rel(got, ref) <= 1e-13


@pytest.mark.parametrize('name', ['M', 'L'])
def test_k4_per_group_apply_matches_reference(rbc_pencils, name):
    jp, tp = rbc_pencils
    X = _pencil_X(jp, 4)
    jop = jb.BandedOperator(jp.banded_stack(name))
    ref = np.asarray(jop.apply_fn()(jop.arrs, jnp.asarray(X)))
    got = tb.BandedOperator(tp.banded_stack(name), 'cpu').apply(torch.as_tensor(X)).numpy()
    assert _rel(got, ref) <= 1e-13


def test_k4_group_indexed_launch_overwrites_rows(rbc_pencils):
    _, tp = rbc_pencils
    op = tb.BandedOperator(tp.banded_stack('L'), 'cpu')
    xp = torch.nn.functional.pad(torch.as_tensor(_pencil_X(tp, 5))[:, op.col_perm],
                                 (0, op.pad))
    full = tb.banded_apply_plain(op.ops, xp)
    groups = torch.as_tensor([1, 4, 7])
    sub_ops = dict(op.ops)
    for key in ('diag', 'sub', 'sup', 'UcolT', 'Vrow'):
        if op.ops[key] is not None:
            sub_ops[key] = op.ops[key][:, groups].contiguous()
    sub_ops['Gs'] = 3
    out = torch.zeros_like(full)
    out = tb.banded_apply_plain(sub_ops, xp, groups=groups, out=out)
    np.testing.assert_array_equal(out[groups].numpy(), full[groups].numpy())
    assert not out[0].any()


@pytest.fixture(scope='module')
def factorizations(rbc_pencils):
    jp, tp = rbc_pencils
    coeffs = {'M': 1500.0, 'L': 1.0}
    jf = jsolve.FactorizedStack(JLazy(jp, coeffs), method='banded')
    tf = tsolve.FactorizedStack(TLazy(tp, coeffs), method='banded')
    return jf.banded, tf.banded


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


def test_bordered_solve_on_identical_factors(factorizations):
    jbb, tbb = factorizations
    assert tbb.refinements == jbb.refinements
    assert sorted(tbb.arrs['fac']) == sorted(jbb.fac)
    R = np.random.default_rng(6).standard_normal((jbb.blocks.G, jbb.P))
    ref = np.asarray(jbb.solve(jnp.asarray(R)))
    own = tbb.solve(torch.as_tensor(R)).numpy()
    tbb_arrs = tbb.arrs
    try:
        tbb.arrs = banded_arrays_from_reference(_reference_arrays(jbb))
        got = tbb.solve(torch.as_tensor(R)).numpy()
    finally:
        tbb.arrs = tbb_arrs
    assert _rel(got, ref) <= 1e-11
    assert _rel(own, ref) <= 1e-11


def test_factor_diagnostics_match_reference(factorizations):
    jbb, tbb = factorizations
    assert tbb.bad_idx == jbb.bad_idx
    np.testing.assert_allclose(tbb.diagnostics['growth'], jbb.diagnostics['growth'],
                               rtol=1e-4)
    np.testing.assert_allclose(tbb.diagnostics['condS'], jbb.diagnostics['condS'],
                               rtol=1e-6)


def _pinning_system():
    """The border-anchored kernel of tests/test_ivp.py:524."""
    rng = np.random.default_rng(3)
    nb, Nb, nbord = 4, 6, 1
    P = nb * Nb
    A = np.zeros((P, P))
    for i in range(Nb):
        r0 = i * nb
        A[r0:r0 + nb, r0:r0 + nb] = rng.normal(size=(nb, nb))
        if i > 0:
            A[r0:r0 + nb, r0 - nb:r0] = rng.normal(size=(nb, nb))
        if i < Nb - 1:
            A[r0:r0 + nb, r0 + nb:r0 + 2 * nb] = rng.normal(size=(nb, nb))
    A[0, :] = rng.normal(size=P)
    A[:, P - 1] = rng.normal(size=P)
    A[1:, 13] = -2.0 * A[1:, 12]
    A[0, 13] = 1.7
    order = dict(col_perm=np.arange(P), row_perm=np.arange(P),
                 n_border=nbord, n_core=P - nbord, bcol_first=False)
    return A, order, nb, rng


def test_pivot_pinning_repairs_border_anchored_kernel():
    A, order, nb, rng = _pinning_system()
    P = A.shape[0]
    blocks = tb.build_banded_blocks(None, None, None, order, nb, exact=[ss.csr_matrix(A)])

    def no_dense(g):
        raise AssertionError("pinning should repair without dense overrides")

    solver = tb.BorderedBandedSolver(blocks, 'cpu', refinements=6, group_dense=no_dense)
    assert not solver.bad_idx
    assert 'W1' in solver.arrs['fac']            # pins keep an f64 Woodbury
    R = rng.normal(size=(1, P))
    X = solver.solve(torch.as_tensor(R)).numpy()
    Xd = np.linalg.solve(A, R[0])
    assert np.abs(X[0] - Xd).max() < 1e-9 * max(1, np.abs(Xd).max())
    jblocks = jb.build_banded_blocks(None, None, None, order, nb, exact=[ss.csr_matrix(A)])
    jsolver = jb.BorderedBandedSolver(jblocks, refinements=6, group_dense=no_dense)
    Xj = np.asarray(jsolver.solve(jnp.asarray(R)))
    assert np.abs(X - Xj).max() < 1e-9 * max(1, np.abs(Xj).max())
