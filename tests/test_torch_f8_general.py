"""The banded solver past the shared-memory forms of K8a, K8b and K6 post
(ROADMAP fault F8): a bordered block-tridiagonal system at nb = 96 rows a
block and n_border = 180 (B = 360 Woodbury columns), which the port's
solver takes whole on the card through the general paths, against the JAX
package's _factor_device, _multi_rhs_solve_device and solve on the same
blocks; the plans' choices at and past the old limits; and the general
paths' arithmetic emulated at their own indices against the plain twins:
- K8a (csrc/banded_kernels.cu block_tridiag_qr_factor_kernel<GLOBAL>): a
  group's arrays in a workspace of k8_step_doubles(nb), the shared path's
  sums (test_torch_k8_plan.emulate_k8a: LAPACK's Householder conventions,
  dlarfg signs, tau = 0 on a zero column; the pins against the running
  diagonal scale, R^-1 a column at a time);
- K8b (multi_rhs_solve_kernel): the k columns in chunks of kc, a block a
  (group, chunk), each column's sums in the same tensor-core steps
  (test_torch_k8_plan.emulate_k8b): a chunked launch equals the one-chunk
  launch bit for bit;
- K6 post (banded_solve_post_kernel<SCRATCH>): s, t and the warps' partial
  sums in a scratch of (2 + K6_WARPS) B doubles a group, each warp's
  stretch of the pencil summed by its lanes in four strided partial sums,
  a xor tree, the warps' sums in warp order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import dedalus_tpu.ops.banded as jb

import dedalus_tpu_torch.ops.banded as tb
from test_torch_k8_plan import emulate_k8a, emulate_k8b

torch.set_num_threads(1)

G, NB, NBLK, NBORD, PAD = 2, 4, 96, 180, 12
EPS = np.finfo(np.float64).eps


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def f8_system(module, G=G, Nb=NB, nb=NBLK, nbord=NBORD, pad=PAD, seed=22):
    """A well-conditioned bordered block-tridiagonal system in banded
    coordinates (identity orderings), as `module`'s BandedBlocks, and its
    dense (G, P, P) operator A_band + U V (the smoke's f8_blocks)."""
    rng = np.random.default_rng(seed)
    Pp = Nb * nb
    P = Pp - pad
    r = lambda *shape: rng.standard_normal(shape)
    diag = 4 * np.eye(nb) + r(G, Nb, nb, nb) / np.sqrt(nb)
    sub = 0.5 * r(G, Nb, nb, nb) / np.sqrt(nb)
    sup = 0.5 * r(G, Nb, nb, nb) / np.sqrt(nb)
    sub[:, 0] = 0.0
    sup[:, -1] = 0.0
    Ucol = 0.5 * r(G, Pp, nbord) / np.sqrt(Pp)
    Vrow = 0.5 * r(G, nbord, Pp) / np.sqrt(Pp)
    last = slice(nb - pad, nb)
    diag[:, -1, last, :] = 0.0
    diag[:, -1, :, last] = 0.0
    diag[:, -1, last, last] = np.eye(pad)
    sub[:, -1, last, :] = 0.0
    sup[:, -2, :, last] = 0.0
    Ucol[:, P:] = 0.0
    Vrow[:, :, P:] = 0.0
    order = dict(row_perm=np.arange(P), col_perm=np.arange(P), n_border=nbord,
                 n_core=P - nbord, bcol_first=False)
    blocks = module.BandedBlocks(diag, sub, sup, Ucol, Vrow, order, nb, pad)
    A = np.zeros((G, Pp, Pp))
    for i in range(Nb):
        s = slice(i * nb, (i + 1) * nb)
        A[:, s, s] = diag[:, i]
        if i > 0:
            A[:, s, (i - 1) * nb:i * nb] = sub[:, i]
        if i < Nb - 1:
            A[:, s, (i + 1) * nb:(i + 2) * nb] = sup[:, i]
    A[:, :nbord, :] += Vrow
    A[:, :, P - nbord:P] += Ucol
    return blocks, A[:, :P, :P]


@pytest.fixture(scope='module')
def solvers():
    def no_dense(g):
        raise AssertionError("no dense override expected")

    tblocks, A = f8_system(tb)
    jblocks, _ = f8_system(jb)
    tbb = tb.BorderedBandedSolver(tblocks, 'cpu', refinements=4, group_dense=no_dense)
    jbb = jb.BorderedBandedSolver(jblocks, refinements=4, group_dense=no_dense)
    return tbb, jbb, A


# --- the plans at and past the old limits ---

def test_k8a_plan_at_and_past_its_shared_path():
    assert not tb.k8_plan(39)['general'] and tb.k8_plan(39)['smem'] == (18 * 39 ** 2 + 7 * 39) * 8
    for nb in (40, 64, 65, 96, 300):
        plan = tb.k8_plan(nb)
        assert plan['general'] and plan['smem'] == 0
        assert plan['workspace'] == 18 * nb * nb + 7 * nb
    assert tb.k8_plan(19, general=True)['general']
    assert tb.k8_step_doubles(NBLK) == (3 * (2 * NBLK ** 2 + 2 * NBLK) + 2 * 4 * NBLK ** 2
                                        + NBLK ** 2 + NBLK + 3 * NBLK ** 2)


def test_k8b_plan_chunks_and_unstaged_factors():
    per = tb.K5_SMEM // 8
    rbc = tb.k8b_plan(19, 26)
    assert rbc['staged'] and rbc['kc'] == 26 and rbc['chunks'] == 1 and not rbc['general']
    assert rbc['smem'] == (rbc['slots'] * (4 * 361 + 19 * 26) + 4 * 19 * 26) * 8
    wide = tb.k8b_plan(19, 400)
    assert wide['staged'] and wide['kc'] == tb.K8B_MAX_COLS and wide['chunks'] == 4
    assert wide['general'] and wide['smem'] <= tb.K5_SMEM
    assert tb.k8b_plan(59, 2)['staged'] and not tb.k8b_plan(60, 2)['staged']
    f8 = tb.k8b_plan(NBLK, 2 * NBORD)
    assert f8 == dict(staged=False, kc=per // (4 * NBLK), chunks=5, slots=0,
                      smem=4 * NBLK * (per // (4 * NBLK)) * 8, general=True)
    assert tb.k8b_plan(7264, 1)['kc'] == 1
    with pytest.raises(ValueError, match='nb=7265'):
        tb.k8b_plan(7265, 1)


def test_k6_plan_opt_in_and_scratch():
    assert tb.k6_plan(26) == dict(scratch=False, doubles=18 * 26, smem=18 * 26 * 8,
                                  general=False)
    assert not tb.k6_plan(341)['general'] and tb.k6_plan(342)['general']
    assert not tb.k6_plan(1614)['scratch'] and tb.k6_plan(1614)['smem'] <= tb.K5_SMEM
    assert tb.k6_plan(1615) == dict(scratch=True, doubles=18 * 1615, smem=0, general=True)
    assert tb.k6_plan(2 * NBORD)['general'] and not tb.k6_plan(2 * NBORD)['scratch']


def test_solver_limits_past_f8():
    """Nothing of F8's limits is left below K8b's and K5's vectors: the
    sizes the old limits refused build; past nb = 7264 the error names nb
    and n_border. At nb > 84 the f32 factors take K5's direct path."""
    for nb, nbord in ((40, 13), (96, 180), (19, 200), (300, 2000)):
        tb.banded_card_limits(nb, nbord)
    with pytest.raises(ValueError, match=r'nb=7265, n_border=3'):
        tb.banded_card_limits(7265, 3)
    assert tb.k5_plan(NBLK, 4)['direct'] and not tb.k5_plan(84, 4)['direct']


# --- the solver at F8's sizes against the JAX package ---

def test_factorization_matches_reference_factor_device():
    blocks, _ = f8_system(tb, seed=24)
    dsu = [torch.as_tensor(a) for a in (blocks.diag, blocks.sub, blocks.sup)]
    got = tb.factor_block_tridiag_qr(*dsu)
    ref = jb._factor_device(*(jnp.asarray(a) for a in (blocks.diag, blocks.sub, blocks.sup)))
    growth = float(got['Rinv'].abs().max())
    for key in ('Qt', 'R1', 'R2'):
        assert _rel(got[key].numpy(), np.asarray(ref[key])) <= 1e-11, key
    for key in ('Rinv', 'QtL'):
        assert _rel(got[key].numpy(), np.asarray(ref[key])) <= max(1e-11, 10 * EPS * growth)
    assert np.array_equal(got['pins'].numpy(), np.asarray(ref['pins']))


def test_multi_rhs_solve_matches_reference():
    blocks, _ = f8_system(tb, seed=25)
    dsu = [torch.as_tensor(a) for a in (blocks.diag, blocks.sub, blocks.sup)]
    qr = tb.factor_block_tridiag_qr(*dsu)
    Rhs = np.random.default_rng(26).standard_normal((G, NB, NBLK, 2 * NBORD))
    ref = np.asarray(jb._multi_rhs_solve_device(
        *(jnp.asarray(qr[k].numpy()) for k in tb.FACTOR_KEYS), jnp.asarray(Rhs)))
    assert _rel(tb.multi_rhs_solve(qr, torch.as_tensor(Rhs)).numpy(), ref) <= 1e-12


def test_solve_matches_reference_and_dense(solvers):
    tbb, jbb, A = solvers
    assert tbb.arrs['fac']['Sinv'].shape[1] == 2 * NBORD
    R = np.random.default_rng(27).standard_normal((G, tbb.P))
    got = tbb.solve(torch.as_tensor(R)).numpy()
    ref = np.asarray(jbb.solve(jnp.asarray(R)))
    dense = np.linalg.solve(A, R[..., None])[..., 0]
    assert _rel(got, ref) <= 1e-11
    assert _rel(got, dense) <= 1e-11


def test_solver_factors_in_chunks_of_factor_chunk_g(monkeypatch):
    """The solver's f64 factorization runs FACTOR_CHUNK_G groups a launch
    of K8a and K8b (the last chunk shorter); each group's factors and
    solves are those of one whole launch, bit for bit."""
    blocks, _ = f8_system(tb, G=5, Nb=3, nb=8, nbord=4, pad=2, seed=32)
    R = torch.as_tensor(np.random.default_rng(33).standard_normal((5, blocks.Pp - 2)))
    whole = tb.BorderedBandedSolver(f8_system(tb, G=5, Nb=3, nb=8, nbord=4, pad=2, seed=32)[0],
                                    'cpu', refinements=2)
    chunks = []
    factor = tb.factor_block_tridiag_qr
    monkeypatch.setattr(tb, 'FACTOR_CHUNK_G', 2)
    monkeypatch.setattr(tb, 'factor_block_tridiag_qr',
                        lambda *a, **kw: chunks.append(a[0].shape[0]) or factor(*a, **kw))
    chunked = tb.BorderedBandedSolver(blocks, 'cpu', refinements=2)
    assert chunks[:3] == [2, 2, 1]
    for key, t in whole.arrs['fac'].items():
        if torch.is_tensor(t):
            assert torch.equal(chunked.arrs['fac'][key], t), key
    assert torch.equal(chunked.solve(R), whole.solve(R))


# --- the general paths at their own indices ---

def test_k8a_general_emulation_against_twin():
    blocks, _ = f8_system(tb, G=1, Nb=3, nb=48, nbord=20, pad=5, seed=28)
    got = emulate_k8a(blocks.diag, blocks.sub, blocks.sup)
    twin = tb.factor_block_tridiag_qr_plain(
        *(torch.as_tensor(a) for a in (blocks.diag, blocks.sub, blocks.sup)))
    growth = float(twin['Rinv'].abs().max())
    for key in ('Qt', 'R1', 'R2', 'sigma'):
        assert _rel(got[key], twin[key].numpy()) <= 1e-11, key
    for key in ('Rinv', 'QtL'):
        assert _rel(got[key], twin[key].numpy()) <= max(1e-11, 10 * EPS * growth), key
    assert np.array_equal(got['pins'], twin['pins'].numpy())


def test_k8b_chunks_emulation_against_twin():
    blocks, _ = f8_system(tb, G=2, Nb=3, nb=12, nbord=9, pad=2, seed=29)
    qr = tb.factor_block_tridiag_qr(*(torch.as_tensor(a) for a in (
        blocks.diag, blocks.sub, blocks.sup)))
    Rhs = np.random.default_rng(30).standard_normal((2, 3, 12, 18))
    one = emulate_k8b(qr, Rhs, 18)
    for kc in (7, 5, 1):
        assert np.array_equal(emulate_k8b(qr, Rhs, kc), one)
    assert _rel(one, tb.multi_rhs_solve(qr, torch.as_tensor(Rhs)).numpy()) <= 1e-12


def emulate_k6_post(fac, y, Dc, col_perm, P, accumulate=None):
    """banded_solve_post_kernel (all-f64 Woodbury) on the CPU: s, t and the
    warps' partial sums in the scratch's (2 + K6_WARPS) B slots of a group;
    warp w's stretch of the pencil, each lane four strided partial sums and
    a tail, met by the xor tree; the warps in order; t = Sinv s; x = y - W1
    t; X[col_perm] = x Dc (added to `accumulate`)."""
    Sinv, V, W = (fac[k].numpy() for k in ('Sinv', 'Vfull', 'W1'))
    Gd, Pp = y.shape
    B = Sinv.shape[1]
    nw = tb.K6_WARPS
    X = np.zeros((Gd, P)) if accumulate is None else accumulate.copy()
    for g in range(Gd):
        scratch = np.full((2 + nw) * B, np.nan)
        s, t, part = scratch[:B], scratch[B:2 * B], scratch[2 * B:].reshape(nw, B)
        chunk = -(-Pp // nw)
        for w_ in range(nw):
            p0, p1 = w_ * chunk, min(Pp, (w_ + 1) * chunk)
            lanes = []
            for lane in range(32):
                a = [np.zeros(B) for _ in range(4)]
                p = p0 + lane
                while p + 96 < p1:
                    for q in range(4):
                        a[q] = a[q] + V[g, :, p + 32 * q] * y[g, p + 32 * q]
                    p += 128
                while p < p1:
                    a[0] = a[0] + V[g, :, p] * y[g, p]
                    p += 32
                lanes.append((a[0] + a[1]) + (a[2] + a[3]))
            lanes = np.array(lanes)
            for off in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[np.arange(32) ^ off]
            part[w_] = lanes[0]
        s[:] = 0.0
        for w_ in range(nw):
            s[:] = s + part[w_]
        t[:] = 0.0
        for c in range(B):
            t[:] = t + Sinv[g, :, c] * s[c]
        corr = np.zeros(Pp)
        for b in range(B):
            corr = corr + W[g, :, b] * t[b]
        x = (y[g] - corr)[:P] * Dc[g, :P]
        X[g, col_perm] = X[g, col_perm] + x if accumulate is not None else x
    return X


@pytest.mark.parametrize('accumulate', [False, True])
def test_k6_scratch_emulation_against_twin(accumulate):
    rng = np.random.default_rng(31)
    Gd, Pp, P, B = 2, 480, 468, 2 * NBORD
    Sinv = np.eye(B) + 0.1 / np.sqrt(B) * rng.standard_normal((Gd, B, B))
    fac = dict(Sinv=torch.as_tensor(Sinv),
               Vfull=torch.as_tensor(rng.standard_normal((Gd, B, Pp)) / np.sqrt(Pp)),
               W1=torch.as_tensor(rng.standard_normal((Gd, B, Pp)) / np.sqrt(Pp)).transpose(1, 2))
    y = rng.standard_normal((Gd, Pp))
    Dc = 1.0 + rng.random((Gd, Pp))
    perm = rng.permutation(P)
    unperm = np.argsort(perm)
    X0 = rng.standard_normal((Gd, P)) if accumulate else None
    got = emulate_k6_post(fac, y, Dc, perm, P, X0)
    twin = tb.banded_solve_post_plain(fac, torch.as_tensor(y), torch.as_tensor(Dc),
                                      torch.as_tensor(unperm), P,
                                      accumulate=None if X0 is None else torch.as_tensor(X0))
    assert _rel(got, twin.numpy()) <= 1e-13
