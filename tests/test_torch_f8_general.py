"""The banded solver past the shared-memory forms of K8a, K8b and K6 post
(ROADMAP fault F8): a bordered block-tridiagonal system at nb = 96 rows a
block and n_border = 180 (B = 360 Woodbury columns), which the port's
solver takes whole on the card through the general paths, against the JAX
package's _factor_device, _multi_rhs_solve_device and solve on the same
blocks; the plans' choices at and past the old limits; and the general
paths' arithmetic emulated at their own indices against the plain twins:
- K8a (csrc/banded_kernels.cu block_tridiag_qr_factor_kernel<GLOBAL>): a
  step's arrays in a workspace of k8_step_doubles(nb) a group, LAPACK's
  Householder conventions (dgeqr2/dlarfg signs, tau = 0 on a zero column),
  the pins against the running diagonal scale, R^-1 a column at a time;
- K8b (multi_rhs_solve_kernel): the k columns in chunks of kc, a block a
  (group, chunk), each entry's sums in j order: a chunked launch equals the
  one-chunk launch bit for bit;
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
    assert not tb.k8_plan(39)['general'] and tb.k8_plan(39)['smem'] == (19 * 39 ** 2 + 78) * 8
    for nb in (40, 64, 65, 96, 300):
        plan = tb.k8_plan(nb)
        assert plan == dict(general=True, smem=0, workspace=19 * nb * nb + 2 * nb)
    assert tb.k8_plan(19, general=True)['general']
    assert tb.k8_step_doubles(NBLK) == 2 * NBLK ** 2 + 4 * 4 * NBLK ** 2 + NBLK ** 2 + 2 * NBLK


def test_k8b_plan_chunks_and_unstaged_factors():
    per = tb.K5_SMEM // 8
    rbc = tb.k8b_plan(19, 26)
    assert rbc == dict(staged=True, kc=26, chunks=1, smem=(8 * 361 + 4 * 19 * 26) * 8,
                       general=False)
    wide = tb.k8b_plan(19, 400)
    assert wide['staged'] and wide['kc'] == (per - 8 * 361) // 76 and wide['chunks'] == 2
    assert wide['general'] and wide['smem'] <= tb.K5_SMEM
    assert tb.k8b_plan(60, 2)['staged'] and not tb.k8b_plan(61, 2)['staged']
    f8 = tb.k8b_plan(NBLK, 2 * NBORD)
    assert f8 == dict(staged=False, kc=per // (4 * NBLK), chunks=5,
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


# --- the general paths at their own indices ---

def emulate_k8a(diag, sub, sup, pin_tol=1e-8):
    """block_tridiag_qr_factor_kernel on the CPU: the step's arrays in one
    workspace of k8_step_doubles(nb) (A, Q twice, Pn, T, Ri, beta, dg at
    the kernel's offsets), Householder columns with LAPACK's conventions
    applied to A's later columns and to Q, the pins, R^-1 column by column
    bottom row up, T = Q^T Pn (Pn's upper right block skipped)."""
    Gd, Nb, nb, _ = diag.shape
    n2, bsz, m2 = 2 * nb, nb * nb, 4 * nb * nb
    out = dict(Qt=np.zeros((Gd, Nb - 1, n2, n2)), QtL=np.zeros((Gd, nb, nb)),
               Rinv=np.zeros((Gd, Nb, nb, nb)), R1=np.zeros((Gd, Nb, nb, nb)),
               R2=np.zeros((Gd, Nb, nb, nb)), pins=np.zeros((Gd, Nb, nb), bool),
               sigma=np.zeros((Gd, Nb, nb)))
    for g in range(Gd):
        ws = np.full(tb.k8_step_doubles(nb), np.nan)
        A_ = ws[:2 * bsz].reshape(n2, nb)
        Qa, Qb = ws[2 * bsz:2 * bsz + m2].reshape(n2, n2), ws[2 * bsz + m2:2 * bsz + 2 * m2]
        Pn = ws[2 * bsz + 2 * m2:2 * bsz + 3 * m2].reshape(n2, n2)
        T = ws[2 * bsz + 3 * m2:2 * bsz + 4 * m2].reshape(n2, n2)
        Ri = ws[2 * bsz + 4 * m2:3 * bsz + 4 * m2].reshape(nb, nb)
        beta = ws[3 * bsz + 4 * m2:3 * bsz + 4 * m2 + nb]
        dg = ws[3 * bsz + 4 * m2 + nb:]
        Qb = Qb.reshape(n2, n2)
        runmax = 0.0

        def qr(A, Q, m):
            for j in range(nb):
                x = A[j + 1:m, j]
                ss = float(x @ x)
                alpha = A[j, j]
                bj = alpha
                if ss != 0.0:
                    bj = -np.copysign(np.sqrt(alpha * alpha + ss), alpha)
                    tau = (bj - alpha) / bj
                    v = np.concatenate([[1.0], x / (alpha - bj)])
                    cols = np.concatenate([A[j:m, j + 1:], Q[j:m, :m]], axis=1)
                    cols -= np.outer(v, tau * (v @ cols))
                    A[j:m, j + 1:], Q[j:m, :m] = cols[:, :nb - j - 1], cols[:, nb - j - 1:]
                    A[j + 1:m, j] = x / (alpha - bj)
                beta[j] = bj

        def pin_and_invert(i, runmax):
            runmax = max(runmax, np.abs(beta).max())
            p = np.abs(beta) < pin_tol * max(runmax, 1e-300)
            out['pins'][g, i] = p
            out['sigma'][g, i] = np.where(p, runmax - beta, 0.0)
            dg[:] = beta + out['sigma'][g, i]
            for c in range(nb):
                Ri[c + 1:, c] = 0.0
                for r in range(c, -1, -1):
                    acc = (1.0 if r == c else 0.0) - A_[r, r + 1:c + 1] @ Ri[r + 1:c + 1, c]
                    Ri[r, c] = acc / dg[r]
            return runmax

        A_[:nb], A_[nb:] = diag[g, 0], sub[g, 1]
        Pn[:nb, :nb], Pn[:nb, nb:] = sup[g, 0], 0.0
        Pn[nb:, :nb], Pn[nb:, nb:] = diag[g, 1], sup[g, 1]
        Q, Qn = Qa, Qb
        Q[:] = np.eye(n2)
        for i in range(Nb - 1):
            qr(A_, Q, n2)
            runmax = pin_and_invert(i, runmax)
            T[:, :nb] = Q @ Pn[:, :nb]
            T[:, nb:] = Q[:, nb:] @ Pn[nb:, nb:]
            out['Qt'][g, i], out['Rinv'][g, i] = Q, Ri
            out['R1'][g, i], out['R2'][g, i] = T[:nb, :nb], T[:nb, nb:]
            A_[:nb], Pn[:nb, :nb] = T[nb:, :nb], T[nb:, nb:]
            if i + 2 < Nb:
                A_[nb:], Pn[nb:, :nb], Pn[nb:, nb:] = sub[g, i + 2], diag[g, i + 2], sup[g, i + 2]
            Q, Qn = Qn, Q
            Q[:] = np.eye(n2)
        Qs = Q[:nb, :nb]
        Qs[:] = np.eye(nb)
        qr(A_[:nb], Qs, nb)
        pin_and_invert(Nb - 1, runmax)
        out['QtL'][g], out['Rinv'][g, -1] = Qs, Ri
    return out


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


def emulate_k8b(qr, Rhs, kc):
    """multi_rhs_solve_kernel on the CPU, chunk by chunk: a chunk's block of
    right-hand sides read at the kernel's offsets (entry o = r * w + c of
    chunk c0 at r * k + c0 + c), each entry's sums in j order."""
    Qt, QtL, Rinv, R1, R2 = (qr[k].numpy() for k in tb.FACTOR_KEYS)
    Gd, Nb, nb, k = Rhs.shape
    flat = Rhs.reshape(Gd, Nb, nb * k)
    X = np.full(Rhs.shape, np.nan).reshape(Gd, Nb, nb * k)

    def prod(M, V):                       # sum_j M[r, j] V[j, c], in j order
        acc = np.zeros((M.shape[0], V.shape[1]))
        for j in range(M.shape[1]):
            acc = acc + M[:, j:j + 1] * V[j:j + 1, :]
        return acc

    for c0 in range(0, k, kc):
        w = min(kc, k - c0)
        at = np.array([(o // w) * k + c0 + o % w for o in range(nb * w)])
        for g in range(Gd):
            va = flat[g, 0, at].reshape(nb, w)
            for i in range(Nb - 1):
                out = prod(Qt[g, i], np.concatenate([va, flat[g, i + 1, at].reshape(nb, w)]))
                X[g, i, at] = out[:nb].reshape(-1)
                va = out[nb:]
            X[g, Nb - 1, at] = prod(QtL[g], va).reshape(-1)
            xa = xb = np.zeros((nb, w))
            for i in range(Nb - 1, -1, -1):
                t = (X[g, i, at].reshape(nb, w) - prod(R1[g, i], xa)) - prod(R2[g, i], xb)
                xn = prod(Rinv[g, i], t)
                X[g, i, at] = xn.reshape(-1)
                xa, xb = xn, xa
    return X.reshape(Rhs.shape)


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
