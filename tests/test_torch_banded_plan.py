"""K4's launch plan (dedalus_tpu_torch/ops/banded.py k4_plan and its
fragment packing), emulated in numpy block by block at the kernel's own
indices, against the plain twin; and the fused forms' twins against the
composition the port ran before them.

csrc/banded_kernels.cu `banded_apply_kernel` runs only on the card. Its
arithmetic is the host plan's: the x windows staged through col_perm, the
32-lane fragments of the 16x8x4 f64 products (A: lane l holds groups
l // 4 and l // 4 + 8, column l % 4; B: k = l % 4, n = l // 4; D: those
groups, rows 2 (l % 4) + h), the exceptional-group table, the pivot table, the border rows'
partial slots and their fixed order of addition, the stores through
row_perm. `emulate` walks the same blocks with the same index arithmetic on
the CPU, so a wrong index, a missing row or a row written twice shows here.
The JAX-held checks of the twin itself are tests/test_torch_banded.py.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu_torch.public as d3
import dedalus_tpu_torch.ops.banded as tb
from dedalus_tpu_torch.models.rbc import build_rbc_problem, initial_condition
from dedalus_tpu_torch.ops import solve as tsolve
from dedalus_tpu_torch.core.subsystems import LazyCombined
from dedalus_tpu_torch.utils.config import config

torch.set_num_threads(1)

TOL = 1e-13


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _dmma(A_lane, B_lane):
    """The 8-row half of an m16n8k4 f64 product for each m-tile, from the
    lanes' operands:
    A_lane (..., 32) -> A[m, k] = A_lane[4 m + k]; B_lane (32,) ->
    B[k, n] = B_lane[4 n + k]. Returns D (..., 8, 8)."""
    A = A_lane.reshape(A_lane.shape[:-1] + (8, 4))
    B = B_lane.reshape(8, 4).T
    return A @ B


def emulate(aset, X, coefs=None, pair=False, R=None, rv=None, pivots=False):
    """K4's launch on the CPU: every block of the plan in turn, the
    border-row reduction by the tile's last contributor in its fixed order.
    Returns the outputs as the kernel stores them (NaN where none is)."""
    dp = aset.device_plan(pair, pivots, torch.device('cpu'))
    p = dp['plan']
    n = len(aset.ops)
    coefs = (1.0,) * n if coefs is None else tuple(float(c) for c in coefs)
    GT = tb.K4_GT
    G, P, Nb, nb, nbord, bcol0 = (p[k] for k in ('G', 'P', 'Nb', 'nb', 'nbord', 'bcol0'))
    BR, nchunks, nv, vks, KSV, W = (p[k] for k in ('BR', 'nchunks', 'nv', 'vks', 'KSV', 'W'))
    KB, KU, NT, NTV, nout = (p[k] for k in ('KB', 'KU', 'NT', 'NTV', 'nout'))
    KS, XB, YR = 3 * KB + KU, 4 * KU, max(nb, nbord)
    ntiles = p['ntiles']
    Xn = X.numpy()
    Rn = None if R is None else R.numpy()
    rvn = None if rv is None else rv.numpy()
    cp, rp = dp['col_perm'].numpy(), dp['row_perm'].numpy()
    bad_off, bad = dp['bad_off'].numpy(), dp['bad'].numpy()
    piv_off, piv = dp['piv_off'].numpy(), dp['piv'].numpy()
    terms = []
    for k, (t, a) in enumerate(zip(dp['terms'], dp['arrays'])):
        sh, grp = t['shared'], t['group']
        np_ = lambda v: None if v is None else v.numpy().ravel()
        terms.append(dict(
            band=np_(a.get('band')), border=np_(a.get('border')),
            w=None if t['w'] is None else t['w'].numpy().ravel(),
            nparts=0 if sh is None else sh['nparts'],
            mask=None if sh is None else {m: sh['mask_' + m] for m in
                                          ('sub', 'sup', 'UcolT', 'Vrow')},
            gdiag=None if grp is None else grp['diag'][0].numpy(),
            gsub=None if grp is None or grp['sub'] is None else grp['sub'][0].numpy(),
            gsup=None if grp is None or grp['sup'] is None else grp['sup'][0].numpy(),
            gU=None if grp is None or grp['UcolT'] is None else grp['UcolT'][0].numpy(),
            gV=np_(a.get('group_border')), coef=coefs[k], out=p['outs'][k]))
    Y = [np.full((G, P), np.nan) for _ in range(nout)]
    partial = np.full((nout, ntiles, nv + 1, GT, nbord), np.nan)
    stored = np.zeros((nout, G, P), dtype=int)
    # (warp, m-tile, lane) -> the lane's group in the tile and its quad
    lane = np.arange(32)
    lq, lm = lane % 4, lane // 4
    warp = np.arange(tb.K4_WARPS)[:, None, None]
    mt = np.arange(tb.K4_MTILES)[None, :, None]
    grow = warp * 8 * tb.K4_MTILES + mt * 8 + lm                 # (warps, mtiles, 32)

    def weights(T, g0):
        g = g0 + grow
        wc = np.zeros((tb.K4_MAXP,) + grow.shape)
        for pp in range(T['nparts']):
            wc[pp] = np.where(g < G, T['coef'] * T['w'][np.minimum(g, G - 1) * T['nparts'] + pp],
                              0.0)
        return wc

    def store(o, g, j, v):
        at = g * P + rp[j]
        if rvn is not None:
            v = v * rvn.ravel()[at]
        if Rn is not None:
            v = Rn.ravel()[at] - v
        Y[o].ravel()[at] = v
        stored[o].ravel()[at] += 1

    def add_pivots(t, slot, j0, cnt, y, off, stride):
        s = t * (nchunks + 1) + slot
        for e in range(piv_off[s], piv_off[s + 1]):
            gl, j, col = piv[e, :3]
            if j0 <= j < j0 + cnt:
                y.ravel()[off + gl * stride + (j - j0)] += Xn[t * GT + gl, col]

    def band_unit(t, c):
        i0, i1 = c * BR, min(c * BR + BR, Nb)
        g0, win0 = t * GT, (i0 - 1) * nb
        xs = np.zeros(GT * W)
        for k in range(GT * W):
            gl, j = k // W, win0 + k % W
            if g0 + gl < G and 0 <= j < P:
                xs[k] = Xn[g0 + gl, cp[j]]
        xb = np.zeros(GT * XB)
        for k in range(GT * XB):
            gl, cc = k // XB, k % XB
            if g0 + gl < G and cc < nbord:
                xb[k] = Xn[g0 + gl, cp[bcol0 + cc]]
        recs = bad[bad_off[t]:bad_off[t + 1]]
        for i in range(i0, i1):
            ys = np.zeros(nout * GT * YR)
            for o in range(nout):
                acc = np.zeros(grow.shape[:2] + (8, 8 * tb.K4_MAXNT))
                for T in terms:
                    if T['out'] != o or T['band'] is None:
                        continue
                    wc = weights(T, g0)
                    base = i * T['nparts'] * KS * NT * 32 + lane
                    steps = [(q, ks, (i - i0 + q) * nb + ks * 4 + lq, xs, W,
                              lambda pp, q=q: q == 1 or T['mask'][('sub', None, 'sup')[q]] >> pp & 1,
                              q * KB + ks)
                             for q in range(3) if not ((q == 0 and i == 0) or (q == 2 and i == Nb - 1))
                             for ks in range(KB)]
                    steps += [(3, ku, ku * 4 + lq, xb, XB,
                               lambda pp: T['mask']['UcolT'] >> pp & 1, 3 * KB + ku)
                              for ku in range(KU)]
                    for q, ks, col, src, stride, present, s in steps:
                        xa = src[grow * stride + col]
                        for pp in range(T['nparts']):
                            if not present(pp):
                                continue
                            for nt in range(NT):
                                b = T['band'][base + ((pp * KS + s) * NT + nt) * 32]
                                acc[:, :, :, nt * 8:nt * 8 + 8] += _dmma(xa * wc[pp], b)
                for h in range(2):
                    for nt in range(NT):
                        r = nt * 8 + 2 * lq + h
                        keep = r < nb
                        ys[((o * GT + grow) * YR + r)[..., keep]] = acc[
                            :, :, lm[keep], nt * 8 + 2 * lq[keep] + h]
            for k in range(len(recs) * nb):
                e, r = k // nb, k % nb
                gl = recs[e, 0]
                xw = gl * W + (i - i0) * nb
                for kt, T in enumerate(terms):
                    b = recs[e, 1 + kt]
                    if b < 0:
                        continue
                    s = T['gdiag'][b, i, r] @ xs[xw + nb:xw + 2 * nb]
                    if T['gsub'] is not None and i > 0:
                        s += T['gsub'][b, i, r] @ xs[xw:xw + nb]
                    if T['gsup'] is not None and i < Nb - 1:
                        s += T['gsup'][b, i, r] @ xs[xw + 2 * nb:xw + 3 * nb]
                    if T['gU'] is not None:
                        s += T['gU'][b, :, i * nb + r] @ xb[gl * XB:gl * XB + nbord]
                    ys[(T['out'] * GT + gl) * YR + r] += T['coef'] * s
            j0 = max(i * nb, nbord)
            add_pivots(t, c, j0, (i + 1) * nb - j0, ys, max(nbord - i * nb, 0), YR)
            for k in range(GT * nb):
                gl, r = k // nb, k % nb
                g, j = g0 + gl, i * nb + r
                if g >= G or j >= P:
                    continue
                for o in range(nout):
                    v = ys[(o * GT + gl) * YR + r]
                    if j < nbord:
                        partial[o, t, nv, gl, j] = v
                    else:
                        store(o, g, j, v)

    def border_unit(t, v):
        g0 = t * GT
        ks0, ks1 = v * vks, min(v * vks + vks, KSV)
        for o in range(nout):
            acc = np.zeros(grow.shape[:2] + (8, 8 * tb.K4_MAXNT))
            for T in terms:
                if T['out'] != o or T['border'] is None:
                    continue
                wc = weights(T, g0)
                g = g0 + grow
                for ks in range(ks0, ks1):
                    col = ks * 4 + lq
                    xa = np.where((g < G) & (col < P),
                                  Xn[np.minimum(g, G - 1), np.minimum(col, P - 1)], 0.0)
                    for pp in range(T['nparts']):
                        if not T['mask']['Vrow'] >> pp & 1:
                            continue
                        for nt in range(NTV):
                            b = T['border'][((pp * KSV + ks) * NTV + nt) * 32 + lane]
                            acc[:, :, :, nt * 8:nt * 8 + 8] += _dmma(xa * wc[pp], b)
            for h in range(2):
                for nt in range(NTV):
                    r = nt * 8 + 2 * lq + h
                    keep = r < nbord
                    partial[o, t, v].ravel()[(grow * nbord + r)[..., keep]] = acc[
                        :, :, lm[keep], nt * 8 + 2 * lq[keep] + h]
        c0, c1 = ks0 * 4, min(ks1 * 4, P)
        recs = bad[bad_off[t]:bad_off[t + 1]]
        for k in range(len(recs) * nbord):
            e, r = k // nbord, k % nbord
            gl = recs[e, 0]
            for kt, T in enumerate(terms):
                b = recs[e, 1 + kt]
                if b < 0 or T['gV'] is None:
                    continue
                vr = T['gV'][(b * nbord + r) * P:(b * nbord + r + 1) * P]
                partial[T['out'], t, v, gl, r] += T['coef'] * (vr[c0:c1] @ Xn[g0 + gl, c0:c1])

    def finish(t):
        fin = partial[:, t, nv].copy()
        for v in range(nv):
            fin += partial[:, t, v]
        add_pivots(t, nchunks, 0, nbord, fin, 0, nbord)
        for gl in range(GT):
            for j in range(nbord):
                g = t * GT + gl
                if g < G and j < P:
                    for o in range(nout):
                        store(o, g, j, fin[o, gl, j])

    arrived = np.zeros(ntiles, dtype=int)
    for b in range(p['blocks']):
        kind, t, u = tb.k4_block(p, b)
        if kind == 'border':
            border_unit(t, u)
        else:
            band_unit(t, u)
            if u != 0:
                continue
        arrived[t] += 1
        if arrived[t] == nv + 1:
            finish(t)
    assert (arrived == nv + 1).all()
    assert (stored == 1).all(), "an output element stored other than once"
    return tuple(Y) if pair else Y[0]


def _holds(aset, X, **kw):
    got = emulate(aset, X, **kw)
    ref = tb.banded_apply_plain_set(aset, X, **kw)
    for g, r in zip(got if kw.get('pair') else (got,), ref if kw.get('pair') else (ref,)):
        assert np.isfinite(g).all()
        assert _rel(g, r.numpy()) <= TOL


@pytest.fixture(scope='module')
def rbc():
    """RBC 64x32 banded (the separable M and L with their exceptional group
    kx = 0 and weights, the step factorization's pivot pairs)."""
    old = config.get('memory', 'max_dense_stack_gb')
    config.set('memory', 'max_dense_stack_gb', '0')
    try:
        problem, ctx = build_rbc_problem(64, 32, Rayleigh=1e5, device='cpu')
        solver = problem.build_solver(d3.SBDF2, matsolver='banded')
        initial_condition(ctx, seed=42)
        pencil = solver.pencil
        bM, bL = pencil.banded_operator('M'), pencil.banded_operator('L')
        fact = tsolve.FactorizedStack(LazyCombined(pencil, {'M': 1500.0, 'L': 1.0}),
                                      method='banded')
        yield pencil, bM, bL, fact
    finally:
        config.set('memory', 'max_dense_stack_gb', old)


def _rng_pencils(pencil, seed, n=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((pencil.G, pencil.R))) for _ in range(n)]


@pytest.mark.parametrize('form', ['M', 'L', 'pair', 'outer', 'exact', 'residual'])
def test_k4_plan_emulation_matches_twin_rbc(rbc, form):
    pencil, bM, bL, fact = rbc
    assert bM.bad_idx and bL.bad_idx and bM.w.shape[1] == 2 and bL.w.shape[1] == 3
    X, R = _rng_pencils(pencil, 3, 2)
    rv = pencil.row_valid_dev
    ml = tb.BandedApplySet([bM, bL])
    if form in ('M', 'L'):
        _holds(tb.BandedApplySet([bM if form == 'M' else bL]), X)
    elif form == 'pair':
        _holds(ml, X, pair=True)
    elif form == 'outer':
        _holds(ml, X, coefs=(1000.0, 1.0), R=R, rv=rv)
    else:
        aset = fact.apply_set
        assert aset.pivots is not None and len(aset.pivots[0]) > pencil.G
        _holds(aset, X, coefs=(1500.0, 1.0), pivots=True,
               R=R if form == 'residual' else None)


def test_k4_plan_emulation_per_group_blocks(rbc):
    """Gs == G (BandedOperator: every group through its own blocks), alone
    and as a pair."""
    pencil = rbc[0]
    X = _rng_pencils(pencil, 5)[0]
    ops = [tb.BandedOperator(pencil.banded_stack(name), 'cpu') for name in ('M', 'L')]
    assert ops[1].ops['Gs'] == pencil.G
    _holds(tb.BandedApplySet(ops[1:]), X)
    _holds(tb.BandedApplySet(ops), X, pair=True)


def test_k4_plan_emulation_banded_lbvp():
    """The banded Poisson LBVP (examples/lbvp_2d_poisson.py at 64x32): L
    alone with its pivot pairs (half of kx = 0 is invalid) and the
    refinement residual; nb = 4, so one n-tile carries 4 rows."""
    old = config.get('memory', 'max_dense_stack_gb')
    config.set('memory', 'max_dense_stack_gb', '0')
    try:
        coords = d3.CartesianCoordinates('x', 'y')
        dist = d3.Distributor(coords, dtype=np.float64, device='cpu')
        xb = d3.RealFourier(coords['x'], size=64, bounds=(0, 2 * np.pi))
        yb = d3.ChebyshevT(coords['y'], size=32, bounds=(0, np.pi))
        u = dist.Field(name='u', bases=(xb, yb))
        t1, t2 = dist.Field(name='t1', bases=xb), dist.Field(name='t2', bases=xb)
        f = dist.Field(name='f', bases=(xb, yb))
        lift = lambda A, n: d3.Lift(A, yb.derivative_basis(2), n)
        dy = lambda A: d3.Differentiate(A, coords['y'])
        problem = d3.LBVP([u, t1, t2], namespace=locals())
        problem.add_equation("lap(u) + lift(t1,-1) + lift(t2,-2) = f")
        problem.add_equation("u(y=0) = 0")
        problem.add_equation("dy(u)(y=3.141592653589793) = 0")
        solver = problem.build_solver(matsolver='banded')
        pencil = solver.pencil
        fact = tsolve.FactorizedStack(LazyCombined(pencil, {'L': 1.0}), method='banded')
    finally:
        config.set('memory', 'max_dense_stack_gb', old)
    aset = fact.apply_set
    assert aset.ops[0].ops['nb'] == 4 and aset.pivots is not None
    X, R = _rng_pencils(pencil, 7, 2)
    _holds(aset, X, coefs=(1.0,), pivots=True)
    _holds(aset, X, coefs=(1.0,), pivots=True, R=R)


def test_k4_plan_tables(rbc):
    """The plan's tables: every pivot pair once in the slot of its row, the
    exceptional groups of both operators, border rows within band unit 0,
    partial slots in the reduction order the docstring gives."""
    pencil, bM, bL, fact = rbc
    aset = fact.apply_set
    dp = aset.device_plan(False, True, torch.device('cpu'))
    p = dp['plan']
    assert p['BR'] * p['nb'] >= p['nbord'] and p['nv'] * p['vks'] >= p['KSV']
    assert p['blocks'] == p['ntiles'] * (p['nv'] + p['nchunks'])
    g, r, c = (t.numpy() for t in aset.pivots)
    piv = dp['piv'].numpy()
    assert piv.shape[0] == g.size
    rinv = np.empty(p['P'], dtype=np.int64)
    rinv[dp['row_perm'].numpy()] = np.arange(p['P'])
    off = dp['piv_off'].numpy()
    for s in range(p['ntiles'] * (p['nchunks'] + 1)):
        t, slot = divmod(s, p['nchunks'] + 1)
        for gl, j, col, _ in piv[off[s]:off[s + 1]]:
            assert slot == (p['nchunks'] if j < p['nbord'] else (j // p['nb']) // p['BR'])
            hit = (g == t * tb.K4_GT + gl) & (rinv[r] == j)
            assert hit.sum() == 1 and c[hit][0] == col
    bad = dp['bad'].numpy()
    assert sorted(bad[:, 0]) == sorted(set(bM.bad_idx) | set(bL.bad_idx))
    assert (dp['counter'].numpy() == 0).all()


def test_k4_fused_twins_equal_the_old_composition(rbc):
    """Each fused form's twin, bit for bit, against the lines the port ran
    before it: the step's two applies, the outer pass's residual, and the
    solver's exact apply and refinement residual with the pivot pairs."""
    pencil, bM, bL, fact = rbc
    X, R = _rng_pencils(pencil, 9, 2)
    rv = pencil.row_valid_dev
    ml = tb.BandedApplySet([bM, bL])
    MX, LX = ml.pair(X)
    assert torch.equal(MX, bM.apply_plain(X)) and torch.equal(LX, bL.apply_plain(X))
    a0, b0 = 1000.0, 1.0
    old = R - (a0 * bM.apply_plain(X) + b0 * bL.apply_plain(X)) * rv
    assert torch.equal(ml.combine((a0, b0), X, R=R, rv=rv), old)
    aset = fact.apply_set
    g, r, c = aset.pivots
    Y = 1500.0 * bM.apply_plain(X)
    Y = Y + 1.0 * bL.apply_plain(X)
    Y.index_put_((g, r), X[g, c], accumulate=True)
    assert torch.equal(fact.banded.exact_apply(X), Y)
    assert torch.equal(fact.banded.exact_residual(R, X), R - Y)
    assert torch.equal(bL.apply(X), bL.apply_plain(X))


def test_solver_default_refinement_operator_is_its_blocks():
    """A solver given no apply set refines against its own blocks: one
    BandedOperator at coefficient 1 with no pivot pairs, whose exact apply
    and refinement residual are, bit for bit, the operator's plain apply and
    R minus it; and the refined solve meets a dense solve."""
    import scipy.sparse as ss
    rng = np.random.default_rng(11)
    nb, Nb, G = 4, 6, 3
    P = nb * Nb
    mats = []
    for _ in range(G):
        A = np.zeros((P, P))
        for i in range(Nb):
            r0 = i * nb
            A[r0:r0 + nb, max(r0 - nb, 0):r0 + 2 * nb] = rng.normal(
                size=(nb, min(r0 + 2 * nb, P) - max(r0 - nb, 0)))
        A[0, :] = rng.normal(size=P)
        A += 8.0 * np.eye(P)
        mats.append(A)
    order = dict(col_perm=np.arange(P), row_perm=np.arange(P),
                 n_border=1, n_core=P - 1, bcol_first=False)
    blocks = tb.build_banded_blocks(None, None, None, order, nb,
                                    exact=[ss.csr_matrix(A) for A in mats])
    solver = tb.BorderedBandedSolver(blocks, 'cpu', refinements=4)
    aset = solver.apply_set
    assert len(aset.ops) == 1 and aset.coefs == (1.0,) and aset.pivots is None
    op = aset.ops[0]
    assert isinstance(op, tb.BandedOperator)
    X, R = (torch.as_tensor(rng.standard_normal((G, P))) for _ in range(2))
    Y = op.apply_plain(X)
    assert torch.equal(solver.exact_apply(X), Y)
    assert torch.equal(solver.exact_residual(R, X), R - Y)
    np.testing.assert_allclose(Y.numpy(), np.einsum('gij,gj->gi', np.stack(mats), X.numpy()),
                               rtol=0, atol=1e-13 * np.abs(Y.numpy()).max())
    Xs = solver.solve(R).numpy()
    Xd = np.linalg.solve(np.stack(mats), R.numpy()[..., None])[..., 0]
    assert np.abs(Xs - Xd).max() < 1e-10 * np.abs(Xd).max()
