"""The card kernels' size limits (ROADMAP faults F7 and F8): K4, K5 and
K11b at and past the sizes their tile kernels take pick their general paths
and raise nothing; what stays limited on the card (past F8's general paths,
tests/test_torch_f8_general.py) raises when a banded solver is built,
naming nb and n_border.

The general paths run only on the card. Their arithmetic is emulated here
at the kernels' own indices against the plain twins and independent
references:
- K4 (csrc/banded_kernels.cu banded_apply_general_kernel): a thread a
  (group, banded row j < P), x[c] = X[g, col_perm[c]] (zero past P), the
  shared parts' raw panels times the group's weights, the exceptional or
  per-group blocks through the group's index, the pivot pairs of output 0
  from a per-group table, then the row mask and the residual, stored at
  row_perm[j];
- K5 (block_tridiag_qr_solve_direct_kernel): the sweeps with the factor
  blocks read from device memory, each row a sum over the lanes' strided
  partial sums and a fixed xor tree;
- K11b: the apply's general kernel past K11_MAX_DIAGS diagonals (the twin's order,
  bit for bit), the solve's general carry (a line walked from the end,
  each step's products and differences in solve_step's order).
"""

import pathlib
import re

import numpy as np
import pytest
import scipy.linalg
import torch

import dedalus_tpu_torch.ops.banded as tb
from dedalus_tpu_torch.ops import fft as F
from dedalus_tpu_torch.spectral import jacobi as tjacobi

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _operators(G, Nb, nb, nbord, pad, parts=2, nbad=2, seed=0):
    """Two separable operators of one ordering (random panels, exceptional
    groups with zero weights) and one per-group operator, on the CPU."""
    rng = np.random.default_rng(seed)
    Pp = Nb * nb
    P = Pp - pad
    order = dict(row_perm=rng.permutation(P), col_perm=rng.permutation(P), n_border=nbord)
    r = lambda *shape: rng.standard_normal(shape)

    def blocks(g):
        return tb.BandedBlocks(r(g, Nb, nb, nb), r(g, Nb, nb, nb), r(g, Nb, nb, nb),
                               r(g, Pp, nbord), r(g, nbord, Pp), order, nb, pad)

    def separable():
        bad = tuple(sorted(int(g) for g in rng.choice(G, nbad, replace=False)))
        w = r(G, parts)
        w[list(bad)] = 0.0
        return tb.SeparableBandedOperator([blocks(1) for _ in range(parts)], w, order, nb,
                                          'cpu', bad=(bad, blocks(nbad)))

    return separable(), separable(), tb.BandedOperator(blocks(G), 'cpu'), P


@pytest.mark.parametrize('nb,nbord,general', [(32, 32, False), (33, 5, True), (8, 33, True),
                                              (40, 36, True)])
def test_k4_plan_at_and_past_the_tile_limits(nb, nbord, general):
    a, b, grp, P = _operators(5, 3, nb, nbord, 3)
    aset = tb.BandedApplySet([a, b])
    plan = tb.k4_plan([tb._k4_term(op) for op in (a, b)], (0, 1), a.G, P)
    assert plan['general'] == general
    assert tb.k4_plan([tb._k4_term(grp)], (0,), grp.G, P)['general'] == general
    if general:
        assert plan['blocks'] == a.G * -(-P // tb.K4G_THREADS)
    assert aset.device_plan(True, False, torch.device('cpu'))['plan']['general'] == general


def test_k4_plan_more_shared_parts_than_a_tile_takes():
    a, _, _, P = _operators(4, 3, 6, 4, 1, parts=tb.K4_MAXP + 1)
    assert tb.k4_plan([tb._k4_term(a)], (0,), a.G, P)['general']
    a, _, _, P = _operators(3, 2, 3, 2, 1, parts=tb.K4G_MAXP + 1, nbad=1)
    with pytest.raises(ValueError, match=f'nparts={tb.K4G_MAXP + 1}'):
        tb.k4_plan([tb._k4_term(a)], (0,), a.G, P)


K4_SRC = (pathlib.Path(tb.__file__).resolve().parents[1] / 'csrc' /
          'banded_kernels.cu').read_text()
K4G_TERM_INTS = int(re.search(r'#define K4G_TERM_INTS (\d+)', K4_SRC).group(1))


def test_k4_general_constants_match_source():
    for name in ('K4G_THREADS', 'K4G_MAXP'):
        assert getattr(tb, name) == int(re.search(rf'#define {name} (\d+)', K4_SRC).group(1))


def emulate_k4_general(aset, X, coefs=None, pair=False, R=None, rv=None, pivots=False):
    """banded_apply_general_kernel on the CPU, from the launcher's packed
    term table (K4G_TERM_INTS int64 a term: the panels resolved from their
    addresses, the part count, the four panel masks, the group mask, the
    group index and the output) and the device plan's other arrays."""
    dp = aset.device_plan(pair, pivots, torch.device('cpu'))
    p = dp['plan']
    assert p['general']
    table = list(dp['table'])
    assert len(table) == K4G_TERM_INTS * len(aset.ops)
    at_addr = {0: None}
    for t, index in zip(dp['terms'], dp['index']):
        for v in [t['w'], index] + [o[key] for o in (t['shared'], t['group']) if o is not None
                                    for key in ('diag', 'sub', 'sup', 'UcolT', 'Vrow')]:
            if v is not None:
                at_addr[v.data_ptr()] = v.numpy()
    G, P, Nb, nb, nbord, b0 = (p[k] for k in ('G', 'P', 'Nb', 'nb', 'nbord', 'bcol0'))
    Pp = Nb * nb
    n = len(aset.ops)
    coefs = (1.0,) * n if coefs is None else coefs
    cp, rp = dp['col_perm'].numpy(), dp['row_perm'].numpy()
    Xn = X.numpy()
    Y = [np.full((G, P), np.nan) for _ in range(p['nout'])]

    def row(xg, diag, sub, sup, U, V, j):
        i, r = divmod(j, nb)
        xw = lambda c0: np.array([xg[cp[c]] if c < P else 0.0 for c in range(c0, c0 + nb)])
        s = diag[i, r] @ xw(i * nb)
        if sub is not None and i > 0:
            s += sub[i, r] @ xw((i - 1) * nb)
        if sup is not None and i < Nb - 1:
            s += sup[i, r] @ xw((i + 1) * nb)
        if U is not None:
            s += U[:, j] @ np.array([xg[cp[b0 + b]] for b in range(nbord)])
        if V is not None and j < nbord:
            s += V[j] @ np.array([xg[cp[c]] if c < P else 0.0 for c in range(Pp)])
        return s

    piv_off = None if dp['piv_off'] is None else dp['piv_off'].numpy()
    piv = None if dp['piv'] is None else dp['piv'].numpy()
    for g in range(G):
        xg = Xn[g]
        for j in range(P):
            y = [0.0, 0.0]
            for k in range(n):
                e = table[K4G_TERM_INTS * k:K4G_TERM_INTS * (k + 1)]
                panel = [at_addr[a] for a in e[0:5]]
                w, nparts, masks = at_addr[e[5]], e[6], e[7:11]
                gpanel, gmask, index = [at_addr[a] for a in e[11:16]], e[16], at_addr[e[17]]
                s = 0.0
                for q in range(nparts):
                    s += w[g, q] * row(xg, panel[0][q, 0], *(
                        panel[i + 1][q, 0] if masks[i] >> q & 1 else None for i in range(4)), j)
                if index is not None and index[g] >= 0:
                    b = int(index[g])
                    s += row(xg, gpanel[0][0, b], *(
                        gpanel[i + 1][0, b] if gmask >> i & 1 else None for i in range(4)), j)
                y[e[18]] += coefs[k] * s
            if piv_off is not None:
                for e in range(piv_off[g], piv_off[g + 1]):
                    if piv[e, 0] == j:
                        y[0] += xg[piv[e, 1]]
            at = rp[j]
            for o in range(p['nout']):
                v = y[o]
                if rv is not None:
                    v *= rv[g, at].item()
                if R is not None:
                    v = R[g, at].item() - v
                Y[o][g, at] = v
    return tuple(Y) if pair else Y[0]


def test_k4_general_emulation_against_twin():
    """Every K4 form past 32 rows (nb = 40, n_border = 36): the pair, the
    refinement residual with the pivot pairs, the row mask and two
    coefficients, and per-group blocks."""
    G = 4
    a, b, grp, P = _operators(G, 3, 40, 36, 7, seed=3)
    rng = np.random.default_rng(4)
    gs = np.array([0, 0, 2, 3])
    rs = np.array([5, 17, 3, 100])
    cs = rng.integers(0, P, gs.size)
    piv = tuple(torch.as_tensor(v) for v in (gs, rs, cs))
    aset = tb.BandedApplySet([a, b], pivots=piv, coefs=(0.5, -2.0))
    X, R = (torch.tensor(rng.standard_normal((G, P))) for _ in range(2))
    rv = torch.tensor((rng.random((G, P)) > 0.2).astype(float))
    got = emulate_k4_general(aset, X, pair=True)
    twin = tb.banded_apply_plain_set(aset, X, pair=True)
    assert max(_rel(g, t) for g, t in zip(got, twin)) <= 1e-13
    got = emulate_k4_general(aset, X, aset.coefs, R=R, rv=rv, pivots=True)
    twin = tb.banded_apply_plain_set(aset, X, aset.coefs, R=R, rv=rv, pivots=True)
    assert _rel(got, twin) <= 1e-13
    gset = tb.BandedApplySet([grp])
    assert _rel(emulate_k4_general(gset, X), grp.apply_plain(X)) <= 1e-13


def test_k4_general_emulation_past_eight_parts():
    """A separable operator of degree 8 and more (9 and 12 shared parts:
    each part's sub, sup, Ucol and Vrow masks past bit 8) through the
    packed table, against the twin."""
    for parts, seed in ((9, 5), (12, 6)):
        a, b, _, P = _operators(3, 3, 5, 3, 2, parts=parts, nbad=1, seed=seed)
        for op in (a, b):
            sh = op.ops
            for key in ('sub', 'sup', 'UcolT', 'Vrow'):
                keep = [q % 3 != ('sub', 'sup', 'UcolT', 'Vrow').index(key) % 3
                        for q in range(parts)]
                sh[key][[q for q in range(parts) if not keep[q]]] = 0.0
                sh['mask_' + key] = sum(1 << q for q in range(parts) if keep[q])
        aset = tb.BandedApplySet([a, b], coefs=(1.5, -0.25))
        assert tb.k4_plan([tb._k4_term(op) for op in (a, b)], (0, 1), a.G, P)['general']
        X = torch.tensor(np.random.default_rng(seed).standard_normal((a.G, P)))
        got = emulate_k4_general(aset, X, pair=True)
        twin = tb.banded_apply_plain_set(aset, X, pair=True)
        assert max(_rel(g, t) for g, t in zip(got, twin)) <= 1e-13
        got = emulate_k4_general(aset, X, aset.coefs)
        assert _rel(got, tb.banded_apply_plain_set(aset, X, aset.coefs)) <= 1e-13


def test_k4_general_table_names_the_panels():
    """The launcher's table (K4G_TERM_INTS a term) points at the panels,
    weights, per-group blocks and index the kernel reads."""
    a, b, grp, P = _operators(3, 2, 34, 3, 2)
    aset = tb.BandedApplySet([a, grp])
    dp = aset.device_plan(False, False, torch.device('cpu'))
    t = list(dp['table'])
    assert len(t) == 2 * K4G_TERM_INTS
    ptr = lambda v: 0 if v is None else v.data_ptr()
    sh = a.ops
    assert t[:6] == [ptr(sh[k]) for k in ('diag', 'sub', 'sup', 'UcolT', 'Vrow')] + [ptr(a.w)]
    assert t[6] == sh['nparts']
    assert t[7:11] == [sh['mask_' + k] for k in ('sub', 'sup', 'UcolT', 'Vrow')]
    assert t[11] == a.bad_ops['diag'].data_ptr()
    assert t[17] == dp['index'][0].data_ptr() and t[18] == 0
    assert t[19:30] == [0] * 11 and t[30] == grp.ops['diag'].data_ptr()
    assert list(dp['index'][1].numpy()) == list(range(grp.G))


@pytest.mark.parametrize('itemsize,ring_nb', [(8, 59), (4, 84)])
def test_k5_plan_at_and_past_the_ring(itemsize, ring_nb):
    """K5's two-slot ring holds nb = 59 in f64 and 84 in f32; past them the
    direct path (4 nb carry elements a block), past what that holds an
    error naming nb."""
    ring = tb.k5_plan(ring_nb, itemsize)
    assert ring['stages'] == 2 and not ring['direct']
    direct = tb.k5_plan(ring_nb + 1, itemsize)
    assert direct == dict(direct, stages=0, direct=True, smem=4 * (ring_nb + 1) * itemsize)
    with pytest.raises(ValueError, match='nb=9000'):
        tb.k5_plan(9000, 8)


def emulate_k5_direct(Qt, QtL, Rinv, R1, R2, r):
    """block_tridiag_qr_solve_direct_kernel on the CPU: each row a sum of
    32 lanes' strided partial sums, added by the xor tree."""
    def dot(row, v):
        part = np.array([np.sum(row[l::32] * v[l::32]) for l in range(32)])
        for off in (16, 8, 4, 2, 1):
            part = part + part[np.arange(32) ^ off]
        return part[0]

    G, Nb, nb = r.shape
    x = np.empty_like(r)
    for g in range(G):
        vin = np.concatenate([r[g, 0], np.zeros(nb)])
        for i in range(Nb):
            if i < Nb - 1:
                vin[nb:] = r[g, i + 1]
                w = np.array([dot(Qt[g, i, row], vin) for row in range(2 * nb)])
                x[g, i], vin[:nb] = w[:nb], w[nb:]
            else:
                x[g, i] = [dot(QtL[g, row], vin[:nb]) for row in range(nb)]
        xa, xb = np.zeros(nb), np.zeros(nb)
        for i in range(Nb - 1, -1, -1):
            t = np.array([(x[g, i, row] - dot(R1[g, i, row], xa)) - dot(R2[g, i, row], xb)
                          for row in range(nb)])
            xc = np.array([dot(Rinv[g, i, row], t) for row in range(nb)])
            x[g, i] = xc
            xb, xa = xa, xc
    return x


def test_k5_direct_emulation_against_twin():
    rng = np.random.default_rng(9)
    G, Nb, nb = 2, 4, 61
    eye = np.eye(nb)
    fac = [np.eye(2 * nb) + 0.3 * rng.standard_normal((G, Nb - 1, 2 * nb, 2 * nb)) / 11,
           eye + 0.3 * rng.standard_normal((G, nb, nb)) / 8,
           eye + 0.3 * rng.standard_normal((G, Nb, nb, nb)) / 8,
           0.3 * rng.standard_normal((G, Nb, nb, nb)) / 8,
           0.3 * rng.standard_normal((G, Nb, nb, nb)) / 8, rng.standard_normal((G, Nb, nb))]
    assert tb.k5_plan(nb, 8)['direct']
    got = emulate_k5_direct(*fac)
    twin = tb.block_tridiag_qr_solve(*(torch.tensor(a) for a in fac)).numpy()
    assert _rel(got, twin) <= 1e-13


def test_conversion_band_at_and_past_the_carry():
    """Offsets up to 16 take an instantiated carry; past it the solve's
    general carry is the largest offset, and no width raises."""
    assert F.ConversionBand([np.ones(40)] * 2, [0, 16]).width == 16
    assert not F.ConversionBand([np.ones(40)] * 2, [0, 16]).general
    band = F.ConversionBand([np.ones(40)] * 2, [0, 17])
    assert band.width == 17 and band.general
    assert band.solve_rows_host().shape == (18, 40)
    band = F.ConversionBand([np.ones(40)] * 17, range(17))
    assert band.general and band.width == 16


def _chebyshev_band(M, da):
    """The port's T -> ultraspherical conversion by da steps (core/basis.py
    Jacobi._conversion_band)."""
    K = tjacobi.conversion_matrix(M, -0.5, -0.5, -0.5 + da, -0.5 + da).tocsr()
    coo = K.tocoo()
    offsets = sorted(set((coo.col - coo.row).tolist()))
    diags = []
    for off in offsets:
        d = np.zeros(M)
        vals = K.diagonal(off)
        d[:len(vals)] = vals
        diags.append(d)
    return F.ConversionBand(diags, offsets), K


def emulate_apply_general(band, x, axis):
    """conversion_apply_general_kernel: a thread a point m of a slab, its sum
    over every diagonal in order, each read from device memory."""
    xm = np.moveaxis(x, axis, -1)
    N, M = xm.shape[-1], band.M
    out = np.zeros(xm.shape[:-1] + (M,))
    for m in range(M):
        for d, off in enumerate(band.offsets):
            if 0 <= m + off < N:
                out[..., m] = out[..., m] + band.diags[d][m] * xm[..., m + off]
    return np.moveaxis(out, -1, axis)


def emulate_solve_general(band, b, axis):
    """conversion_solve_general_kernel: a line walked from the end, the
    carry read back from its own output."""
    Dw = band.solve_rows_host()
    bm = np.moveaxis(b, axis, -1)
    P, W = band.M, band.width
    x = np.zeros(bm.shape[:-1] + (P,))
    for m in range(P - 1, -1, -1):
        acc = bm[..., m].copy()
        for j in range(1, W + 1):
            if m + j < P:
                acc = acc - Dw[j, m] * x[..., m + j]
        x[..., m] = acc * Dw[0, m]
    return np.moveaxis(x, -1, axis)


@pytest.mark.parametrize('da', [8, 10])
def test_k11b_general_paths_at_large_da(da):
    """ChebyshevT by da = 8 and 10 ultraspherical steps: 2 da + 1 diagonals
    up to offset 2 da, past the tile kernel's 16. The general apply equals
    the twin bit for bit; the general solve is within 1e-12 of the twin and
    of a dense triangular solve."""
    M = 48
    band, K = _chebyshev_band(M, da)
    assert band.offsets[-1] == 2 * da and len(band.offsets) > F.K11_MAX_DIAGS
    assert band.general and band.width == 2 * da
    rng = np.random.default_rng(da)
    x = rng.standard_normal((3, M + 5, 2))
    got = emulate_apply_general(band, x, 1)
    twin = F.conversion_apply(band, torch.tensor(x), 1).numpy()
    assert np.array_equal(got, twin)
    b = rng.standard_normal((2, 4, M + 3))
    got = emulate_solve_general(band, b, -1)
    twin = F.conversion_solve(band, torch.tensor(b), -1).numpy()
    assert _rel(got, twin) <= 1e-12
    ref = np.moveaxis(scipy.linalg.solve_triangular(K.toarray(), np.moveaxis(
        b[..., :M], -1, 0).reshape(M, -1)).reshape((M,) + b.shape[:-1]), 0, -1)
    assert _rel(got, ref) <= 1e-12


def test_solver_build_names_what_stays_limited():
    """Since F8's general paths (K8a's workspace, K8b's column chunks and
    unstaged factors, K6 post's opt-in shared memory and scratch) the sizes
    the old limits refused build on the card: RBC's ordering (nb 19,
    n_border 13), nb 40, F8's (96, 180), n_border 200. What stays limited
    is K8b's and K5's vectors in shared memory: past nb = 7264 the build
    raises, naming nb and n_border."""
    for nb, nbord in ((19, 13), (39, 13), (40, 13), (96, 180), (19, 200), (7264, 1)):
        tb.banded_card_limits(nb, nbord)
    with pytest.raises(ValueError, match=r'nb=7265, n_border=13'):
        tb.banded_card_limits(7265, 13)
