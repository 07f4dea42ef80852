"""K14c's tile schedule (csrc/separable_kernels.cu separable_mma_kernel),
emulated in numpy on the CPU, against the plain twin
(dedalus_tpu_torch/ops/solve.py separable_apply_plain and its pair form) and
the JAX package's separable_apply / separable_apply_pair
(dedalus_tpu/ops/solve.py:317, :350).

The kernel runs only on the card: a block owns a (BM x BN) tile of Y, the
grid's row tiles fastest; it walks steps (k slab, q) with k outer and q
inner through a ring of S stages, issuing step s + S - 1 into the slot step
s - 1 used after the step's barrier. A step stages the B tile
Bcat[k0:k0+BK, (off+q) P + n0 : +BN] and, with q == 0, the slab's X tile,
both zero-filled past G and P and stored k-minor with k permuted (k = 4j + t
at 4t + j, row stride KS); the lanes read them back as m16n8k16 fragments,
scale A by w[g, q] (each lane's weights read one step ahead), and add the
step's product. Warps whose sub-tile lies past G or P compute nothing; the
stores skip rows past G and columns past P; the exceptional groups' rows are
then overwritten by Abad X[bad]. The emulation reads the tile constants from
the source, checks each slot's owner at every read, and sums each step as
one product in f64. Tolerance: 1e-13 relative (the kernel's own order of
sums differs from the twin's matmul and einsum).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dedalus_tpu.ops import solve as jsolve
from dedalus_tpu_torch.ops import solve as tsolve

torch.set_num_threads(1)

SRC = (pathlib.Path(tsolve.__file__).resolve().parents[1] / 'csrc' /
       'separable_kernels.cu').read_text()


def _constants(src):
    """The kernel's constexpr ints, evaluated in order."""
    env = {}
    for name, expr in re.findall(r'constexpr int (\w+) = ([^;]+);', src):
        expr = re.sub(r'\(int\)sizeof\(double\)', '8', expr)
        try:
            env[name] = int(eval(expr.replace('/', '//'), {}, dict(env)))
        except (NameError, SyntaxError):
            pass
    return env


C = _constants(SRC)
BM, BN, BK, S, KS, WM, WN = (C[k] for k in ('BM', 'BN', 'BK', 'S', 'KS', 'WM', 'WN'))
THREADS = C['THREADS']


def perm(k):
    return (k & 3) * 4 + (k >> 2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def grid_order(G, P, nout):
    """The blocks (row tile, column tile, output) in launch order: x fastest."""
    nx, ny = -(-G // BM), -(-P // BN)
    return [(x, y, z) for z in range(nout) for y in range(ny) for x in range(nx)]


class Ring:
    """S slots of a tile, each tagged with the step (or slab) it holds."""

    def __init__(self, size):
        self.mem = np.full((S, size), np.nan)
        self.owner = [None] * S

    def fill(self, slot, tag, data):
        self.mem[slot] = data
        self.owner[slot] = tag

    def read(self, slot, tag):
        assert self.owner[slot] == tag, "a slot read before it holds its step"
        return self.mem[slot]


def stage_b(Bcat, P, off, n0, kt, q):
    """The B tile as the block's copies leave it: n KS + perm(k)."""
    tile = np.full(BN * KS, np.nan)
    k0 = kt * BK
    for k in range(BK):
        for n in range(BN):
            ok = k0 + k < P and n0 + n < P
            tile[n * KS + perm(k)] = Bcat[k0 + k, (off + q) * P + n0 + n] if ok else 0.0
    return tile


def stage_x(X, G, P, g0, kt):
    tile = np.full(BM * KS, np.nan)
    k0 = kt * BK
    for m in range(BM):
        for k in range(BK):
            ok = g0 + m < G and k0 + k < P
            tile[m * KS + perm(k)] = X[g0 + m, k0 + k] if ok else 0.0
    return tile


def read_tiles(bs, xs):
    """The (BM x BK) A and (BK x BN) B matrices the lanes' fragments hold:
    lane (g, t) reads row g's positions 4t .. 4t + 3, k = 4j + t."""
    A = np.empty((BM, BK))
    B = np.empty((BK, BN))
    for t in range(4):
        for j in range(4):
            A[:, 4 * j + t] = xs.reshape(BM, KS)[:, 4 * t + j]
            B[4 * j + t, :] = bs.reshape(BN, KS)[:, 4 * t + j]
    return A, B


def emulate_block(X, Bcat, w, off, G, P, bx, by, Y):
    """One block's ring of steps, k outer and q inner, and its stores."""
    nq = w.shape[1]
    g0, n0 = bx * BM, by * BN
    nsteps = -(-P // BK) * nq
    bring, xring = Ring(BN * KS), Ring(BM * KS)
    acc = np.zeros((BM, BN))
    issued = []

    def issue(step):
        kt, q = divmod(step, nq)
        bring.fill(step % S, step, stage_b(Bcat, P, off, n0, kt, q))
        if q == 0:
            xring.fill(kt % S, kt, stage_x(X, G, P, g0, kt))
        issued.append(step)

    for s in range(min(S - 1, nsteps)):
        issue(s)
    # Each lane's weights of the first step, then one step ahead
    rows = g0 + np.arange(BM)
    wnext = np.where(rows < G, w[np.minimum(rows, G - 1), 0], 0.0)
    live = np.array([[g0 + wm * WM < G and n0 + wn * WN < P for wn in range(BN // WN)]
                     for wm in range(BM // WM)])
    for s in range(nsteps):
        # barrier: step s landed (issued S - 1 steps before), step s - 1 done
        assert s in issued
        if s + S - 1 < nsteps:
            assert bring.owner[(s + S - 1) % S] in (None, s - 1)
            issue(s + S - 1)
        kt, q = divmod(s, nq)
        wr = wnext
        if s + 1 < nsteps:
            qn = (q + 1) % nq
            wnext = np.where(rows < G, w[np.minimum(rows, G - 1), qn], 0.0)
        assert np.array_equal(wr, np.where(rows < G, w[np.minimum(rows, G - 1), q], 0.0))
        A, B = read_tiles(bring.read(s % S, s), xring.read(kt % S, kt))
        assert np.isfinite(A).all() and np.isfinite(B).all()
        step = (A * wr[:, None]) @ B
        for wm in range(BM // WM):
            for wn in range(BN // WN):
                if live[wm, wn]:
                    sl = (slice(wm * WM, (wm + 1) * WM), slice(wn * WN, (wn + 1) * WN))
                    acc[sl] += step[sl]
    for g in range(BM):
        for p in range(BN):
            if g0 + g < G and n0 + p < P:
                assert live[g // WM, p // WN]
                Y[g0 + g, n0 + p] = acc[g, p]


def emulate(X, Bcat, outs):
    """K14c's launch for one or two (weights, column block offset, bad
    groups, dense rows) outputs, then the override launch of each."""
    G, P = X.shape
    Ys = [np.full((G, P), np.nan) for _ in outs]
    for bx, by, z in grid_order(G, P, len(outs)):
        w, off, _, _ = outs[z]
        emulate_block(X, Bcat, w, off, G, P, bx, by, Ys[z])
    for (w, off, bad, Abad), Y in zip(outs, Ys):
        assert np.isfinite(Y).all()
        for i, g in enumerate(bad):
            Y[g] = Abad[i] @ X[g]
    return Ys


def _inputs(seed, G, P, qs):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((G, P))
    Bcat = rng.standard_normal((P, sum(qs) * P))
    ws = [rng.standard_normal((G, q)) for q in qs]
    bads = [(0, G - 1), (1,)][:len(qs)]
    Abads = [rng.standard_normal((len(b), P, P)) for b in bads]
    return X, Bcat, ws, bads, Abads


def test_constants_are_the_kernels():
    """The tile the emulation walks is the source's: warps cover the tile,
    the k permutation is a bijection, both ring sizes fit two blocks an SM."""
    assert THREADS == 32 * (BM // WM) * (BN // WN)
    assert BK == 16 and KS % 4 == 2
    assert sorted(perm(k) for k in range(BK)) == list(range(BK))
    assert C['SMEM'] == S * (BM + BN) * KS * 8
    assert C['CTAS'] * (C['SMEM'] + 1024) <= 228 * 1024


@pytest.mark.parametrize('G,P', [(200, 70), (7, 33), (130, 129)])
def test_grid_runs_row_tiles_fastest(G, P):
    """The blocks sharing a column slab of Bcat are launched together."""
    order = grid_order(G, P, 2)
    nx = -(-G // BM)
    for i in range(0, len(order), nx):
        assert len({(y, z) for _, y, z in order[i:i + nx]}) == 1
        assert [x for x, _, _ in order[i:i + nx]] == list(range(nx))


@pytest.mark.parametrize('q', [1, 2, 3, 5])
@pytest.mark.parametrize('G,P', [(200, 70), (7, 33)])
def test_schedule_matches_twin_and_jax(q, G, P):
    """Ragged row and column tiles (P not a multiple of BN or BK), the
    weights applied as A is formed, the override of the exceptional rows."""
    X, Bcat, (w,), (bad,), (Abad,) = _inputs(10 * q + G, G, P, (q,))
    Y, = emulate(X, Bcat, [(w, 0, bad, Abad)])
    T = torch.as_tensor
    twin = tsolve.separable_apply_plain(T(X), T(w), T(Bcat), bad, T(Abad)).numpy()
    ref = np.asarray(jsolve.separable_apply(jnp.asarray(X), jnp.asarray(w), jnp.asarray(Bcat),
                                            bad, jnp.asarray(Abad)))
    assert _rel(Y, twin) <= 1e-13
    assert _rel(Y, ref) <= 1e-13


@pytest.mark.parametrize('qs', [(2, 3), (1, 2)])
def test_pair_offsets_match_twin_and_jax(qs):
    """The pair form: one launch, z = 1 reading Bcat from column block qA."""
    G, P = 140, 45
    X, Bcat, (wA, wB), (badA, badB), (CA, CB) = _inputs(sum(qs), G, P, qs)
    YA, YB = emulate(X, Bcat, [(wA, 0, badA, CA), (wB, qs[0], badB, CB)])
    T = torch.as_tensor
    twins = tsolve.separable_apply_pair_plain(T(X), T(Bcat), T(wA), badA, T(CA), T(wB), badB,
                                              T(CB))
    refs = jsolve.separable_apply_pair(jnp.asarray(X), jnp.asarray(Bcat), jnp.asarray(wA), badA,
                                       jnp.asarray(CA), jnp.asarray(wB), badB, jnp.asarray(CB))
    for Y, twin, ref in zip((YA, YB), twins, refs):
        assert _rel(Y, twin.numpy()) <= 1e-13
        assert _rel(Y, np.asarray(ref)) <= 1e-13


def test_strided_bcat_view():
    """A column block of a wider Bcat (the row stride ldb > qP), as the
    wrapper passes a (P, n) view of unit column stride."""
    G, P, q = 70, 40, 2
    X, Bcat, (w, _), _, _ = _inputs(5, G, P, (q, 3))
    view = Bcat[:, 3 * P:]
    Y, = emulate(X, view, [(w, 0, (), None)])
    twin = tsolve.separable_apply_plain(torch.as_tensor(X), torch.as_tensor(w),
                                        torch.as_tensor(view)).numpy()
    assert _rel(Y, twin) <= 1e-13
