"""KH by ell (csrc/ball_kernels.cu ball_radial_apply_kernel) emulated in
numpy on the CPU, against the plain twin (dedalus_tpu_torch/ops/ball.py
ball_radial_apply_plain) and the JAX package's BallRadialBasis._apply_stack
(dedalus_tpu/core/basis_ball.py:206-222).

The kernel runs only on the card. Its schedule is the host plan's
(ops/ball.py kh_plan): a block takes a unit (ell, first column, columns,
first row) of the table, the product units largest first and the units of
the slots with ell >= E (their outputs zeroed) last, launched only without
`accumulate`. A unit's columns decode as (k, component pair q, pair slot p),
p fastest, k from max(0, ell - L + 1); it stages at most RT rows of S[ell]
transposed and its columns' runs, zero past the unit's rows and columns;
each thread's register tiles (KH_TR rows x KH_TC columns, at most
KH_MAX_TASKS a thread) sum over n; the tiles are stored along O. The
emulation walks the same units with the same index arithmetic, reads the
constants from the source, and checks that every output of the named
components is stored exactly once (without accumulate) and that no slot of
an ell is left out. Tolerance: 1e-13 relative (the twin's einsum sums in
its own order).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dedalus_tpu.core.basis_ball import BallRadialBasis
from dedalus_tpu_torch.ops import ball as tball

torch.set_num_threads(1)

TOL = 1e-13
SRC = (pathlib.Path(tball.__file__).resolve().parents[1] / 'csrc' /
       'ball_kernels.cu').read_text()
C = {name: int(v) for name, v in re.findall(r'constexpr int (KH_\w+) = (\d+);', SRC)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_geometry_matches_source():
    assert tball.KH_GEOMETRY == tuple(C[k] for k in (
        'KH_UNIT_THREADS', 'KH_TR', 'KH_TC', 'KH_UNIT_INTS', 'KH_MAX_TASKS', 'KH_MAX_PAIRS'))


def emulate(S, x, out, pairs, accumulate, plan):
    """The launch on the CPU; returns out as the kernel leaves it."""
    E, O, N = S.shape
    _, K, NP, L, _ = x.shape
    RT, CT, TR, TC = plan.RT, plan.CT, C['KH_TR'], C['KH_TC']
    esize = x.itemsize
    assert plan.smem == 16 * CT + 8 * N * plan.OS + esize * max(N * plan.XS, CT * plan.YS)
    assert plan.OS >= RT and plan.OS % 2 == 0 and plan.XS >= CT and plan.YS >= RT
    per_k = len(pairs) * NP
    y = out.copy()
    stored = np.zeros(out.shape, dtype=int)
    units = plan.units[:plan.nwork + (0 if accumulate else plan.nzero)]
    assert (units[:plan.nwork, 0] < E).all() and (units[plan.nwork:, 0] >= E).all()
    sizes = units[:plan.nwork, 2]
    assert (np.diff(sizes) <= 0).all()          # the largest units first
    for ell, c0, nc, r0 in units:
        assert 0 < nc <= CT and 0 <= r0 < O
        nr = min(RT, O - r0)
        kmin = max(0, ell - L + 1)
        cols = []
        for j in range(c0, c0 + nc):
            kk, r = divmod(j, per_k)
            q, p = divmod(r, NP)
            k, l = kmin + kk, ell - kmin - kk
            assert 0 <= k < K and 0 <= l < L
            cols.append((pairs[q], k, p, l))
        if ell >= E:
            for (ci, co), k, p, l in cols:
                y[co, k, p, l, r0:r0 + nr] = 0.0
                stored[co, k, p, l, r0:r0 + nr] += 1
            continue
        St = np.zeros((N, plan.OS))
        St[:, :nr] = S[ell, r0:r0 + nr].T
        Xt = np.zeros((N, plan.XS), dtype=x.dtype)
        for j, ((ci, co), k, p, l) in enumerate(cols):
            Xt[:, j] = x[ci, k, p, l]
        RG, CP = -(-nr // TR), -(-nc // TC)
        assert RG * CP <= C['KH_MAX_TASKS'] * C['KH_UNIT_THREADS']
        Ys = np.zeros((CT, plan.YS), dtype=x.dtype)
        for task in range(RG * CP):
            rg, cp = divmod(task, CP)
            tile = St[:, rg * TR:rg * TR + TR].T @ Xt[:, cp * TC:cp * TC + TC]
            Ys[cp * TC:cp * TC + TC, rg * TR:rg * TR + TR] = tile.T
        for j, ((ci, co), k, p, l) in enumerate(cols):
            prev = y[co, k, p, l, r0:r0 + nr] if accumulate else 0.0
            y[co, k, p, l, r0:r0 + nr] = prev + Ys[j, :nr]
            stored[co, k, p, l, r0:r0 + nr] += 1
    want = np.zeros(out.shape, dtype=int)
    live = np.zeros((K, L), dtype=bool)
    for k in range(K):
        live[k, :max(min(L, E - k), 0)] = True
    for _, co in pairs:
        want[co] = 1 if not accumulate else live[:, None, :, None]
    assert (stored == want).all()
    return y


# (K, NP, L, E, O, N, pairs, complex, C): the ball's triangular stack (E = L),
# ragged O and N, fewer ells than slots, NP = 1, the shell's square (E = K = L),
# a stack taller than KH_S_BYTES holds (row tiles), three pairs with a swap
CASES = [
    (6, 2, 6, 6, 11, 7, ((0, 0), (1, 1), (2, 2)), False, 3),
    (5, 2, 7, 4, 9, 13, ((2, 0), (0, 2), (1, 1)), True, 3),
    (4, 1, 5, 6, 10, 6, ((1, 2),), False, 3),
    (8, 2, 8, 8, 5, 5, ((0, 0),), True, 1),
    (3, 2, 3, 3, 210, 64, ((0, 1),), False, 2),
    (7, 2, 4, 10, 12, 12, ((0, 0), (1, 2)), False, 3),
]


@pytest.mark.parametrize('accumulate', [False, True])
@pytest.mark.parametrize('case', CASES)
def test_emulation_against_twin_and_jax(case, accumulate):
    K, NP, L, E, O, N, pairs, cplx, Cn = case
    rng = np.random.default_rng(K * 31 + L * 7 + O)
    S = rng.standard_normal((E, O, N))
    x = rng.standard_normal((Cn, K, NP, L, N))
    out = rng.standard_normal((Cn, K, NP, L, O))
    if cplx:
        x = x + 1j * rng.standard_normal(x.shape)
        out = out + 1j * rng.standard_normal(out.shape)
    plan = tball.kh_plan(K, NP, L, E, O, N, len(pairs), x.itemsize)
    got = emulate(S, x, out, pairs, accumulate, plan)
    twin = tball.ball_radial_apply(torch.tensor(S), torch.tensor(x), list(pairs),
                                   torch.tensor(out.copy()), accumulate=accumulate).numpy()
    assert _rel(got, twin) <= TOL
    if NP == 2:
        stack = tball.per_slot_view(torch.tensor(S), K, L).numpy().copy()
        for ci, co in pairs:
            data = x[ci].reshape(K * NP, L, N)
            ref = np.asarray(BallRadialBasis._apply_stack(None, jnp.asarray(data), stack, O))
            ref = ref.reshape(K, NP, L, O)
            if accumulate:
                ref = ref + out[co]
            assert _rel(got[co], ref) <= TOL
    rest = [c for c in range(Cn) if c not in {co for _, co in pairs}]
    assert np.array_equal(got[rest], out[rest])


def test_plans_at_the_cells():
    """ball64's per-ell stack (32, 48, 32), three pairs: units of 16
    columns over all 48 rows, enough to fill the card; the shell's
    (96, 12, 12), one pair: wider units (each thread up to 3 tiles)."""
    p = tball.kh_plan(32, 2, 32, 32, 48, 32, 3, 8)
    assert (p.RT, p.CT) == (48, 16) and p.nwork >= 132
    p = tball.kh_plan(96, 2, 96, 96, 12, 12, 1, 8)
    assert p.RT == 12 and p.nwork >= 132 and p.CT >= 32
    p = tball.kh_plan(3, 2, 3, 3, 210, 64, 1, 8)
    assert p.RT < 210 and 64 * p.OS * 8 <= tball.KH_S_BYTES
