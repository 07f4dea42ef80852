"""KE's trailing form (csrc/polar_kernels.cu trailing_apply_kernel) emulated
in numpy on the CPU, against the plain twin
(dedalus_tpu_torch/ops/polar.py trailing_apply_plain) and the JAX package's
ColatitudeBasis._apply_one (dedalus_tpu/core/basis_sphere.py:146-160).

The kernel runs only on the card. Its schedule is the host plan's
(ops/polar.py kt_plan): a block is (m, signed slot, row tile of 16 MT rows,
column tile of 32 NW columns), the row tiles fastest; a column of the tile
decodes once into its (component, slot, t) offsets in x and out; the
reduction axis walks in steps of KT_KC through a ring of KT_STAGES stages,
S's and x's tiles zero-filled past O, I and the call's columns, each thread
copying the same x column (pair) at rows xk0, xk0 + xkstep, ...; a warp owns
32 columns and all the block's rows; the stores skip rows past O and columns
past the call's, and add to out with `accumulate`. The emulation walks the
same blocks with the same index arithmetic, reads the constants from the
source, checks that every output is stored exactly once and that every
staged element is copied exactly once, and sums each step as one product in
f64. Tolerance: 1e-13 relative (the mma's order of sums is the hardware's).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dedalus_tpu.core.basis_sphere import ColatitudeBasis
from dedalus_tpu_torch.ops import polar as tpolar

torch.set_num_threads(1)

TOL = 1e-13
SRC = (pathlib.Path(tpolar.__file__).resolve().parents[1] / 'csrc' /
       'polar_kernels.cu').read_text()


def _constants(src):
    env = {}
    for name, expr in re.findall(r'constexpr int (KT_\w+) = ([^;]+);', src):
        env[name] = int(eval(expr.replace('/', '//'), {}, dict(env)))
    return env


C = _constants(SRC)
THREADS = 32 * C['KT_WARPS']


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_geometry_matches_source():
    assert tpolar.KT_GEOMETRY == tuple(C[k] for k in (
        'KT_WARPS', 'KT_WN', 'KT_KC', 'KT_STAGES', 'KT_SS', 'KT_MAX_MT', 'KT_MAX_COMPS'))
    assert C['KT_SS'] % 16 == 4      # the A fragments' loads: no bank conflict


def emulate(S, x, out, comps, accumulate, plan):
    """The launch on the CPU: S (K, O, I) or (K, 2, O, I); x, out the real
    (C, P K, ., Td) views, P = 2 azimuth rows an m or 1 at one azimuth point
    (the kernel's np). Returns out as the kernel leaves it."""
    ns = S.ndim - 2
    K, O, I = S.shape[0], S.shape[-2], S.shape[-1]
    Td = x.shape[-1]
    P = x.shape[1] // K
    nslot, npb = (P, 1) if ns == 2 else (1, P)
    cpq = npb * Td
    ncol = len(comps) * cpq
    MT, NW, nct, nrt = plan.MT, plan.NW, plan.nct, plan.nrt
    RT, CT, KC, WN = 16 * MT, C['KT_WN'] * NW, C['KT_KC'], C['KT_WN']
    assert ncol == plan.ncol and nct * CT >= ncol and RT * nrt >= O
    assert plan.smem == 8 * (C['KT_STAGES'] * (RT * C['KT_SS'] + KC * (CT + 4)) + 2 * CT)
    V = plan.V
    y = out.copy()
    stored = np.zeros(out.shape, dtype=int)
    blocks = K * nslot * nct * nrt
    assert blocks == plan.blocks
    # the x copies' thread map: a column (pair) a thread, rows xk0 + xkstep j
    xcols = CT // V
    tid = np.arange(THREADS)
    xc, xk0, xkstep = (tid % xcols) * V, tid // xcols, THREADS // xcols
    copies = np.zeros((KC, CT), dtype=int)
    for t in tid[xk0 < xkstep]:
        for kk in range(xk0[t], KC, xkstep):
            copies[kk, xc[t]:xc[t] + V] += 1
    assert (copies == 1).all()
    Sm_all = S.reshape(K, 1 if ns == 1 else 2, O, I)
    for bid in range(blocks):
        rt = bid % nrt
        ct = (bid // nrt) % nct
        ms = bid // (nrt * nct)
        m, p0 = divmod(ms, nslot)
        o0, j0 = rt * RT, ct * CT
        cols = []
        for j in range(CT):
            jj = j0 + j
            if jj < ncol:
                q, r = divmod(jj, cpq)
                cols.append((comps[q], p0 + r // Td, r % Td))
            else:
                cols.append(None)
        Sm = Sm_all[m, p0 if ns == 2 else 0]
        acc = np.zeros((RT, CT))
        for kc in range(-(-I // KC)):
            i0 = kc * KC
            Ss = np.zeros((RT, KC))
            rows = np.arange(o0, min(o0 + RT, O))
            ks = np.arange(i0, min(i0 + KC, I))
            Ss[:rows.size, :ks.size] = Sm[rows][:, ks]
            Xs = np.zeros((KC, CT))
            for j, col in enumerate(cols):
                if col is not None:
                    c, p, t = col
                    Xs[:ks.size, j] = x[c, P * m + p, ks, t]
            acc += Ss @ Xs
        for w in range(C['KT_WARPS']):
            if w >= NW or j0 + w * WN >= ncol:
                continue
            for j in range(w * WN, (w + 1) * WN):
                if cols[j] is None:
                    continue
                c, p, t = cols[j]
                for rr in range(RT):
                    o = o0 + rr
                    if o < O:
                        prev = y[c, P * m + p, o, t] if accumulate else 0.0
                        y[c, P * m + p, o, t] = prev + acc[rr, j]
                        stored[c, P * m + p, o, t] += 1
    want = np.zeros(out.shape, dtype=int)
    want[list(comps)] = 1
    assert (stored == want).all()
    return y


def _real(a):
    a = np.asarray(a)
    if np.iscomplexobj(a):
        return a.view(np.float64).reshape(a.shape[:-1] + (2 * a.shape[-1],))
    return a


def _back(a, cplx):
    return a.view(np.complex128) if cplx else a


# (K, O, I, signed, complex, components of C, named components, T, SMs): ragged O, I
# and T (odd T: 8-byte copies), both stack forms, the column tiles past 128 columns,
# nine components in one launch, and a small card (larger row tiles)
CASES = [
    (5, 37, 21, False, False, 4, (2, 0), 7, 132),
    (4, 24, 16, False, False, 9, (0, 4, 8), 12, 132),
    (2, 20, 9, False, False, 3, (0, 1, 2), 48, 132),
    (6, 19, 13, True, True, 3, (1,), 5, 132),
    (3, 70, 40, True, True, 3, (0, 1, 2), 6, 3),
    (3, 53, 11, False, True, 9, tuple(range(9)), 3, 2),
    (2, 33, 18, True, False, 2, (1, 0), 9, 1),
]
# One azimuth point (K = 1, x of one row: the kernel's np = 1), shared and
# signed stacks: Lane-Emden's ball at dealias 2 (O = 64 coefficients of a
# 2-point colatitude grid, 128 radial points) and ragged shapes
CASES_M1 = [
    (1, 1, 2, False, False, 1, (0,), 128, 132),
    (1, 37, 21, False, False, 3, (2, 0), 7, 132),
    (1, 19, 13, True, True, 3, (1,), 5, 2),
    (1, 53, 11, False, True, 9, tuple(range(9)), 3, 1),
]


@pytest.mark.parametrize('accumulate', [False, True])
@pytest.mark.parametrize('case', CASES + CASES_M1)
def test_emulation_against_twin_and_jax(case, accumulate):
    K, O, I, signed, cplx, Cn, comps, T, sms = case
    P = 1 if case in CASES_M1 else 2
    rng = np.random.default_rng(K * 100 + O + T)
    S = rng.standard_normal((K, 2, O, I) if signed else (K, O, I))
    dt = np.complex128 if cplx else np.float64
    x = rng.standard_normal((Cn, P * K, I, T)).astype(dt)
    out = rng.standard_normal((Cn, P * K, O, T)).astype(dt)
    if cplx:
        x = x + 1j * rng.standard_normal(x.shape)
        out = out + 1j * rng.standard_normal(out.shape)
    Td = 2 * T if cplx else T
    plan = tpolar.kt_plan(K, O, I, 2 if signed else 1, len(comps), Td, Td % 2 == 0 and I % 2 == 0,
                          sms, P)
    got = _back(emulate(S, _real(x), _real(out), comps, accumulate, plan), cplx)
    twin = tpolar.trailing_apply(torch.tensor(S), torch.tensor(x), torch.tensor(out.copy()),
                                 comps, accumulate=accumulate).numpy()
    assert _rel(got, twin) <= TOL
    for c in comps:
        Sref = S[:, :P] if signed else S
        ref = np.asarray(ColatitudeBasis._apply_one(jnp.asarray(x[c]), jnp.asarray(Sref), 1, O))
        if accumulate:
            ref = ref + out[c]
        assert _rel(got[c], ref) <= TOL
    rest = [c for c in range(Cn) if c not in comps]
    assert np.array_equal(got[rest], out[rest])


def test_plans_at_the_cells():
    """The plans of the timed shapes: the complex shell's signed call holds
    its 108 columns in one 4-warp tile and 3 row tiles of 48 (576 blocks);
    ball64's 288 columns split into 3 tiles of 3 warps at 16 rows (288
    blocks: K = 32 fills the card only so)."""
    p = tpolar.kt_plan(96, 144, 96, 2, 3, 36, True)
    assert (p.MT, p.NW, p.nct, p.nrt, p.blocks) == (3, 4, 1, 3, 576)
    p = tpolar.kt_plan(32, 48, 32, 1, 3, 48, True)
    assert (p.MT, p.NW, p.nct, p.nrt, p.blocks) == (1, 3, 3, 3, 288)
    assert tpolar.kt_plan(96, 144, 96, 1, 3, 18, True).MT == 3
    for args in [(96, 144, 96, 2, 9, 36, True), (1, 1, 1, 1, 1, 1, False)]:
        p = tpolar.kt_plan(*args)
        assert 1 <= p.MT <= C['KT_MAX_MT'] and 1 <= p.NW <= C['KT_WARPS']
        assert p.smem <= 227 * 1024
