"""K8a's and K8b's device programs (csrc/banded_kernels.cu
block_tridiag_qr_factor_kernel, multi_rhs_solve_kernel), emulated in numpy
at their own sums, against the plain twins (ops/banded.py) and the JAX
package's _factor_device and _multi_rhs_solve_device
(dedalus_tpu/ops/banded.py:364, :454); and their plans.

K8a, a step: the P warp factors the panel [C_i ; sub_{i+1}] a lane a
column (LAPACK's dlarfg signs, tau = 0 on a column already zero below its
diagonal): each reflector's dot product down a column in four partial sums
by (r - j) mod 4, the update, and the next column's norm summed in the same
pass in four partial sums; the T and Q warps apply each reflector, in the
same sums, to Pn's 2nb columns (R1, R2 on top, C_{i+1}, S_{i+1} below) and
to the identity's (Q^T); the R warp pins R's diagonal against the running
scale and inverts R a column at a time, bottom row up. K8b: every product
on m16n8k4 tensor-core tiles, K in steps of 4 in order: forward [y ; carry]
= Qt [carry ; rhs], backward t = y - [R1 R2] [x1 ; x2], x = Rinv t. The
emulation takes a sum of four products a tile step (the tensor cores' own
rounding inside a step is not emulated: held at tolerance). The constants
are read from the source.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import dedalus_tpu.ops.banded as jb

import dedalus_tpu_torch.ops.banded as tb

torch.set_num_threads(1)

SRC = (pathlib.Path(tb.__file__).resolve().parents[1] / 'csrc'
       / 'banded_kernels.cu').read_text()
K8B_MAX_WARPS = int(re.search(r'constexpr int K8B_MAX_WARPS = (\d+);', SRC).group(1))
K8B_SLOTS = int(re.search(r'constexpr int K8B_SLOTS = (\d+);', SRC).group(1))
EPS = np.finfo(np.float64).eps


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def blocks(G, Nb, nb, seed, pinned=False):
    """Seeded near-4I diagonal blocks, smaller off-diagonal ones (sub[:, 0]
    = sup[:, -1] = 0); `pinned`: the first panel's column 1 and block 1's
    column 2 zero, so their pivots are exactly 0 and pinned."""
    rng = np.random.default_rng(seed)
    r = lambda: rng.standard_normal((G, Nb, nb, nb)) / np.sqrt(nb)
    diag = 4 * np.eye(nb) + r()
    sub, sup = 0.5 * r(), 0.5 * r()
    sub[:, 0] = 0.0
    sup[:, -1] = 0.0
    if pinned:
        diag[:, 0, :, 1] = 0.0
        sub[:, 1, :, 1] = 0.0
        diag[:, 1, :, 2] = 0.0
        sub[:, 2, :, 2] = 0.0
        sup[:, 0, :, 2] = 0.0
    return diag, sub, sup


# --- K8a ---

def k8_dot(A, j, M, m):
    """k8_dot for every column of M: v^T M[j:], v = (1, A[j+1:m, j])."""
    s = [M[j].copy(), np.zeros(M.shape[1]), np.zeros(M.shape[1]), np.zeros(M.shape[1])]
    for r in range(j + 1, m):
        s[(r - j) & 3] = s[(r - j) & 3] + A[r, j] * M[r]
    return (s[0] + s[1]) + (s[2] + s[3])


def k8_update(A, j, M, m, w):
    """k8_update for every column: M[j:] -= v w; returns the new rows j + 2
    .. m-1's sums of squares in four partial sums by (r - j - 2) mod 4."""
    M[j] = M[j] - w
    if j + 1 < m:
        M[j + 1] = M[j + 1] - A[j + 1, j] * w
    s = [np.zeros(M.shape[1]) for _ in range(4)]
    for r in range(j + 2, m):
        M[r] = M[r] - A[r, j] * w
        s[(r - j - 2) & 3] = s[(r - j - 2) & 3] + M[r] * M[r]
    return (s[0] + s[1]) + (s[2] + s[3])


def k8_norm2(M, c, m):
    s = [0.0] * 4
    for r in range(c + 1, m):
        s[(r - c - 1) & 3] += M[r, c] * M[r, c]
    return (s[0] + s[1]) + (s[2] + s[3])


def k8_panel(A, m, nb):
    """The P warp on the m x nb panel A (in place): (tau, beta)."""
    tau, beta = np.zeros(nb), np.zeros(nb)
    ss = k8_norm2(A, 0, m)
    for j in range(nb):
        alpha = A[j, j]
        t, bj, scal = 0.0, alpha, 0.0
        if ss != 0.0:
            bj = -np.copysign(np.sqrt(alpha * alpha + ss), alpha)
            t = (bj - alpha) / bj
            scal = 1.0 / (alpha - bj)
        if t != 0.0:
            A[j + 1:m, j] *= scal
        tau[j], beta[j] = t, bj
        if j + 1 < nb:
            later = A[:m, j + 1:]
            if t != 0.0:
                ss = k8_update(A, j, later, m, t * k8_dot(A, j, later, m))[0]
            else:
                ss = k8_norm2(A, j + 1, m)
            A[:m, j + 1:] = later
    return tau, beta


def k8_apply(A, tau, M, m):
    """The T or Q warps: every reflector of the panel A on M's columns."""
    for j in range(len(tau)):
        if tau[j] != 0.0:
            k8_update(A, j, M, m, tau[j] * k8_dot(A, j, M, m))


def k8_pin_invert(A, beta, runmax, pin_tol):
    """The R warp: (pins, sigma, Rinv, runmax) of one step's R."""
    nb = len(beta)
    d = np.abs(beta)
    runmax = d.max() if np.isnan(d).any() else max(runmax, d.max())
    scale = max(runmax, 1e-300)
    p = np.abs(beta) < pin_tol * scale
    delta = np.where(p, scale - beta, 0.0)
    dg = beta + delta
    Ri = np.zeros((nb, nb))
    for c in range(nb):
        for r in range(c, -1, -1):
            acc = 1.0 if r == c else 0.0
            for k in range(c, r, -1):
                acc -= A[r, k] * Ri[k, c]
            Ri[r, c] = acc / dg[r]
    return p, delta, Ri, runmax


def emulate_k8a(diag, sub, sup, pin_tol=1e-8):
    """block_tridiag_qr_factor_kernel on the CPU, one group after another,
    each step by its warps' sums (the P warp's panel, the T warps on Pn, the
    Q warps on the identity, the R warp's pins and R^-1)."""
    G, Nb, nb, _ = diag.shape
    n2 = 2 * nb
    out = dict(Qt=np.zeros((G, Nb - 1, n2, n2)), QtL=np.zeros((G, nb, nb)),
               Rinv=np.zeros((G, Nb, nb, nb)), R1=np.zeros((G, Nb, nb, nb)),
               R2=np.zeros((G, Nb, nb, nb)), pins=np.zeros((G, Nb, nb), bool),
               sigma=np.zeros((G, Nb, nb)))
    for g in range(G):
        runmax = 0.0
        A = np.concatenate([diag[g, 0], sub[g, 1]]) if Nb > 1 else diag[g, 0].copy()
        Pn = np.zeros((n2, n2))
        if Nb > 1:
            Pn[:nb, :nb], Pn[nb:, :nb], Pn[nb:, nb:] = sup[g, 0], diag[g, 1], sup[g, 1]
        for i in range(Nb):
            m = nb if i == Nb - 1 else n2
            tau, beta = k8_panel(A, m, nb)
            Q = np.eye(m)
            k8_apply(A, tau, Q, m)
            p, delta, Ri, runmax = k8_pin_invert(A, beta, runmax, pin_tol)
            out['pins'][g, i], out['sigma'][g, i], out['Rinv'][g, i] = p, delta, Ri
            if i == Nb - 1:
                out['QtL'][g] = Q
                break
            k8_apply(A, tau, Pn, m)
            out['Qt'][g, i] = Q
            out['R1'][g, i], out['R2'][g, i] = Pn[:nb, :nb], Pn[:nb, nb:]
            A = Pn[nb:, :nb].copy()
            if i + 2 < Nb:
                A = np.concatenate([A, sub[g, i + 2]])
                S = Pn[nb:, nb:].copy()
                Pn = np.zeros((n2, n2))
                Pn[:nb, :nb], Pn[nb:, :nb], Pn[nb:, nb:] = S, diag[g, i + 2], sup[g, i + 2]
    return out


def check_k8a(got, ref):
    """K8a's tolerances (chip_smoke.check_k8's): the rotations at 1e-11,
    Rinv and QtL at 10 eps growth, the pins equal."""
    growth = float(np.abs(ref['Rinv']).max())
    for key in ('Qt', 'R1', 'R2', 'sigma'):
        if np.asarray(ref[key]).size and np.abs(np.asarray(ref[key])).max() > 0:
            assert _rel(got[key], ref[key]) <= 1e-11, key
    for key in ('Rinv', 'QtL'):
        assert _rel(got[key], ref[key]) <= max(1e-11, 10 * EPS * growth), key
    assert np.array_equal(np.asarray(got['pins']), np.asarray(ref['pins']))


@pytest.mark.parametrize('nb', [4, 19, 39])
@pytest.mark.parametrize('pinned', [False, True])
def test_k8a_emulation_against_twin_and_reference(nb, pinned):
    diag, sub, sup = blocks(2, 3, nb, seed=40 + nb, pinned=pinned)
    got = emulate_k8a(diag, sub, sup)
    assert got['pins'].any() == pinned
    twin = tb.factor_block_tridiag_qr_plain(*(torch.as_tensor(a) for a in (diag, sub, sup)))
    check_k8a(got, {k: v.numpy() for k, v in twin.items()})
    ref = jb._factor_device(*(jnp.asarray(a) for a in (diag, sub, sup)))
    check_k8a(got, {k: np.asarray(v) for k, v in ref.items()})


def test_k8a_emulation_one_block():
    """Nb = 1: the last block's QR alone (QtL, Rinv)."""
    diag, sub, sup = blocks(2, 1, 5, seed=47)
    got = emulate_k8a(diag, sub, sup)
    twin = tb.factor_block_tridiag_qr_plain(*(torch.as_tensor(a) for a in (diag, sub, sup)))
    check_k8a(got, {k: v.numpy() for k, v in twin.items()})


def test_k8_plan_fields():
    """The shared path to nb = 39 (the kernel's k8_step_doubles in 227 KB),
    the workspace past it."""
    assert re.search(r'return 18LL \* nb \* nb \+ 7LL \* nb;', SRC)
    for nb in (1, 4, 16, 17, 19, 39, 40, 96, 300):
        plan = tb.k8_plan(nb)
        assert plan['general'] == (nb > 39)
        assert plan['smem'] == (0 if nb > 39 else (18 * nb * nb + 7 * nb) * 8) <= tb.K5_SMEM
        assert plan['workspace'] == (18 * nb * nb + 7 * nb if nb > 39 else 0)


# --- K8b ---

def tile_product(A, B):
    """A @ B with K in steps of 4, each step's four products summed first in
    order, entry by entry (a column's sums do not depend on the others)."""
    acc = np.zeros((A.shape[0], B.shape[1]))
    for kk in range(0, A.shape[1], 4):
        step = A[:, kk, None] * B[kk]
        for q in range(kk + 1, min(kk + 4, A.shape[1])):
            step = step + A[:, q, None] * B[q]
        acc = acc + step
    return acc


def emulate_k8b(qr, Rhs, kc):
    """multi_rhs_solve_kernel on the CPU, chunk by chunk of kc columns: the
    forward [y_i ; carry] = Qt_i [carry ; rhs_{i+1}], y_{Nb-1} = QtL carry,
    the backward t = y_i - [R1_i R2_i] [x_{i+1} ; x_{i+2}], x_i = Rinv_i t,
    every product by tile_product."""
    Qt, QtL, Rinv, R1, R2 = (qr[k].numpy() for k in tb.FACTOR_KEYS)
    G, Nb, nb, k = Rhs.shape
    X = np.full(Rhs.shape, np.nan)
    for c0 in range(0, k, kc):
        cols = slice(c0, min(k, c0 + kc))
        for g in range(G):
            carry = Rhs[g, 0, :, cols]
            for i in range(Nb - 1):
                out = tile_product(Qt[g, i], np.concatenate([carry, Rhs[g, i + 1, :, cols]]))
                X[g, i, :, cols], carry = out[:nb], out[nb:]
            X[g, Nb - 1, :, cols] = tile_product(QtL[g], carry)
            x1 = x2 = np.zeros_like(carry)
            for i in range(Nb - 1, -1, -1):
                t = X[g, i, :, cols] - tile_product(np.concatenate([R1[g, i], R2[g, i]], axis=1),
                                                    np.concatenate([x1, x2]))
                x1, x2 = tile_product(Rinv[g, i], t), x1
                X[g, i, :, cols] = x1
    return X


@pytest.mark.parametrize('nb', [4, 19, 39])
def test_k8b_emulation_against_twin_and_reference(nb):
    diag, sub, sup = blocks(2, 3, nb, seed=50 + nb)
    qr = tb.factor_block_tridiag_qr(*(torch.as_tensor(a) for a in (diag, sub, sup)))
    k = 26
    Rhs = np.random.default_rng(60 + nb).standard_normal((2, 3, nb, k))
    one = emulate_k8b(qr, Rhs, k)
    for kc in (8, 10):
        assert np.array_equal(emulate_k8b(qr, Rhs, kc), one)
    assert _rel(one, tb.multi_rhs_solve(qr, torch.as_tensor(Rhs)).numpy()) <= 1e-11
    ref = np.asarray(jb._multi_rhs_solve_device(
        *(jnp.asarray(qr[key].numpy()) for key in tb.FACTOR_KEYS), jnp.asarray(Rhs)))
    assert _rel(one, ref) <= 1e-11


def test_k8b_plan_fields():
    """The ring: staged while two slots of 4 nb^2 + nb kc doubles and the 4
    nb kc vector doubles fit (nb <= 59), up to K8B_SLOTS slots; chunks of at
    most 8 K8B_MAX_WARPS columns (the source's), 8 a warp."""
    per = tb.K5_SMEM // 8
    assert tb.K8B_MAX_COLS == 8 * K8B_MAX_WARPS and tb.K8B_SLOTS == K8B_SLOTS
    assert re.search(r'return 4LL \* nb \* nb \+ \(long long\)nb \* kc;', SRC)
    rbc = tb.k8b_plan(19, 26)
    assert rbc == dict(staged=True, kc=26, chunks=1, slots=tb.K8B_SLOTS,
                       smem=(tb.K8B_SLOTS * (4 * 361 + 19 * 26) + 4 * 19 * 26) * 8,
                       general=False)
    assert tb.k8b_plan(59, 2)['staged'] and not tb.k8b_plan(60, 2)['staged']
    for nb, k in ((4, 1), (19, 26), (19, 400), (39, 26), (59, 2), (60, 2), (96, 360)):
        plan = tb.k8b_plan(nb, k)
        assert plan['kc'] <= tb.K8B_MAX_COLS and plan['smem'] <= tb.K5_SMEM
        assert plan['chunks'] == -(-k // plan['kc'])
        if plan['staged']:
            assert 2 <= plan['slots'] <= tb.K8B_SLOTS
            assert (plan['slots'] + 1) * (4 * nb * nb + nb * plan['kc']) \
                + 4 * nb * plan['kc'] > per or plan['slots'] == tb.K8B_SLOTS
        else:
            assert plan['slots'] == 0
    wide = tb.k8b_plan(19, 400)
    assert wide['kc'] == tb.K8B_MAX_COLS and wide['chunks'] == 4 and wide['general']
    forced = tb.k8b_plan(19, 26, staged=True, kc=10)
    assert forced['slots'] == tb.K8B_SLOTS and forced['chunks'] == 3
