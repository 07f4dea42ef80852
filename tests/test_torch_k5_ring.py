"""K5's ring (csrc/banded_kernels.cu block_tridiag_qr_solve_kernel, planned by
dedalus_tpu_torch/ops/banded.py k5_plan), emulated in numpy at the kernel's
own shared-memory addresses, against the plain twin and the JAX package's
block_tridiag_qr_solve (dedalus_tpu/ops/banded.py:485).

The kernel runs only on the card: one warp a group walks the forward sweep
(Qt_i and r_{i+1} a step, QtL last) and the backward sweep (R1_i, R2_i,
Rinv_i and y_i a step) through a ring of `stages` slots, issuing step s + S
- 1 into the slot step s - 1 used. A block lands in its region at the phase
of its address within a 16-byte line (the layout keeps the factors as K8a
writes them: a 19x19 f32 block is 1444 bytes, so most blocks start off a
16-byte line); its whole 16-byte spans copy 16 bytes at a time, the elements
before the first and after the last span one by one. The emulation checks
each copy's alignment and bounds, that a slot is refilled only after its step
was applied, and sums each row in the kernel's column order in the factor
type. Tolerances: 1e-5 relative in f32 (chip_smoke.py's TOL), 1e-12 in f64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import dedalus_tpu.ops.banded as jb
import dedalus_tpu_torch.ops.banded as tb

torch.set_num_threads(1)

KEYS = ('Qt', 'QtL', 'Rinv', 'R1', 'R2')
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Ring:
    """One warp's slice: `stages` slots of plan['slot'] elements, each copy
    emulated as k5_copy issues it (tensors start on a 16-byte line)."""

    def __init__(self, plan, dtype):
        self.p = plan
        self.it = np.dtype(dtype).itemsize
        self.mem = np.full(plan['stages'] * plan['slot'], np.nan, dtype=dtype)
        self.owner = [None] * plan['stages']

    def land(self, region, e0):
        return region + (e0 * self.it % 16) // self.it

    def copy(self, region, size, src, e0, n):
        A = self.p['A']
        assert region * self.it % 16 == 0
        phase = (e0 * self.it % 16) // self.it
        dst = region + phase
        assert phase + n <= size, "a block runs past its region"
        head = min(n, (A - phase) & (A - 1))
        tail = head + (n - head) // A * A
        done = np.zeros(n, dtype=np.int64)
        for k in range(head, tail, A):
            assert (e0 + k) * self.it % 16 == 0 and (dst + k) * self.it % 16 == 0
            self.mem[dst + k:dst + k + A] = src[e0 + k:e0 + k + A]
            done[k:k + A] += 1
        for k in list(range(head)) + list(range(tail, n)):
            self.mem[dst + k] = src[e0 + k]
            done[k] += 1
        assert (done == 1).all()

    def issue(self, step, now, fill):
        s = step % self.p['stages']
        assert self.owner[s] is None or self.owner[s] < now, "a slot refilled before its use"
        fill(s * self.p['slot'])
        self.owner[s] = step

    def take(self, step):
        s = step % self.p['stages']
        assert self.owner[s] == step
        return s * self.p['slot']


def _rows(M, ld, nrows, a, b, dtype):
    """k5_rows: rows of M (row stride ld) times [a; b], summed in column
    order in the factor type."""
    out = np.zeros(nrows, dtype=dtype)
    q = M[:nrows * ld].reshape(nrows, ld)
    for c in range(len(a)):
        out = (out + q[:, c] * a[c]).astype(dtype)
    for c in range(len(b)):
        out = (out + q[:, len(a) + c] * b[c]).astype(dtype)
    return out


def emulate(Qt, QtL, Rinv, R1, R2, r):
    G, Nb, nb = r.shape
    dtype = r.dtype.type
    plan = tb.k5_plan(nb, r.itemsize)
    S, RQ, RB = plan['stages'], plan['RQ'], plan['RB']
    RV = tb.k5_region(nb, r.itemsize)
    f = {k: np.ascontiguousarray(v).reshape(-1) for k, v in zip(KEYS, (Qt, QtL, Rinv, R1, R2))}
    rf = np.ascontiguousarray(r).reshape(-1)
    xf = np.full(G * Nb * nb, np.nan, dtype=dtype)
    bsz, m2 = nb * nb, 4 * nb * nb
    for g in range(G):
        ring = Ring(plan, dtype)
        mem = ring.mem

        def fwd(i):
            def fill(s0):
                if i < Nb - 1:
                    ring.copy(s0, RQ, f['Qt'], (g * (Nb - 1) + i) * m2, m2)
                    ring.copy(s0 + RQ, RV, rf, (g * Nb + i + 1) * nb, nb)
                else:
                    ring.copy(s0, RQ, f['QtL'], g * bsz, bsz)
            return fill

        now = 0
        for i in range(S - 1):
            if i < Nb:
                ring.issue(i, now, fwd(i))
        v = rf[g * Nb * nb:g * Nb * nb + nb].copy()
        for i in range(Nb):
            now = i
            if i + S - 1 < Nb:
                ring.issue(i + S - 1, now, fwd(i + S - 1))
            s0 = ring.take(i)
            y0 = (g * Nb + i) * nb
            if i < Nb - 1:
                Q = mem[ring.land(s0, (g * (Nb - 1) + i) * m2):]
                rn = mem[ring.land(s0 + RQ, (g * Nb + i + 1) * nb):][:nb]
                w = _rows(Q, 2 * nb, 2 * nb, v, rn, dtype)
                xf[y0:y0 + nb] = w[:nb]
                v = w[nb:]
            else:
                Q = mem[ring.land(s0, g * bsz):]
                xf[y0:y0 + nb] = _rows(Q, nb, nb, v, [], dtype)

        ring = Ring(plan, dtype)
        mem = ring.mem

        def bwd(k):
            i = Nb - 1 - k

            def fill(s0):
                e = (g * Nb + i) * bsz
                ring.copy(s0, RB, f['R1'], e, bsz)
                ring.copy(s0 + RB, RB, f['R2'], e, bsz)
                ring.copy(s0 + 2 * RB, RB, f['Rinv'], e, bsz)
                ring.copy(s0 + 3 * RB, RV, xf, (g * Nb + i) * nb, nb)
            return fill

        for k in range(S - 1):
            if k < Nb:
                ring.issue(k, 0, bwd(k))
        xa, xb = np.zeros(nb, dtype=dtype), np.zeros(nb, dtype=dtype)
        for k in range(Nb):
            if k + S - 1 < Nb:
                ring.issue(k + S - 1, k, bwd(k + S - 1))
            i = Nb - 1 - k
            s0 = ring.take(k)
            e = (g * Nb + i) * bsz
            A1 = mem[ring.land(s0, e):][:bsz].reshape(nb, nb)
            A2 = mem[ring.land(s0 + RB, e):][:bsz].reshape(nb, nb)
            Ai = mem[ring.land(s0 + 2 * RB, e):]
            y = mem[ring.land(s0 + 3 * RB, (g * Nb + i) * nb):][:nb]
            s1, s2 = np.zeros(nb, dtype=dtype), np.zeros(nb, dtype=dtype)
            for c in range(nb):
                s1 = (s1 + A1[:, c] * xa[c]).astype(dtype)
                s2 = (s2 + A2[:, c] * xb[c]).astype(dtype)
            t = ((y - s1) - s2).astype(dtype)
            xi = _rows(Ai, nb, nb, t, [], dtype)
            xf[(g * Nb + i) * nb:(g * Nb + i + 1) * nb] = xi
            xa, xb = xi, xa
    return xf.reshape(G, Nb, nb)


def _factors(G, Nb, nb, seed):
    rng = np.random.default_rng(seed)
    diag = rng.standard_normal((G, Nb, nb, nb)) + 4 * np.eye(nb)
    sub = rng.standard_normal((G, Nb, nb, nb))
    sub[:, 0] = 0
    sup = rng.standard_normal((G, Nb, nb, nb))
    sup[:, -1] = 0
    P = Nb * nb
    order = dict(col_perm=np.arange(P), row_perm=np.arange(P), n_border=0, n_core=P,
                 bcol_first=False)
    blocks = jb.BandedBlocks(diag, sub, sup, np.zeros((G, P, 0)), np.zeros((G, 0, P)),
                             order, nb, 0)
    return jb._factor_host(blocks)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('G,Nb,nb', [(3, 7, 19), (2, 5, 7), (2, 1, 19), (2, 3, 33)])
def test_ring_matches_twin_and_jax(dtype, G, Nb, nb):
    qr = _factors(G, Nb, nb, seed=nb + Nb)
    fac = [np.asarray(qr[k], dtype=dtype) for k in KEYS]
    r = np.random.default_rng(nb).standard_normal((G, Nb, nb)).astype(dtype)
    got = emulate(*fac, r)
    twin = tb.block_tridiag_qr_solve(*map(torch.as_tensor, fac), torch.as_tensor(r)).numpy()
    assert _rel(got, twin) <= TOL[dtype]
    ref = np.asarray(jb.block_tridiag_qr_solve(*map(jnp.asarray, fac), jnp.asarray(r)))
    assert _rel(got, ref) <= TOL[dtype]


def test_plan_at_the_main_paths_blocks():
    """nb = 19 (RBC 2048x512 and 2048x2048): four slots, 23.9 KB a warp in
    f32 (nine groups an SM), 47 KB in f64; fewer slots where a wide block
    leaves no room, and the direct path (no ring, 4 nb carry elements) where
    none fits two."""
    p32, p64 = tb.k5_plan(19, 4), tb.k5_plan(19, 8)
    assert (p32['stages'], p32['slot'], p32['smem']) == (4, 1472, 23856)
    assert (p64['stages'], p64['slot']) == (4, 1466)
    assert p32['smem'] * 9 <= 228 * 1024
    assert tb.k5_plan(61, 4)['stages'] == 3
    direct = tb.k5_plan(128, 8)
    assert (direct['stages'], direct['direct'], direct['smem']) == (0, True, 4 * 128 * 8)
