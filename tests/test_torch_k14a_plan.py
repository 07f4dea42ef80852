"""K14a's blocked sweep order (csrc/dense_kernels.cu lu_solve_kernel),
emulated in numpy at the kernel's tiles and sums, against the plain twin
(ops/solve.py lu_solve_plain) and dedalus_tpu.ops.solve.batched_lu_solve.

The kernel cuts the packed factors into BR x BR tiles (LuTile: 32 in f64,
16 in complex128) and runs 2 nb phases, nb = ceil(P / BR): forward over the
block rows 0 .. nb-1, backward over nb-1 .. 0. In the phase of block row p
every warp w sums its panel tiles (forward J <= p - 2, backward J >= p + 2,
J = w mod LU_WARPS) into one partial sum of the BR rows; the owner warp
(p mod LU_WARPS) then adds the adjacent tile (J = p -+ 1) and the partial
sums in warp order and solves the diagonal tile. Each warp reads its tiles
in one sequence (lu_next) through its own ring: the emulation takes every
tile from that sequence, so a tile read out of order fails here. The
constants are read from the source.
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

SRC = (pathlib.Path(tsolve.__file__).resolve().parents[1] / 'csrc'
       / 'dense_kernels.cu').read_text()
LU_WARPS = int(re.search(r'constexpr int LU_WARPS = (\d+);', SRC).group(1))
TILES = {name: (int(br), int(slots)) for name, br, slots in re.findall(
    r'struct LuTile<(double2?)> \{ static constexpr int BR = (\d+), SLOTS = (\d+); \};', SRC)}
PANEL, ADJ, DIAG = 1, 2, 3


def lu_tile(nb, sweep, p, w, t):
    """The kernel's lu_tile: (kind, J) of warp w's t-th tile in the phase
    of block row p, kind 0 past its last."""
    if sweep == 0:
        j0, n = w, ((p - 2 - w) // LU_WARPS + 1 if p - 2 >= w else 0)
    else:
        j0 = p + 2 + (w - (p + 2)) % LU_WARPS
        n = (nb - 1 - j0) // LU_WARPS + 1 if j0 <= nb - 1 else 0
    if t < n:
        return PANEL, j0 + t * LU_WARPS
    if p % LU_WARPS != w:
        return 0, None
    t -= n
    adj = p - 1 if sweep == 0 else p + 1
    if 0 <= adj < nb:
        if t == 0:
            return ADJ, adj
        t -= 1
    return (DIAG, p) if t == 0 else (0, None)


def lu_sequence(nb, w):
    """Warp w's tiles (I, J) in the order its ring streams them (lu_next)."""
    for sweep in (0, 1):
        for q in range(nb):
            p = q if sweep == 0 else nb - 1 - q
            t = 0
            while True:
                kind, J = lu_tile(nb, sweep, p, w, t)
                if not kind:
                    break
                yield p, J
                t += 1


def emulate_lu_solve(lu, perm, R, br):
    """lu_solve_kernel on the CPU: each lane's row sums in column order
    (even and odd columns apart; in complex128 two lanes a row, half the
    columns each, met at the end of the phase), the partial sums added in
    warp order, the diagonal tile's BR dependent steps (backward: times each
    row's reciprocal of its diagonal entry)."""
    G, P = R.shape
    nb = -(-P // br)
    n = nb * br
    cw = br * br // 32                      # columns a lane takes
    halves = br // cw
    out = np.empty_like(R)
    for g in range(G):
        M = np.zeros((n, n), dtype=lu.dtype)
        M[:P, :P] = lu[g]
        x = np.zeros(n, dtype=R.dtype)
        x[:P] = R[g, perm[g]]
        seqs = [lu_sequence(nb, w) for w in range(LU_WARPS)]

        def take(w, I, J):
            assert next(seqs[w]) == (I, J)
            return M[I * br:(I + 1) * br, J * br:(J + 1) * br]

        def tile_dot(T, J):
            xj = x[J * br:(J + 1) * br]
            parts = []
            for h in range(halves):
                a0 = np.zeros(br, dtype=R.dtype)
                a1 = np.zeros(br, dtype=R.dtype)
                for c in range(h * cw, (h + 1) * cw, 2):
                    a0 = a0 + T[:, c] * xj[c]
                    a1 = a1 + T[:, c + 1] * xj[c + 1]
                parts.append(a0 + a1)
            return parts

        def lanes_sum(parts):
            # the xor tree over the lanes of a row (offsets BR, 2 BR, ...)
            off = 1
            while off < halves:
                parts = [parts[h] + parts[h ^ off] for h in range(halves)]
                off *= 2
            return parts[0]

        for sweep in (0, 1):
            for q in range(nb):
                p = q if sweep == 0 else nb - 1 - q
                part = np.zeros((LU_WARPS, br), dtype=R.dtype)
                for w in range(LU_WARPS):
                    acc = [np.zeros(br, dtype=R.dtype)] * halves
                    t = 0
                    while (tile := lu_tile(nb, sweep, p, w, t))[0] == PANEL:
                        acc = [a + d for a, d in zip(acc, tile_dot(take(w, p, tile[1]), tile[1]))]
                        t += 1
                    part[w] = lanes_sum(acc)
                owner = p % LU_WARPS
                adj = p - 1 if sweep == 0 else p + 1
                tot = np.zeros(br, dtype=R.dtype)
                if 0 <= adj < nb:
                    tot = lanes_sum(tile_dot(take(owner, p, adj), adj))
                s = np.zeros(br, dtype=R.dtype)
                for w in range(LU_WARPS):
                    s = s + part[w]
                rows = p * br + np.arange(br)
                valid = rows < P
                y = np.where(valid, x[rows] - (s + tot), 0)
                D = take(owner, p, p)
                r = np.arange(br)
                if sweep == 0:
                    for c in range(br - 1):
                        y = np.where(r > c, y - D[:, c] * y[c], y)
                else:
                    inv = 1.0 / np.where(valid, np.diagonal(D), 1.0)
                    for c in range(br - 1, -1, -1):
                        if valid[c]:
                            y[c] = y[c] * inv[c]
                        y = np.where(r < c, y - D[:, c] * y[c], y)
                x[rows[valid]] = y[valid]
        assert all(next(sq, None) is None for sq in seqs)
        out[g] = x[:P]
    return out


def _stack(G, P, dtype, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((G, P, P)) / np.sqrt(P)
    R = rng.standard_normal((G, P))
    if dtype == np.complex128:
        A = A + 1j * rng.standard_normal((G, P, P)) / np.sqrt(P)
        R = R + 1j * rng.standard_normal((G, P))
    return A + 4 * np.eye(P), R


def test_tile_constants_match_source():
    """The kernel's tiles: 32 rows in f64, 16 in complex128 (8 KB and 4 KB),
    three slots a warp; with the unknowns padded to whole tiles (rbc256's
    P = 525, rbc256c's 263) the shared bytes of a block fit the card, and
    two complex blocks an SM."""
    assert TILES == {'double': (32, 3), 'double2': (16, 3)}
    assert int(re.search(r'LU_SMEM = (\d+) \* 1024;', SRC).group(1)) == 227
    assert 'LD = sizeof(T) == 8 ? BR + 2 : BR + 1;' in SRC
    smem = {name: (2 * LU_WARPS * br + LU_WARPS * slots * br * (br + 2 if size == 8 else br + 1)
                   + -(-P // br) * br) * size
            for (name, (br, slots)), size, P in zip(TILES.items(), (8, 16), (525, 263))}
    assert smem['double'] <= 227 * 1024
    assert 2 * (smem['double2'] + 1024) <= 228 * 1024


@pytest.mark.parametrize('nb', [1, 2, 3, 8, 9, 17, 40])
def test_every_tile_is_read_once_a_sweep(nb):
    """The warps' sequences cover the lower triangle's tiles (diagonal
    included) in the forward sweep and the upper's in the backward, each
    once, and each phase's owner reads its row's adjacent tile and then its
    diagonal tile last."""
    seen = {}
    for w in range(LU_WARPS):
        for I, J in lu_sequence(nb, w):
            seen[(I, J)] = seen.get((I, J), 0) + 1
            if I == J:
                assert I % LU_WARPS == w
    want = {(I, J): 2 if I == J else 1 for I in range(nb) for J in range(nb)}
    assert seen == want


@pytest.mark.parametrize('G,P', [(2, 1), (2, 31), (2, 32), (3, 33), (2, 100), (1, 525)])
def test_emulation_f64_against_twin_and_reference(G, P):
    A, R = _stack(G, P, np.float64, seed=P)
    jlu, jperm = jsolve.host_lu_factor_stack(A)
    lu, perm = tsolve.lu_factor_stack(torch.as_tensor(A))
    got = emulate_lu_solve(lu.numpy(), perm.numpy(), R, TILES['double'][0])
    twin = tsolve.lu_solve(lu, perm, torch.as_tensor(R)).numpy()
    ref = np.asarray(jsolve.batched_lu_solve(jlu, jperm, jnp.asarray(R)))
    scale = np.abs(ref).max()
    assert np.abs(got - twin).max() <= 1e-12 * scale
    assert np.abs(got - ref).max() <= 1e-12 * scale


@pytest.mark.parametrize('G,P', [(2, 15), (2, 16), (3, 47), (1, 263)])
def test_emulation_complex128_against_twin_and_reference(G, P):
    A, R = _stack(G, P, np.complex128, seed=P)
    jlu, jperm = jsolve.host_lu_factor_stack(A)
    lu, perm = tsolve.lu_factor_stack(torch.as_tensor(A))
    got = emulate_lu_solve(lu.numpy(), perm.numpy(), R, TILES['double2'][0])
    twin = tsolve.lu_solve(lu, perm, torch.as_tensor(R)).numpy()
    ref = np.asarray(jsolve.batched_lu_solve(jlu, jperm, jnp.asarray(R)))
    scale = np.abs(ref).max()
    assert np.abs(got - twin).max() <= 1e-12 * scale
    assert np.abs(got - ref).max() <= 1e-12 * scale


def issue_f64(lu_flat, goff, P, I, J, br):
    """lu_issue's f64 form on the CPU: each row by 16-byte chunks from the
    16-byte boundary at or before it (BR / 2 + 1 chunks; the bytes of a
    chunk past the tile's columns or P zero-filled) into a slot of rows
    BR + 2 apart."""
    ld, ch = br + 2, br // 2 + 1
    slot = np.full(br * ld, np.nan)
    ncol = min(br, P - J * br)
    for e in range(br * ch):
        r, q = divmod(e, ch)
        i = I * br + r
        off = goff + i * P + J * br
        sh = off & 1
        c = 2 * q - sh
        nbytes = 0 if (i >= P or c >= ncol) else (8 if c + 1 >= ncol else 16)
        src = lu_flat[off - sh + 2 * q:off - sh + 2 * q + 2] if nbytes else np.zeros(2)
        slot[r * ld + 2 * q:r * ld + 2 * q + 2] = [src[0] if nbytes else 0.0,
                                                   src[1] if nbytes == 16 else 0.0]
    return slot.reshape(br, ld)


@pytest.mark.parametrize('G,P', [(3, 525), (2, 40), (2, 64)])
def test_f64_rows_land_at_their_phase(G, P):
    """Every element of a tile lands at row r, column lu_shift + c of its
    slot (the row's 8-byte phase in the factors), zero past the tile's
    columns and past P; the slot is written whole."""
    br = TILES['double'][0]
    lu_flat = np.arange(1, G * P * P + 1, dtype=np.float64)
    nb = -(-P // br)
    for g in range(G):
        for I, J in ((0, 0), (nb - 1, 0), (nb - 1, nb - 1), (1, nb - 1)):
            slot = issue_f64(lu_flat, g * P * P, P, I, J, br)
            assert not np.isnan(slot).any()
            for r in range(br):
                i = I * br + r
                sh = (g * P * P + i * P + J * br) & 1
                for c in range(br):
                    j = J * br + c
                    want = lu_flat[g * P * P + i * P + j] if (i < P and j < P) else 0.0
                    assert slot[r, sh + c] == want
