"""K11b's launch plans (dedalus_tpu_torch/ops/fft.py conversion_apply and
conversion_solve on the card), emulated in numpy at the kernels' own
addresses, against the plain twins and the JAX package's
banded_shift_matmul and blocked_upper_solve (dedalus_tpu/ops/fft64.py).

csrc/conversion_kernels.cu runs only on the card. Its plans are the host
constants of ops/fft.py (K11_*, checked against the source's k11_geometry at
the first launch) and the band's dense solve form
(`ConversionBand.solve_rows_host`: the reciprocal of the main diagonal, a
row per offset up to `width`). The emulations walk the same tiles, ring
slots, chunks and carries with the same index arithmetic and the same order
of rounded operations:

- the apply: a block a tile of K11_APPLY_TILE points of a slab, the band's
  columns of the tile staged, K11_APPLY_SLABS slabs a block (a grid capped
  in y walks the rest): bit for bit the plain twin;
- the solve: a warp a tile of 32 lines (consecutive lines along the last
  axis, consecutive inner indices of a slab along another), chunks of
  K11_CHUNK points from the end of the lines, with the band's columns of the
  chunk, into a ring of K11_SOLVE_STAGES slots issued K11_SOLVE_STAGES - 1
  chunks ahead (a slot is refilled only after its chunk was walked and
  stored), a carry of `width` values a line.

Tolerance 1e-12 relative to the largest reference value, as
tests/test_fast_transforms.py holds the JAX package's conversion.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dedalus_tpu.core import basis as JB
from dedalus_tpu.core.coords import Coordinate as JCoordinate
from dedalus_tpu.ops import fft64
from dedalus_tpu_torch.core import basis as TB
from dedalus_tpu_torch.core.coords import Coordinate as TCoordinate
from dedalus_tpu_torch.ops import fft as F

torch.set_num_threads(1)

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _lines(shape, axis):
    axis = axis % len(shape)
    return (axis, int(np.prod(shape[:axis], dtype=np.int64)), shape[axis],
            int(np.prod(shape[axis + 1:], dtype=np.int64)))


def emulate_apply(band, x, axis, grid_y_cap=65535):
    """k11_conversion_apply_f64 on the CPU: y as the kernel stores it (NaN
    where no thread stores)."""
    axis, outer, N, inner = _lines(x.shape, axis)
    M, ndiag = band.M, len(band.offsets)
    D, offs = band.diags, band.offsets
    T, SL = F.K11_APPLY_TILE, F.K11_APPLY_SLABS
    xf = np.ascontiguousarray(x).reshape(-1)
    per = M * inner
    y = np.full(outer * per, np.nan)
    stores = np.zeros(outer * per, dtype=np.int64)
    tiles = -(-per // T)
    grid_y = min(-(-outer // SL), grid_y_cap)
    tid = np.arange(T)
    for bx in range(tiles):
        p0 = bx * T
        mlo = p0 // inner
        last = min(per, p0 + T) - 1
        span = last // inner + 1 - mlo
        assert 0 < span <= T
        sD = np.full((ndiag, T), np.nan)
        sD[:, :span] = D[:, mlo:mlo + span]
        p = p0 + tid
        p = p[p < per]
        m = p // inner
        i = p - m * inner
        col = m - mlo
        assert col.min() >= 0 and col.max() < span
        for by in range(grid_y):
            for o in range(by * SL, outer, grid_y * SL):
                for oo in range(o, min(outer, o + SL)):
                    acc = np.zeros(len(p))
                    for d in range(ndiag):
                        src = m + offs[d]
                        ok = (src >= 0) & (src < N)
                        xv = xf[oo * N * inner + np.where(ok, src, 0) * inner + i]
                        acc = np.where(ok, acc + sD[d, col] * xv, acc)
                    y[oo * per + p] = acc
                    stores[oo * per + p] += 1
    assert (stores == 1).all()
    return y.reshape(x.shape[:axis] + (M,) + x.shape[axis + 1:])


def _step(d, W, bm, carry):
    """solve_step on the band's column d at m: acc = b[m] - D_1[m] c_0 - ...
    - D_W[m] c_{W-1} (each product and difference rounded), x[m] = acc *
    (1 / D_0[m])."""
    acc = bm
    for j in range(1, W + 1):
        acc = acc - d[j] * carry[j - 1]
    xm = acc * d[0]
    return xm, [xm] + carry[:-1]


def emulate_solve(band, b, axis):
    """k11_conversion_solve_f64 on the CPU: x as the kernel stores it."""
    axis, outer, L, inner = _lines(b.shape, axis)
    P, W = band.M, band.width
    Dw = band.solve_rows_host()
    assert Dw.shape == (W + 1, P)
    bf = np.ascontiguousarray(b).reshape(-1)
    x = np.full(outer * P * inner, np.nan)
    stores = np.zeros(outer * P * inner, dtype=np.int64)
    C, CS, S = F.K11_CHUNK, F.K11_CSTRIDE, F.K11_SOLVE_STAGES
    K = -(-P // C)
    last = inner == 1
    per = -(-inner // 32)
    tiles = -(-outer // 32) if last else outer * per
    for blk in range(tiles):
        if last:
            line0 = blk * 32
            nl = min(32, outer - line0)
            boff, xoff, bls, xls, ms = line0 * L, line0 * P, L, P, 1
        else:
            o, i0 = blk // per, (blk % per) * 32
            nl = min(32, inner - i0)
            boff, xoff, bls, xls, ms = o * L * inner + i0, o * P * inner + i0, 1, 1, inner
        ring = np.full((S, 32 * CS + (W + 1) * C), np.nan)
        owner = [None] * S
        step = [0]

        def chunk(j):
            hi = P - j * C
            n = min(C, hi)
            return n, hi - n

        def issue(j):
            if j >= K:
                return
            n, lo = chunk(j)
            s = j % S
            # the slot's last chunk was walked and stored at an earlier step
            assert owner[s] is None or owner[s] < step[0]
            c, l = np.meshgrid(np.arange(n), np.arange(nl), indexing='ij')
            ring[s, l * CS + c] = bf[boff + l * bls + (lo + c) * ms]
            # the band's columns of the chunk, after the tile's rows
            c, r = np.meshgrid(np.arange(n), np.arange(W + 1), indexing='ij')
            ring[s, 32 * CS + r * C + c] = Dw[r, lo + c]
            owner[s] = j

        for j in range(S - 1):
            issue(j)
        carry = [np.zeros(nl)] * W
        for j in range(K):
            step[0] = j
            issue(j + S - 1)
            s = j % S
            assert owner[s] == j
            n, lo = chunk(j)
            rows = ring[s, :32 * CS].reshape(32, CS)
            sd = ring[s, 32 * CS:].reshape(W + 1, C)
            for c in range(n - 1, -1, -1):
                rows[:nl, c], carry = _step(sd[:, c], W, rows[:nl, c], carry)
            c, l = np.meshgrid(np.arange(n), np.arange(nl), indexing='ij')
            x[xoff + l * xls + (lo + c) * ms] = ring[s, l * CS + c]
            stores[xoff + l * xls + (lo + c) * ms] += 1
    assert (stores == 1).all()
    return x.reshape(b.shape[:axis] + (P,) + b.shape[axis + 1:])


def _chebyshev_u_bands(M):
    """The port's and the JAX package's T -> U conversion at M modes."""
    tb = TB.ChebyshevU(TCoordinate('z'), M, (-1, 1))
    jb = JB.ChebyshevU(JCoordinate('z'), M, (-1, 1))
    band = tb._conversion_band(M)
    diags, offsets, K = jb._conversion_diags(M)
    return band, (diags, offsets, K)


def _wide_band(M, offsets, seed):
    rng = np.random.default_rng(seed)
    diags = [np.full(M, 2.0) + 0.1 * rng.standard_normal(M)]
    for off in offsets[1:]:
        d = np.zeros(M)
        d[:M - off] = 0.3 * rng.standard_normal(M - off) / off
        diags.append(d)
    K = sp.diags([d[:M - off] for d, off in zip(diags, offsets)], list(offsets), format='csr')
    return F.ConversionBand(diags, offsets), (diags, list(offsets), K)


def _bands(kind, M):
    if kind == 'T->U':
        return _chebyshev_u_bands(M)
    return _wide_band(M, {'wide4': (0, 2, 4), 'wide8': (0, 1, 3, 5, 8)}[kind], seed=M)


def test_chebyshev_u_band_keeps_its_roundoff_diagonal():
    band, (diags, offsets, _) = _chebyshev_u_bands(512)
    assert band.offsets == (0, 1, 2) == tuple(offsets)
    assert 0 < np.abs(band.diags[1]).max() < 1e-15
    assert band.width == 2
    rows = band.solve_rows_host()
    assert rows.shape == (3, 512)
    np.testing.assert_array_equal(rows[1], band.diags[1])
    np.testing.assert_array_equal(rows[0], 1 / band.diags[0])


# (shape, axis, extra points on the solve's lines): the last axis with lines
# that do not fill a warp's tile and P not a multiple of the chunk, a middle
# axis, a leading one, and a middle one of more than a tile's 32 lines
CASES = [((3, 37, 0), -1, 0), ((2, 45, 0), -1, 7), ((4, 0, 6), 1, 0), ((0, 5), 0, 3),
         ((2, 0, 70), 1, 5)]


@pytest.mark.parametrize('kind,M', [('T->U', 64), ('T->U', 100), ('wide4', 71),
                                    ('wide8', 40)])
@pytest.mark.parametrize('shape,axis,extra', CASES)
def test_solve_plan_matches_twin_and_jax(kind, M, shape, axis, extra):
    band, (diags, offsets, K) = _bands(kind, M)
    shape = tuple(M + extra if s == 0 else s for s in shape)
    b = np.random.default_rng(M + len(shape)).standard_normal(shape)
    got = emulate_solve(band, b, axis)
    twin = F.conversion_solve(band, torch.tensor(b), axis).numpy()
    assert _rel(got, twin) <= TOL
    ref = np.asarray(fft64.blocked_upper_solve(
        fft64.build_blocked_upper_solve(K), np.take(b, np.arange(M), axis=axis), axis))
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize('kind,M', [('T->U', 64), ('T->U', 300), ('wide4', 71),
                                    ('wide8', 40)])
@pytest.mark.parametrize('shape,axis,cap', [((3, 37, 0), -1, 65535), ((4, 0, 6), 1, 65535),
                                            ((19, 0), 1, 2), ((0, 5), 0, 65535)])
def test_apply_plan_is_the_twin_bit_for_bit(kind, M, shape, axis, cap):
    band, (diags, offsets, _) = _bands(kind, M)
    shape = tuple(M if s == 0 else s for s in shape)
    x = np.random.default_rng(M * 7 + len(shape)).standard_normal(shape)
    got = emulate_apply(band, x, axis, grid_y_cap=cap)
    twin = F.conversion_apply(band, torch.tensor(x), axis).numpy()
    np.testing.assert_array_equal(got, twin)
    ref = np.asarray(fft64.banded_shift_matmul(diags, offsets, x, axis))
    assert _rel(got, ref) <= TOL


def test_band_widths_and_offsets():
    assert F.ConversionBand([np.ones(8)], [0]).width == 1
    assert F.ConversionBand([np.ones(8)] * 2, [0, 3]).width == 4
    assert F.ConversionBand([np.ones(40)] * 2, [0, 16]).width == 16
    assert F.ConversionBand([np.ones(40)] * 2, [0, 17]).width == 17
    with pytest.raises(ValueError):
        F.ConversionBand([np.ones(8)] * 3, [0, 2, 2])
    assert F.K11_GEOMETRY == (16, 256, 8, 32, 33, 4)
