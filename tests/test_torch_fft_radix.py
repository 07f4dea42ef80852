"""Kernel K10's radix plan (dedalus_tpu_torch/ops/fft.py radix_plan,
radix_tables, dft_launches; csrc/fft_kernels.cu k10_fft_c128): the factor
order, the pass schedule, the twiddle and root tables, the digit-reversed
positions, and each launch the kernel gets, emulated in numpy pass by pass
at the element addresses the kernel reads and writes. The emulated
transform is held against np.fft and the JAX package's fft64 / ifft64
(jitted) to 1e-13 relative, for N = 12, 97, 194, 96, 384, 768, 1536, 3072,
8192 and 16384 (16384 as two launches around the four-step twiddle), with
the complex, real and packed loads, along the last axis and along a strided
one, forward and inverse with a scale and a real output. K12's complex form
inside K10 (`dft_select`'s select store, `dft_scatter`'s scatter load, on
the last and the first launch of a four-step line) is emulated at its slot
addresses: bit for bit the plain select and scatter of the emulated unfused
launches, and within 1e-13 of the JAX package's complex_fft_forward and
complex_fft_backward (jitted)."""

import numpy as np
import pytest
import torch
import jax

from dedalus_tpu.ops import fft64
from dedalus_tpu.ops import transforms as JT
from dedalus_tpu_torch.ops import fft as F

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

SIZES = [12, 97, 194, 96, 384, 768, 1536, 3072, 8192, 16384]
LOADS = ['complex', 'real', 'packed']
LAYOUTS = {'last': (3, None), 'strided': (2, 3)}   # (outer, inner) around the axis
TOL = 1e-13
JAX_FFT = {name: jax.jit(getattr(fft64, name), static_argnums=1) for name in ('fft64', 'ifft64')}
JAX_COMPLEX = {name: jax.jit(getattr(JT, name), static_argnums=(1, 2, 3))
               for name in ('complex_fft_forward', 'complex_fft_backward')}
# K12's complex form in K10: (N, M, Kmax) of rbc256c's x axis (384 grid
# points, 256 modes), M > N and M < N, odd and even M, Kmax below KM, and a
# two-launch line (16384: the select in the second launch's store, the
# scatter in the first's load)
FUSED = [(384, 256, 127), (16, 24, 7), (24, 16, 7), (15, 16, 7), (16, 15, 7), (33, 64, 16),
         (64, 33, 16), (96, 64, 20), (97, 40, 19), (16384, 10923, 5461), (16384, 12000, 3000)]


def roots_exact(q, M, sign):
    """exp(sign 2 pi i q / M) from long-double angles."""
    ang = 2 * np.longdouble('3.14159265358979323846264338327950288') * np.asarray(q) / M
    return (np.cos(ang) + 1j * sign * np.sin(ang)).astype(np.complex128)


def relerr(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def emulate_launch(a, sign, src, dst):
    """One K10 launch on flat numpy buffers, pass by pass."""
    t = F.radix_tables(a['L'], sign)
    L, tail, root = a['L'], t['tail'], t['root']
    ob = np.arange(a['outer'])[:, None]
    j = np.arange(a['inner'])[None, :]
    base = ((ob // a['in_od']) * a['in_o1'] + (ob % a['in_od']) * a['in_o2']
            + (j // a['in_idiv']) * a['in_imul'] + j % a['in_idiv']).reshape(-1)
    n = np.arange(L)[None, :]
    q = (np.broadcast_to(j // a['tw4_div'], (a['outer'], a['inner'])).reshape(-1)
         if a['tw4'] else np.zeros(a['outer'] * a['inner'], dtype=int))
    if a['mode'] == F.MODES['scatter']:
        # point n of the global line (n1 N2 + n2 on a four-step first
        # launch) takes the coefficient of k = n or n - N at slot k mod M
        ng = n * (a['gN'] // L) + q[:, None]
        k = np.where(ng <= a['gN'] // 2, ng, ng - a['gN'])
        ok = (k <= a['kpos']) & (-k <= a['kneg'])
        addr = base[:, None] + np.where(k >= 0, k, k + a['modes']) * a['in_n']
        v = np.where(ok, src[np.where(ok, addr, 0)], 0).astype(np.complex128)
    else:
        addr = base[:, None] + n * a['in_n']
        if a['load'] == F.LOADS['packed']:
            v = src[addr] + 1j * src[addr + a['in_pair']]
        else:
            v = src[addr].astype(np.complex128)
    lines = v.shape[0]
    sched = t['sched'].reshape(-1, 3) if t['radices'] else np.zeros((0, 3), int)
    assert [int(r) for r in sched[:, 0]] == list(t['radices'])
    for r, span, off in sched:
        M = r * span
        Wr = root[((np.arange(r)[:, None] * np.arange(r)[None, :]) % r) * (L // r)]
        out = np.einsum('lbjn,jk->lbkn', v.reshape(lines, L // M, r, span), Wr)
        tw = np.ones((r, span), dtype=np.complex128)
        tw[1:] = t['tw'][off:off + (r - 1) * span].reshape(r - 1, span)
        v = (out * tw).reshape(lines, L)
    Lr = L // tail
    k = np.arange(L)
    p0 = t['pos'][k % Lr]
    n2 = np.arange(tail)[:, None]
    y = np.einsum('ltk,tk->lk', v[:, p0[None, :] + n2],
                  root[((n2 * (k // Lr)[None, :]) % tail) * Lr])
    if a['tw4']:
        y = y * F.unit_roots(a['tw4'], sign)[(q[:, None] * k[None, :]) % a['tw4']]
    y = y * a['scale']
    if a['real_out']:
        y = y.real
    out_base = ((ob // a['out_od']) * a['out_o1'] + (ob % a['out_od']) * a['out_o2']
                + j).reshape(-1)
    if a['mode'] != F.MODES['select']:
        dst[out_base[:, None] + k[None, :] * a['out_k']] = y
        return
    # the select store: global point s = k1 + out_od k to its slot, and the
    # zero slots kpos + 1 + z, z = k1 + out_od t, by the line of each k1
    k1 = np.broadcast_to(ob % a['out_od'], (a['outer'], a['inner'])).reshape(-1)[:, None]
    s = k1 + a['out_od'] * k[None, :]
    slot = np.where(s <= a['kpos'], s, np.where(s >= a['gN'] - a['kneg'],
                                                 s - a['gN'] + a['modes'], -1))
    hit = slot >= 0
    dst[(out_base[:, None] + slot * a['out_k'])[hit]] = y[hit]
    nzero = a['modes'] - a['kpos'] - a['kneg'] - 1
    z = k1 + a['out_od'] * np.arange(-(-nzero // a['out_od']))[None, :]
    z = np.broadcast_to(z, (k1.shape[0], z.shape[1]))
    at = out_base[:, None] + (a['kpos'] + 1 + z) * a['out_k']
    dst[at[z < nzero]] = 0


def dft_emulated(x, sign, axis, load='complex', scale=1.0, real_out=False, select=None,
                 scatter=None):
    """F.dft (with `select` or `scatter`: F.dft_select, F.dft_scatter) on
    the CUDA path, with each of its launches emulated."""
    x = np.ascontiguousarray(x)
    launches = F.dft_launches(x.shape, axis, load, sign, scale, real_out, select, scatter)
    N = scatter[0] if scatter else x.shape[axis] // (2 if load == 'packed' else 1)
    shape = list(x.shape)
    shape[axis] = select[0] if select else N
    scratch = int(np.prod(shape)) // shape[axis] * N
    bufs = dict(x=x.reshape(-1), y=np.full(int(np.prod(shape)), np.nan,
                                           dtype=np.float64 if real_out else np.complex128),
                scratch=np.full(scratch, np.nan, dtype=np.complex128))
    for a in launches:
        emulate_launch(a, sign, bufs[a['src']], bufs[a['dst']])
    return bufs['y'].reshape(shape), launches


def _lines(N, load, layout, rng):
    """(x, axis, z): the input, its axis and its complex lines, axis last."""
    outer, inner = LAYOUTS[layout]
    n = 2 * N if load == 'packed' else N
    shape = (outer, n) if inner is None else (outer, n, inner)
    x = rng.standard_normal(shape)
    if load == 'complex':
        x = x + 1j * rng.standard_normal(shape)
    axis = 1
    z = np.moveaxis(x, axis, -1)
    if load == 'packed':
        z = z[..., 0::2] + 1j * z[..., 1::2]
    return x, axis, z.astype(np.complex128)


@pytest.mark.parametrize('N', SIZES)
def test_radix_plan_and_tables(N):
    """The 3s and 5s first, then radix 8 and one 4 or 2, a tail prime
    above 5; the twiddles W_M^(n1 k2) and the roots are within
    1 ulp of the exact values, and the digit-reversed blocks cover the line
    once."""
    radices, tail = F.radix_plan(N)
    assert int(np.prod(radices)) * tail == N
    twos = [r for r in radices if r in (2, 4, 8)]
    assert twos == sorted(twos, reverse=True) and twos.count(4) + twos.count(2) <= 1
    odd = [r for r in radices if r % 2]
    assert odd == sorted(odd) and radices == tuple(odd + twos) and all(p <= 5 for p in odd)
    assert tail == 1 or (tail > 5 and F._prime_factors(tail) == [tail])
    expect = {12: ((3, 4), 1), 97: ((), 97), 194: ((2,), 97), 96: ((3, 8, 4), 1),
              3072: ((3, 8, 8, 8, 2), 1), 16384: ((8, 8, 8, 8, 4), 1)}
    if N in expect:
        assert (radices, tail) == expect[N]
    for sign in (-1, 1):
        t = F.radix_tables(N, sign)
        M = N
        for r, span, off in (t['sched'].reshape(-1, 3) if radices else []):
            assert r * span == M
            n1, k2 = np.meshgrid(np.arange(span), np.arange(1, r))
            exact = roots_exact((n1 * k2).ravel(), M, sign)
            assert np.max(np.abs(t['tw'][off:off + (r - 1) * span] - exact)) <= 2.5e-16
            M = span
        assert M == tail
        assert np.max(np.abs(t['root'] - roots_exact(np.arange(N), N, sign))) <= 2.5e-16
        cover = (t['pos'][:, None] + np.arange(tail)[None, :]).ravel()
        assert sorted(cover.tolist()) == list(range(N))


def test_launch_counts_and_lines_per_block():
    """One launch wherever a line fits one block (8192 points: 128 KB), two
    at 16384; a strided axis takes at least 4 complex or 8 real lines a
    block, within the 227 KB a block may use."""
    assert len(F.dft_launches((6, 8192), 1, 'real', -1)) == 1
    assert len(F.dft_launches((6, 16384, 3), 1, 'complex', -1)) == 2
    (a,) = F.dft_launches((6, 3072, 768), 1, 'complex', 1)
    assert a['ti'] == 4 and a['ti'] * 3072 * 16 + 4 * 3072 <= F.K10_SMEM_BYTES
    (a,) = F.dft_launches((2, 3072, 768), 1, 'packed', -1)
    assert a['ti'] == 8 and a['L'] == 1536
    (a,) = F.dft_launches((2, 2048, 768), 2, 'real', -1)
    assert a['inner'] == 1 and a['ti'] * 768 <= F.K10_BLOCK_POINTS


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('load', LOADS)
@pytest.mark.parametrize('N', SIZES)
def test_emulated_launches_match_numpy_and_jax(N, load, layout):
    """The forward DFT and the inverse (scaled, and its real part) of the
    emulated launches against np.fft and the JAX package's fft64 / ifft64."""
    rng = np.random.default_rng(N)
    x, axis, z = _lines(N, load, layout, rng)
    y, launches = dft_emulated(x, -1, axis, load)
    assert len(launches) == (2 if N == 16384 else 1)
    y = np.moveaxis(y, axis, -1)
    assert relerr(y, np.fft.fft(z, axis=-1)) <= TOL
    assert relerr(y, np.asarray(JAX_FFT['fft64'](z.reshape(-1, N), -1)).reshape(z.shape)) <= TOL
    yi, _ = dft_emulated(x, +1, axis, load, scale=1.0 / N)
    yi = np.moveaxis(yi, axis, -1)
    assert relerr(yi, np.fft.ifft(z, axis=-1)) <= TOL
    assert relerr(yi, np.asarray(JAX_FFT['ifft64'](z.reshape(-1, N), -1)).reshape(z.shape)) <= TOL
    yr, _ = dft_emulated(x, +1, axis, load, scale=0.5, real_out=True)
    assert relerr(np.moveaxis(yr, axis, -1), 0.5 * N * np.fft.ifft(z, axis=-1).real) <= TOL


@pytest.mark.parametrize('N', [96, 194, 3072])
def test_plain_twin_agrees_with_the_emulated_kernel(N):
    """The plain twin (the four-step einsum, which the CPU path runs) and
    the emulated kernel on the same strided complex lines."""
    rng = np.random.default_rng(N + 1)
    x, axis, _ = _lines(N, 'complex', 'strided', rng)
    y, _ = dft_emulated(x, -1, axis)
    assert relerr(F.dft(torch.as_tensor(x), -1, axis).numpy(), y) <= TOL


def _complex_lines(N, layout, rng):
    """Complex lines of N points (outer, N[, inner]) along axis 1."""
    outer, inner = LAYOUTS[layout]
    shape = (outer, N) if inner is None else (outer, N, inner)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('N, M, Kmax', FUSED)
def test_fused_k12_complex_select_and_scatter(N, M, Kmax, layout):
    """K10 with K12's select store (dft_select) and scatter load
    (dft_scatter), emulated: bit for bit the plain select of the emulated
    unfused forward launches and the emulated unfused inverse launches of
    the plain scatter; within 1e-13 of the JAX package's
    complex_fft_forward and complex_fft_backward; one launch, or two on the
    16384-point line; every output element written."""
    rng = np.random.default_rng(N * 7 + M)
    x = _complex_lines(N, layout, rng)
    fused, launches = dft_emulated(x, -1, 1, scale=1.0 / N, select=(M, Kmax))
    assert len(launches) == (2 if N == 16384 else 1)
    assert [a['mode'] for a in launches][-1] == F.MODES['select']
    assert not np.isnan(fused).any()
    Z, _ = dft_emulated(x, -1, 1, scale=1.0 / N)
    unfused = F.fourier_select_plain(torch.as_tensor(Z), 1, M, Kmax).numpy()
    np.testing.assert_array_equal(fused, unfused)
    jx = np.moveaxis(x, 1, -1)
    ref = np.moveaxis(np.asarray(JAX_COMPLEX['complex_fft_forward'](jx, jx.ndim - 1, M, Kmax)),
                      -1, 1)
    assert relerr(fused, ref) <= TOL

    c = _complex_lines(M, layout, rng)
    back, launches = dft_emulated(c, +1, 1, scatter=(N, Kmax))
    assert len(launches) == (2 if N == 16384 else 1)
    assert launches[0]['mode'] == F.MODES['scatter']
    assert not np.isnan(back).any()
    full = F.fourier_scatter_plain(torch.as_tensor(c), 1, N, Kmax).numpy()
    unfused, _ = dft_emulated(full, +1, 1)
    np.testing.assert_array_equal(back, unfused)
    jc = np.moveaxis(c, 1, -1)
    ref = np.moveaxis(np.asarray(JAX_COMPLEX['complex_fft_backward'](jc, jc.ndim - 1, N, Kmax)),
                      -1, 1)
    assert relerr(back, ref) <= TOL


def test_fused_k12_plan_raises_outside_its_forms():
    """The select store and the scatter load take complex lines without a
    real output, one of them a call; the select 0 <= Kmax <= (N - 1) // 2."""
    with pytest.raises(ValueError):
        F.dft_launches((2, 16), 1, 'real', -1, select=(8, 3))
    with pytest.raises(ValueError):
        F.dft_launches((2, 16), 1, 'complex', +1, real_out=True, scatter=(16, 3))
    with pytest.raises(ValueError):
        F.dft_launches((2, 16), 1, 'complex', -1, select=(24, 8))
    (a,) = F.dft_launches((2, 16), 1, 'complex', -1, select=(24, 7))
    assert (a['kpos'], a['kneg'], a['modes'], a['gN']) == (7, 7, 24, 16)
    (a,) = F.dft_launches((2, 16), 1, 'complex', -1, select=(16, 7))
    assert (a['kpos'], a['kneg']) == (7, 7) and a['out_o1'] == 16
    assert F.select_fields(16, 100, 20)['kpos'] == 8 and F.select_fields(16, 100, 20)['kneg'] == 7
