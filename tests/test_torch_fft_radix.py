"""Kernel K10's radix plan (dedalus_tpu_torch/ops/fft.py radix_plan,
radix_tables, dft_launches; csrc/fft_kernels.cu k10_fft_c128): the factor
order, the pass schedule, the twiddle and root tables, the digit-reversed
positions, and each launch the kernel gets, emulated in numpy pass by pass
at the element addresses the kernel reads and writes. The emulated
transform is held against np.fft and the JAX package's fft64 / ifft64
(jitted) to 1e-13 relative, for N = 12, 97, 194, 96, 384, 768, 1536, 3072,
8192 and 16384 (16384 as two launches around the four-step twiddle), with
the complex, real and packed loads, along the last axis and along a strided
one, forward and inverse with a scale and a real output."""

import numpy as np
import pytest
import torch
import jax

from dedalus_tpu.ops import fft64
from dedalus_tpu_torch.ops import fft as F

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

SIZES = [12, 97, 194, 96, 384, 768, 1536, 3072, 8192, 16384]
LOADS = ['complex', 'real', 'packed']
LAYOUTS = {'last': (3, None), 'strided': (2, 3)}   # (outer, inner) around the axis
TOL = 1e-13
JAX_FFT = {name: jax.jit(getattr(fft64, name), static_argnums=1) for name in ('fft64', 'ifft64')}


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
    addr = base[:, None] + np.arange(L)[None, :] * a['in_n']
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
        q = np.broadcast_to(j // a['tw4_div'], (a['outer'], a['inner'])).reshape(-1)
        y = y * F.unit_roots(a['tw4'], sign)[(q[:, None] * k[None, :]) % a['tw4']]
    y = y * a['scale']
    if a['real_out']:
        y = y.real
    out_base = ((ob // a['out_od']) * a['out_o1'] + (ob % a['out_od']) * a['out_o2']
                + j).reshape(-1)
    dst[out_base[:, None] + k[None, :] * a['out_k']] = y


def dft_emulated(x, sign, axis, load='complex', scale=1.0, real_out=False):
    """F.dft on the CUDA path, with each of its launches emulated."""
    x = np.ascontiguousarray(x)
    launches = F.dft_launches(x.shape, axis, load, sign, scale, real_out)
    N = x.shape[axis] // (2 if load == 'packed' else 1)
    shape = list(x.shape)
    shape[axis] = N
    bufs = dict(x=x.reshape(-1), y=np.full(int(np.prod(shape)), np.nan,
                                           dtype=np.float64 if real_out else np.complex128),
                scratch=np.full(int(np.prod(shape)), np.nan, dtype=np.complex128))
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
