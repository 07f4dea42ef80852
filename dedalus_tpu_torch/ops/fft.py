"""
Fast spectral transforms in complex128: the DFT (K10), the DCT-II
and DCT-III wrapping (K11a), the ultraspherical conversion and its inverse
(K11b), the real-Fourier pack and unpack (K12) and the complex-Fourier
select and scatter (K12's complex form, fused into K10's store and load:
`dft_select`, `dft_scatter`), each a kernel wrapper with its plain torch
twin beside it.

The counterpart of dedalus_tpu/ops/fft64.py and of the fast paths of
dedalus_tpu/ops/transforms.py. The JAX package carries complex values as
split (re, im) f64 pairs because its device has no complex128; the card has
it, so the port carries complex128. K10's plain twin keeps the JAX
package's algorithm: for N = N1*N2 (`good_factors`, the most balanced pair
with N1 >= 4) the DFT is a length-N1 DFT over n1 with the twiddle
W_N^{n2 k1} fused, then a length-N2 DFT over n2, output index
k = k1 + N1*k2; where N has no such pair or N < 16 it is the direct N-point
DFT. The kernel is a mixed-radix FFT of the same function (`radix_plan`).
The DFT matrices, twiddles and roots are built on the host in f64 and
cached on each device per (N, sign); sign -1 is forward, +1 inverse (1/N
applied by the caller).

Every wrapper works along one axis of a contiguous tensor read as
(outer, L, inner), with L the axis length: the kernels take the axis where
it lies, so no transform copies its data to move the axis last. A CPU
tensor takes the plain twin; a CUDA tensor launches the kernel
(csrc/fft_kernels.cu: K10 with K12's complex form in it, K11a, K12;
csrc/conversion_kernels.cu: K11b) or raises. Each wrapper counts its
launches in `.launches`.

The composite transforms below (`fft`, `ifft`, `rfft`, `irfft`, `dct2`,
`dct3`) are the JAX package's functions of the same names
(fft64, ifft64, rfft64_split, irfft64_split, dct2_64, dct3_64) built from
these wrappers.
"""

import numpy as np
import torch

from . import staging

__all__ = ['good_factors', 'dft', 'dft_plain', 'dft_select', 'dft_scatter', 'dct2_pre',
           'dct2_post', 'dct3_pre', 'dct3_post', 'fourier_pack', 'fourier_unpack',
           'fourier_select', 'fourier_scatter', 'ConversionBand',
           'conversion_apply', 'conversion_solve', 'fft', 'ifft', 'rfft', 'irfft',
           'dct2', 'dct3']

LOADS = {'complex': 0, 'real': 1, 'packed': 2}


def good_factors(N, min_factor=4):
    """Most balanced factor pair (N1, N2), N1 <= N2, or None if N has no
    factorization with N1 >= min_factor (small or prime sizes)."""
    best = None
    for n1 in range(min_factor, int(np.sqrt(N)) + 1):
        if N % n1 == 0:
            best = (n1, N // n1)
    return best


# ---------------------------------------------------------------------------
# Host-built constants, cached per device
# ---------------------------------------------------------------------------

_HOST = {}
_DEVICE = {}


def _host(key, build):
    if key not in _HOST:
        _HOST[key] = build()
    return _HOST[key]


def _on(key, device, build):
    """The device copy of a host constant (a tuple of numpy arrays)."""
    dkey = key + (str(device),)
    if dkey not in _DEVICE:
        _DEVICE[dkey] = tuple(None if a is None else torch.as_tensor(a, device=device)
                              for a in _host(key, build))
    return _DEVICE[dkey]


def _dft_matrix(N, sign):
    ang = sign * 2 * np.pi * np.outer(np.arange(N), np.arange(N)) / N
    return np.cos(ang) + 1j * np.sin(ang)


def _twiddles(N1, N2, sign):
    ang = sign * 2 * np.pi * np.outer(np.arange(N1), np.arange(N2)) / (N1 * N2)
    return np.cos(ang) + 1j * np.sin(ang)


def plan(N):
    """(N1, N2) of the length-N DFT: the four-step factors, or (N, 1) for
    the direct DFT."""
    factors = good_factors(N)
    if factors is None or N < 16:
        return N, 1
    return factors


def dft_constants(N, sign, device):
    """(W1 (N1, N1), tw (N1, N2), W2 (N2, N2), tw transposed (N2, N1)) in
    complex128 on `device`; the last three None for the direct DFT."""
    N1, N2 = plan(N)

    def build():
        if N2 == 1:
            return _dft_matrix(N, sign), None, None, None
        tw = _twiddles(N1, N2, sign)
        return _dft_matrix(N1, sign), tw, _dft_matrix(N2, sign), np.ascontiguousarray(tw.T)

    return _on(('dft', N, sign), device, build)


def _dct_twiddles(N, kind, device):
    """DCT-II post: (2 cos, 2 sin) of pi k / 2N; DCT-III pre: (cos, sin)."""
    def build():
        k = np.arange(N)
        c = 2.0 if kind == 2 else 1.0
        return c * np.cos(np.pi * k / (2 * N)), c * np.sin(np.pi * k / (2 * N))
    return _on(('dct', N, kind), device, build)


def _rfft_twiddles(N, device):
    """(cos, -sin) of 2 pi k / N, k = 0..N/2: the even/odd unpack of the
    half-length packed DFT."""
    def build():
        k = np.arange(N // 2 + 1)
        return np.cos(2 * np.pi * k / N), -np.sin(2 * np.pi * k / N)
    return _on(('rfft', N), device, build)


def _lines(shape, axis):
    axis = axis % len(shape)
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    return axis, outer, shape[axis], inner


def _with_axis(shape, axis, n):
    shape = list(shape)
    shape[axis] = n
    return tuple(shape)


def _vec(v, ndim, axis):
    """A length-L vector shaped to broadcast along `axis`."""
    shape = [1] * ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def _check_cuda(name, x, dtype, *consts):
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: operands of 2^31 elements or more are not supported")
    for c in consts:
        if c is not None and c.device != x.device:
            raise ValueError(f"{name}: constants on {c.device}, data on {x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K10: the four-step DFT
# ---------------------------------------------------------------------------

def _load_line(x, axis, load):
    """The complex128 lines of `x` along `axis`, moved last (twin only)."""
    z = torch.movedim(x, axis, -1)
    if load == 'real':
        return z.to(torch.complex128)
    if load == 'packed':
        return torch.complex(z[..., 0::2], z[..., 1::2])
    return z


def dft_plain(x, sign, axis=-1, load='complex', scale=1.0, real_out=False):
    """Plain torch K10: the four-step DFT of each line along `axis` in
    torch.einsum on complex128 (the JAX package's _dft_last_s), times
    `scale`, with the same loads and stores as the kernel."""
    z = _load_line(x, axis, load)
    N = z.shape[-1]
    W1, tw, W2, _ = dft_constants(N, sign, z.device)
    N1, N2 = plan(N)
    if N2 == 1:
        y = torch.einsum('kn,...n->...k', W1, z)
    else:
        A = z.reshape(z.shape[:-1] + (N1, N2))
        Bm = torch.einsum('kn,...nm->...km', W1, A) * tw
        D = torch.einsum('ln,...kn->...kl', W2, Bm)
        y = torch.swapaxes(D, -1, -2).reshape(z.shape[:-1] + (N,))
    if real_out:
        y = y.real
    if scale != 1.0:
        y = y * scale
    return torch.movedim(y, -1, axis)


# The radix plan K10 runs (csrc/fft_kernels.cu k10_fft_c128). A line of L
# points is transformed in one block's shared memory by in-place
# decimation-in-frequency passes: pass s of radix r on sub-blocks of M
# points (M / r = the span) reads the r points b M + n1 + span j, takes
# their length-r DFT, multiplies output k2 by W_M^(n1 k2) (the pass's
# twiddle table) and writes it back at b M + n1 + span k2. After the passes
# the point X[k] sits at the digit-reversed position pos[k % (L / tail)]
# (a table the kernel stages in shared memory), or, where a prime factor
# above 5 is left (the tail), the store takes that length-tail DFT of the
# block starting there. Lines too long for one block's shared memory run
# as two launches around the twiddle of the four-step split. K12's complex
# select rides the (last) launch's store and its scatter the (first)
# launch's load (`mode`, below).
K10_SMEM_BYTES = 230400     # a block's lines and pos: 227 KB less its line tables
K10_MAX_LINES = 64          # lines per block (the kernel's per-line tables)
K10_BLOCK_POINTS = 4096     # points a block aims to hold where lines are short
# Blocks a launch aims for where its lines are few (an H100's SMs): such a
# batch takes fewer lines a block, down to rows of 32 bytes on a strided axis
K10_MIN_BLOCKS = 132
# The integer launch parameters, in the order k10_fft_c128 reads them
K10_FIELDS = ('L', 'npass', 'tail', 'load', 'real_out', 'sign', 'outer', 'inner', 'ti',
              'in_o1', 'in_o2', 'in_od', 'in_n', 'in_pair', 'in_idiv', 'in_imul', 'out_o1',
              'out_o2', 'out_od', 'out_k', 'tw4_div', 'tw4_n', 'mode', 'modes', 'kpos', 'kneg',
              'gN')
# K10's modes: the plain load and store, K12's complex select in the store,
# its scatter in the load
MODES = {'none': 0, 'select': 1, 'scatter': 2}
NO_MODES = dict(mode=0, modes=0, kpos=0, kneg=0, gN=0)


def _prime_factors(N):
    out, p = [], 2
    while p * p <= N:
        while N % p == 0:
            out.append(p)
            N //= p
        p += 1
    return out + ([N] if N > 1 else [])


def radix_plan(N):
    """(radices, tail) of K10's in-block FFT of length N: the 3s and the
    5s first, then radix-8 passes and one of 4 or 2 for the rest of the
    power of two (so the radix-8 passes' spans are powers of two); the tail
    is the one prime factor above 5 (1 if none). None where N has two or
    more such factors."""
    f = _prime_factors(N)
    twos = f.count(2)
    big = [p for p in f if p > 5]
    if len(big) > 1:
        return None
    radices = sorted(p for p in f if p in (3, 5))
    radices += [8] * (twos // 3) + {0: [], 1: [2], 2: [4]}[twos % 3]
    return tuple(radices), (big[0] if big else 1)


def unit_roots(M, sign):
    """W_M^m = exp(sign 2 pi i m / M), m < M, in complex128, rounded from
    long-double cos and sin of the angle reduced to [-pi, pi), exact at the
    multiples of pi/4 (the kernel's radix-4 and radix-8 constants)."""
    m = np.arange(M)
    pi = np.longdouble('3.14159265358979323846264338327950288')
    ang = 2 * pi * ((m + M // 2) % M - M // 2).astype(np.longdouble) / M
    c, s = np.cos(ang).astype(np.float64), np.sin(ang).astype(np.float64)
    eighth = (8 * m) % M == 0
    j = (8 * m[eighth]) // M
    h = np.sqrt(0.5)
    c[eighth] = np.array([1.0, h, 0.0, -h, -1.0, -h, 0.0, h])[j]
    s[eighth] = np.array([0.0, h, 1.0, h, 0.0, -h, -1.0, -h])[j]
    return c + 1j * sign * s


def radix_tables(L, sign):
    """K10's host tables of a length-L line: the pass schedule (radix,
    span, twiddle offset) per pass, the passes' twiddles W_M^(n1 k2) for
    k2 = 1..r-1 (k2-major, n1 fastest) concatenated, the roots W_L^m (the
    odd radices' and the tail's), and the digit-reversed block starts pos."""
    radices, tail = radix_plan(L)
    sched, tws, off, M = [], [], 0, L
    for r in radices:
        span = M // r
        q = (np.arange(1, r)[:, None] * np.arange(span)[None, :]) % M
        tws.append(unit_roots(M, sign)[q].ravel())
        sched += [r, span, off]
        off += tws[-1].size
        M = span
    k = np.arange(L // tail)
    b = np.zeros_like(k)
    for r in radices:
        b = b * r + k % r
        k = k // r
    tw = np.concatenate(tws) if tws else np.ones(1, dtype=np.complex128)
    return dict(radices=radices, tail=tail, sched=np.array(sched or [0], dtype=np.int32),
                tw=tw, root=unit_roots(L, sign), pos=(b * tail).astype(np.int32))


def _pow2_floor(n):
    return 1 << (max(int(n), 1).bit_length() - 1)


def _lines_per_block(L, outer, inner, elem_bytes):
    """Lines a K10 block holds (0 where one line does not fit): along a
    strided axis at least 64 contiguous bytes a row (4 complex or 8 real
    lines), more where lines are short; along the last axis enough lines
    for about K10_BLOCK_POINTS points. A batch of fewer lines than
    K10_MIN_BLOCKS such blocks fill takes fewer lines a block (on a
    strided axis down to rows of 32 bytes), so that every SM gets one."""
    fit = (K10_SMEM_BYTES - 4 * L) // (16 * L)
    if fit < 1:
        return 0
    want = _pow2_floor(max(1, K10_BLOCK_POINTS // L))
    spread = _pow2_floor(outer * inner // K10_MIN_BLOCKS)
    if inner > 1:
        ti = min(max(64 // elem_bytes, want), K10_MAX_LINES, _pow2_floor(2 * inner - 1))
        ti = min(ti, max(32 // elem_bytes, spread))
    else:
        ti = min(want, K10_MAX_LINES, _pow2_floor(2 * outer - 1), spread)
    return min(ti, _pow2_floor(fit))


def _four_step_split(N):
    """(N1, N2), N = N1 N2, the most balanced pair whose two lines each fit
    one block with a radix plan, or None."""
    best = None
    for n1 in range(2, int(np.sqrt(N)) + 1):
        if N % n1:
            continue
        if all(radix_plan(n) is not None and _lines_per_block(n, 1, 1, 16) for n in
               (n1, N // n1)):
            best = (n1, N // n1)
    return best


def select_fields(M, N, Kmax):
    """The select store's fields: of the M ordered slots (k = 0..KM,
    -KM..-1, an even M's slot KM + 1 holding k = KM + 1), slots 0..kpos take
    the spectrum points k = m and slots M - kneg..M - 1 the points N + k,
    k = m - M; the slots between are zero (fourier_select_plain's clip and
    mask, for Kmax <= (N - 1) // 2, where no slot's source is clipped)."""
    KM = (M - 1) // 2
    return dict(mode=MODES['select'], modes=M, kpos=min(Kmax, M - 1 - KM),
                kneg=min(Kmax, KM), gN=N)


def scatter_fields(M, N, Kmax):
    """The scatter load's fields: point n of the length-N line takes the
    coefficient of k = n (n <= N // 2) or n - N, at slot k mod M, where
    |k| <= min(Kmax, KM); zero elsewhere (fourier_scatter_plain's map)."""
    km = min(Kmax, (M - 1) // 2)
    return dict(mode=MODES['scatter'], modes=M, kpos=km, kneg=km, gN=N)


def dft_launches(shape, axis, load, sign, scale=1.0, real_out=False, select=None,
                 scatter=None):
    """K10's launches for a dft() call on a contiguous tensor of `shape`:
    one, or two around the four-step twiddle where a line does not fit one
    block. Each is a dict of the K10_FIELDS, the scale, the length of the
    four-step root table (`tw4`, 0 if none) and where it reads and writes
    ('x', 'y' or the complex128 'scratch' of the line batch). Element
    addresses (in the loaded type: complex128, or float64 for the real and
    packed loads): line (ob, j), ob < outer, j < inner, reads point n at
    (ob // in_od) in_o1 + (ob % in_od) in_o2 + (j // in_idiv) in_imul
    + j % in_idiv + n in_n (a packed load's imaginary part in_pair after)
    and writes point k at (ob // out_od) out_o1 + (ob % out_od) out_o2 + j
    + k out_k.

    `select` = (M, Kmax): the output lines hold the M ordered modes of the
    spectrum (select_fields) in the last launch's store, slot m at
    (ob // out_od) out_o1 + j + m out_k. `scatter` = (N, Kmax): the input
    lines hold M = shape[axis] ordered coefficients, spread over the
    length-N line in the first launch's load (scatter_fields), coefficient
    m at (ob // in_od) in_o1 + j % in_idiv + m in_n."""
    axis, outer, Lx, inner = _lines(shape, axis)
    packed = load == 'packed'
    N = Lx // 2 if packed else Lx
    load_modes, store_modes = NO_MODES, NO_MODES
    if scatter is not None:
        N, Kmax = scatter
        load_modes = scatter_fields(Lx, N, Kmax)
    Mout = N
    if select is not None:
        Mout, Kmax = select
        store_modes = select_fields(Mout, N, Kmax)
    if (select or scatter) and (load != 'complex' or real_out or (select and scatter)):
        raise ValueError("K10: the select store and the scatter load take complex lines, "
                         "one of them a call, and no real output")
    if select is not None and not 0 <= Kmax <= (N - 1) // 2:
        raise ValueError(f"K10: the select store takes 0 <= Kmax <= (N - 1) // 2, got "
                         f"Kmax = {Kmax} for N = {N}")
    esize = 16 if load == 'complex' else 8
    w = 2 if packed else 1
    common = dict(load=LOADS[load], sign=int(sign), in_pair=inner, in_o2=0, out_o2=0)
    ti = _lines_per_block(N, outer, inner, esize) if radix_plan(N) else 0
    if ti:
        modes = load_modes if scatter is not None else store_modes
        return [dict(common, L=N, outer=outer, inner=inner, ti=ti, in_o1=Lx * inner, in_od=1,
                     in_n=w * inner, in_idiv=inner, in_imul=0, out_o1=Mout * inner, out_od=1,
                     out_k=inner, real_out=int(real_out), scale=float(scale), tw4=0,
                     tw4_div=0, src='x', dst='y', **modes)]
    split = _four_step_split(N)
    if split is None:
        raise ValueError(f"K10: no radix plan for a line of {N} points")
    N1, N2 = split
    inner_a = N2 * inner
    scat = scatter is not None
    first = dict(common, L=N1, outer=outer, inner=inner_a,
                 ti=_lines_per_block(N1, outer, inner_a, esize), in_o1=Lx * inner, in_od=1,
                 in_n=inner if scat else w * N2 * inner, in_idiv=inner,
                 in_imul=0 if scat else w * inner, out_o1=N * inner,
                 out_od=1, out_k=N2 * inner, real_out=0, scale=1.0, tw4=N, tw4_div=inner,
                 src='x', dst='scratch', **load_modes)
    sel = select is not None
    second = dict(common, L=N2, outer=outer * N1, inner=inner, load=LOADS['complex'],
                  ti=_lines_per_block(N2, outer * N1, inner, 16), in_o1=N2 * inner, in_od=1,
                  in_n=inner, in_idiv=inner, in_imul=0, out_o1=Mout * inner,
                  out_o2=0 if sel else inner, out_od=N1, out_k=inner if sel else N1 * inner,
                  real_out=int(real_out), scale=float(scale), tw4=0, tw4_div=0, src='scratch',
                  dst='y', **store_modes)
    return [first, second]


def _radix_device(L, sign, device):
    """K10's tables of a length-L line on `device`: (sched, tw, root, pos)."""
    def build():
        t = radix_tables(L, sign)
        return t['sched'], t['tw'], t['root'], t['pos']
    return _on(('radix', L, sign), device, build)


def _roots_device(N, sign, device):
    return _on(('roots', N, sign), device, lambda: (unit_roots(N, sign),))[0]


_K10_CALLS = {}


def _k10_calls(shape, axis, load, sign, scale, real_out, device, select=None, scatter=None):
    """The launches of a dft() call, cached per call configuration: for
    each, its source and destination buffer names, its table pointers, its
    integer parameters (a ctypes array of K10_FIELDS) and its scale (the
    tables stay referenced by the cached entry)."""
    key = (shape, axis, load, sign, scale, real_out, str(device), select, scatter)
    if key not in _K10_CALLS:
        import ctypes
        calls = []
        for a in dft_launches(shape, axis, load, sign, scale, real_out, select, scatter):
            tables = _radix_device(a['L'], sign, device)
            tw4 = _roots_device(a['tw4'], sign, device) if a['tw4'] else None
            radices, tail = radix_plan(a['L'])
            p = dict(a, npass=len(radices), tail=tail, tw4_n=a['tw4'])
            sched, tw, root, pos = tables
            calls.append((a['src'], a['dst'],
                          (tw.data_ptr(), root.data_ptr(), pos.data_ptr(), sched.data_ptr(),
                           _ptr(tw4)),
                          (ctypes.c_longlong * len(K10_FIELDS))(*[int(p[k]) for k in K10_FIELDS]),
                          a['scale'], (tables, tw4)))
        _K10_CALLS[key] = calls
    return _K10_CALLS[key]


def dft(x, sign, axis=-1, load='complex', scale=1.0, real_out=False):
    """
    K10: the DFT (sign -1) or unscaled inverse DFT (sign +1) of every line
    of `x` along `axis`, times `scale`. `load` reads the lines as complex128
    ('complex'), as float64 with zero imaginary part ('real'), or as float64
    pairs z[n] = x[2n] + i x[2n+1] of half the axis length ('packed').
    Returns complex128, or float64 holding scale * Re(X) when `real_out`.
    CPU tensors run the plain twin (the four-step einsum); CUDA tensors
    launch csrc/fft_kernels.cu k10_fft_c128, the radix FFT of
    radix_tables() (two launches for a line longer than one block holds,
    dft_launches()), each counted.
    """
    if x.device.type == 'cpu':
        return dft_plain(x, sign, axis, load, scale, real_out)
    x = x.contiguous()
    axis, outer, L, inner = _lines(x.shape, axis)
    if load == 'packed' and L % 2:
        raise ValueError("dft: a packed load needs an even axis length")
    N = L // 2 if load == 'packed' else L
    _check_cuda('dft', x, torch.complex128 if load == 'complex' else torch.float64)
    return _k10(x, axis, N, N, outer * N * inner, 'dft',
                (tuple(x.shape), axis, load, int(sign), float(scale), bool(real_out), x.device),
                torch.float64 if real_out else torch.complex128)


dft.launches = 0


def _k10(x, axis, N, Mout, scratch, name, plan, dtype=torch.complex128, fused=None):
    """Launch K10's calls of `plan` (the arguments of _k10_calls) on the
    contiguous CUDA tensor x: lines of N points, Mout points out along
    `axis`, a complex128 scratch of `scratch` elements for a two-launch
    line. Each launch counts as dft's, or, where it carries K12's complex
    form (`fused`: dft_select or dft_scatter, the kernel's select or
    scatter instantiation), as that wrapper's."""
    import ctypes
    from ..csrc import build
    y = torch.empty(_with_axis(x.shape, axis, Mout), device=x.device, dtype=dtype)
    calls = _k10_calls(*plan)
    bufs = dict(x=x, y=y)
    if len(calls) > 1:
        bufs['scratch'] = torch.empty(scratch, dtype=torch.complex128, device=x.device)
    launch, stream = build.library().k10_fft_c128, _stream(x)
    for src, dst, tables, params, sc, _ in calls:
        build.check(launch(bufs[src].data_ptr(), bufs[dst].data_ptr(), *tables,
                           ctypes.addressof(params), sc, stream), name)
        build.count(dft if fused is None else fused)
    return y


def dft_select_plain(x, axis, M, Kmax):
    """Plain torch forward complex Fourier transform: K10's plain twin
    with the 1/N scale, then K12's select."""
    N = x.shape[axis]
    return fourier_select_plain(dft_plain(x, -1, axis, scale=1.0 / N), axis, M, Kmax)


def dft_select(x, axis, M, Kmax):
    """
    The forward complex Fourier transform of complex128 lines along `axis`:
    the DFT over N times 1/N, then the M ordered modes (k = 0..KM,
    -KM..-1) with |k| <= Kmax, the rest zero (fourier_select). CPU tensors
    take the DFT's plain twin and fourier_select; CUDA tensors launch K10
    with the select in its store (one launch, or two past 11520 points: the
    select in the second's), bit for bit K10 followed by the select; it
    takes 0 <= Kmax <= (N - 1) // 2 (ComplexFourier's Kmax_for) and raises
    otherwise.
    """
    N = x.shape[axis]
    if x.device.type == 'cpu':
        return fourier_select(dft_plain(x, -1, axis, scale=1.0 / N), axis, M, Kmax)
    x = x.contiguous()
    axis, outer, N, inner = _lines(x.shape, axis)
    _check_cuda('dft_select', x, torch.complex128)
    return _k10(x, axis, N, M, outer * N * inner, 'dft_select',
                (tuple(x.shape), axis, 'complex', -1, 1.0 / N, False, x.device,
                 (int(M), int(Kmax))), fused=dft_select)


dft_select.launches = 0


def dft_scatter_plain(c, axis, N, Kmax):
    """Plain torch backward complex Fourier transform: K12's scatter,
    then K10's plain twin of the unnormalised inverse."""
    return dft_plain(fourier_scatter_plain(c, axis, N, Kmax), +1, axis)


def dft_scatter(c, axis, N, Kmax):
    """
    The backward complex Fourier transform of M ordered complex128
    coefficients along `axis` to N grid points: the modes |k| <= Kmax
    written into a zeroed length-N spectrum (fourier_scatter), then the
    unnormalised inverse DFT. CPU tensors take fourier_scatter and the
    DFT's plain twin; CUDA tensors launch K10 with the scatter in its load
    (in the first launch's, past 11520 points), bit for bit the scatter
    followed by K10.
    """
    if c.device.type == 'cpu':
        return dft_plain(fourier_scatter(c, axis, N, Kmax), +1, axis)
    c = c.contiguous()
    axis, outer, M, inner = _lines(c.shape, axis)
    if Kmax < 0:
        raise ValueError(f"dft_scatter: Kmax = {Kmax}")
    _check_cuda('dft_scatter', c, torch.complex128)
    return _k10(c, axis, N, N, outer * N * inner, 'dft_scatter',
                (tuple(c.shape), axis, 'complex', 1, 1.0, False, c.device, None,
                 (int(N), int(Kmax))), fused=dft_scatter)


dft_scatter.launches = 0


# ---------------------------------------------------------------------------
# K11a: the DCT-II / DCT-III wrapping around K10 (Makhoul's permutation)
# ---------------------------------------------------------------------------

def _makhoul_index(N, flip, device):
    """Source index of each permuted point: v[n] = y[2n] (n < ceil(N/2)),
    y[2N - 2n - 1] after, with y the (flipped) line."""
    def build():
        n = np.arange(N)
        j = np.where(n < (N + 1) // 2, 2 * n, 2 * N - 2 * n - 1)
        return (N - 1 - j if flip else j,)
    return _on(('makhoul', N, bool(flip)), device, build)[0]


def _interleave_index(N, flip, device):
    """Source index of each output point of the inverse permutation:
    out[j] = v[j/2] (j even), v[N - 1 - (j-1)/2] (j odd), then the flip."""
    def build():
        q = np.arange(N)
        j = N - 1 - q if flip else q
        return (np.where(j % 2 == 0, j // 2, N - 1 - (j - 1) // 2),)
    return _on(('interleave', N, bool(flip)), device, build)[0]


def dct2_pre_plain(x, axis, flip):
    axis = axis % x.ndim
    return torch.index_select(x, axis, _makhoul_index(x.shape[axis], flip, x.device))


def dct2_pre(x, axis, flip=False):
    """K11a, DCT-II pre: the (flipped) real line in Makhoul's order,
    v = [y[0::2], reversed(y[1::2])] with y = flip(x) when `flip`."""
    if x.device.type == 'cpu':
        return dct2_pre_plain(x, axis, flip)
    from ..csrc import build
    x = x.contiguous()
    axis, outer, N, inner = _lines(x.shape, axis)
    _check_cuda('dct2_pre', x, torch.float64)
    v = torch.empty_like(x)
    build.check(build.library().k11_dct2_pre_f64(
        x.data_ptr(), v.data_ptr(), outer, N, inner, int(flip), _stream(x)), 'dct2_pre')
    build.count(dct2_pre)
    return v


dct2_pre.launches = 0


def dct2_post_plain(V, axis, M, scale=None):
    axis = axis % V.ndim
    N = V.shape[axis]
    wr, wi = _dct_twiddles(N, 2, V.device)
    t = _vec(wr, V.ndim, axis) * V.real + _vec(wi, V.ndim, axis) * V.imag
    if scale is not None:
        t = t * _vec(scale, V.ndim, axis)
    return resize_axis(t, M, axis)


def dct2_post(V, axis, M, scale=None):
    """K11a, DCT-II post: X[k] = 2 Re(e^{-i pi k/2N} V[k]) of K10's output
    V, times `scale` (length N) where given, zero-padded or truncated to M."""
    if V.device.type == 'cpu':
        return dct2_post_plain(V, axis, M, scale)
    from ..csrc import build
    V = V.contiguous()
    axis, outer, N, inner = _lines(V.shape, axis)
    wr, wi = _dct_twiddles(N, 2, V.device)
    _check_cuda('dct2_post', V, torch.complex128, scale)
    t = torch.empty(_with_axis(V.shape, axis, M), dtype=torch.float64, device=V.device)
    build.check(build.library().k11_dct2_post_f64(
        V.data_ptr(), wr.data_ptr(), wi.data_ptr(), _ptr(scale), t.data_ptr(), outer, N, M,
        inner, _stream(V)), 'dct2_post')
    build.count(dct2_post)
    return t


dct2_post.launches = 0


def dct3_pre_plain(c, axis, N, scale=None):
    axis = axis % c.ndim
    P = min(c.shape[axis], N)
    x = resize_axis(torch.narrow(c, axis, 0, P), N, axis)
    if scale is not None:
        x = x * _vec(scale, c.ndim, axis)
    wr, wi = _dct_twiddles(N, 3, c.device)
    rev = torch.arange(N - 1, 0, -1, device=c.device)
    xN = torch.cat([torch.zeros_like(torch.narrow(x, axis, 0, 1)),
                    torch.index_select(x, axis, rev)], dim=axis)
    wr, wi = _vec(wr, c.ndim, axis), _vec(wi, c.ndim, axis)
    return torch.complex(x * wr + xN * wi, x * wi - xN * wr)


def dct3_pre(c, axis, N, scale=None):
    """K11a, DCT-III pre: the first min(L, N) points of each line of c,
    zero-padded to N, times `scale` (length N) where given, then
    V = (x - i xN) e^{i pi k/2N} with xN[k] = x[N-k] (xN[0] = 0): K10's
    complex input."""
    if c.device.type == 'cpu':
        return dct3_pre_plain(c, axis, N, scale)
    from ..csrc import build
    c = c.contiguous()
    axis, outer, L, inner = _lines(c.shape, axis)
    wr, wi = _dct_twiddles(N, 3, c.device)
    _check_cuda('dct3_pre', c, torch.float64, scale)
    V = torch.empty(_with_axis(c.shape, axis, N), dtype=torch.complex128, device=c.device)
    build.check(build.library().k11_dct3_pre_f64(
        c.data_ptr(), _ptr(scale), wr.data_ptr(), wi.data_ptr(), V.data_ptr(), outer, L,
        min(L, N), N, inner, _stream(c)), 'dct3_pre')
    build.count(dct3_pre)
    return V


dct3_pre.launches = 0


def dct3_post_plain(v, axis, flip):
    axis = axis % v.ndim
    return torch.index_select(v, axis, _interleave_index(v.shape[axis], flip, v.device))


def dct3_post(v, axis, flip=False):
    """K11a, DCT-III post: the inverse Makhoul permutation of the real line
    v (out[2p] = v[p], out[2p+1] = v[N-1-p]), flipped when `flip`."""
    if v.device.type == 'cpu':
        return dct3_post_plain(v, axis, flip)
    from ..csrc import build
    v = v.contiguous()
    axis, outer, N, inner = _lines(v.shape, axis)
    _check_cuda('dct3_post', v, torch.float64)
    g = torch.empty_like(v)
    build.check(build.library().k11_dct3_post_f64(
        v.data_ptr(), g.data_ptr(), outer, N, inner, int(flip), _stream(v)), 'dct3_post')
    build.count(dct3_post)
    return g


dct3_post.launches = 0



# ---------------------------------------------------------------------------
# K12: the real-Fourier pack and unpack around K10
# ---------------------------------------------------------------------------

def _half_spectrum(Z, N, packed):
    """X[k], k = 0..N//2, of a real length-N line from K10's output Z: the
    even/odd unpack of the half-length packed DFT (Z[N/2] = Z[0]), or the
    first N//2 + 1 points of the full DFT (twin only; Z's axis last)."""
    if not packed:
        return Z[..., :N // 2 + 1]
    Nh = N // 2
    k = torch.arange(Nh + 1, device=Z.device)
    Zf = Z[..., k % Nh]
    Zr = Z[..., (Nh - k) % Nh]
    Er, Ei = (Zf.real + Zr.real) / 2, (Zf.imag - Zr.imag) / 2
    Or, Oi = (Zf.imag + Zr.imag) / 2, (Zr.real - Zf.real) / 2
    wr, wi = _rfft_twiddles(N, Z.device)
    return torch.complex(Er + (Or * wr - Oi * wi), Ei + (Or * wi + Oi * wr))


def fourier_pack_plain(Z, axis, N, M, Kmax, s0, s, packed):
    axis = axis % Z.ndim
    X = _half_spectrum(torch.movedim(Z, axis, -1), N, packed)
    nk = (M + 1) // 2
    X = resize_axis(X, nk, -1)
    k = torch.arange(nk, device=Z.device)
    valid = k <= Kmax
    a = torch.where(k == 0, s0 * X.real, s * X.real) * valid
    b = (s * X.imag) * (valid & (k > 0))
    out = torch.stack([a, b], dim=-1).reshape(X.shape[:-1] + (2 * nk,))[..., :M]
    return torch.movedim(out, -1, axis)


def fourier_pack(Z, axis, N, M, Kmax, s0, s, packed):
    """
    K12, forward: the interleaved (cos, -sin) coefficients of real length-N
    lines from K10's output Z: out[2k] = s0 Re X[0] (k = 0) or s Re X[k],
    out[2k+1] = s Im X[k] (k > 0, else 0), for k <= Kmax, zero above and
    past N//2; M points. X is Z's even/odd unpack (`packed`: Z is the
    half-length DFT of z[n] = x[2n] + i x[2n+1]) or Z itself (the full DFT).
    """
    if Z.device.type == 'cpu':
        return fourier_pack_plain(Z, axis, N, M, Kmax, s0, s, packed)
    from ..csrc import build
    Z = Z.contiguous()
    axis, outer, Lz, inner = _lines(Z.shape, axis)
    if Lz != (N // 2 if packed else N):
        raise ValueError(f"fourier_pack: Z has {Lz} points for N = {N}")
    twr, twi = _rfft_twiddles(N, Z.device) if packed else (None, None)
    _check_cuda('fourier_pack', Z, torch.complex128)
    out = torch.empty(_with_axis(Z.shape, axis, M), dtype=torch.float64, device=Z.device)
    build.check(build.library().k12_fourier_pack_f64(
        Z.data_ptr(), _ptr(twr), _ptr(twi), out.data_ptr(), outer, Lz, N, M, inner,
        int(Kmax), float(s0), float(s), _stream(Z)), 'fourier_pack')
    build.count(fourier_pack)
    return out


fourier_pack.launches = 0


def fourier_unpack_plain(c, axis, N, Kmax, s0, s, keep_b0=False):
    axis = axis % c.ndim
    ct = torch.movedim(c, axis, -1)
    nk = ct.shape[-1] // 2
    pairs = ct[..., :2 * nk].reshape(ct.shape[:-1] + (nk, 2))
    k = torch.arange(nk, device=c.device)
    valid = k <= Kmax
    bvalid = valid if keep_b0 else valid & (k > 0)
    sc = torch.full((nk,), s, dtype=torch.float64, device=c.device)
    sc[:1] = s0
    h = torch.complex(pairs[..., 0] * valid * sc, pairs[..., 1] * bvalid * sc)
    h = resize_axis(h, N // 2 + 1, -1)
    kk = torch.arange(N, device=c.device)
    full = h[..., torch.where(kk <= N // 2, kk, N - kk)]
    full = torch.where(kk <= N // 2, full, full.conj())
    return torch.movedim(full, -1, axis)


def fourier_unpack(c, axis, N, Kmax, s0, s, keep_b0=False):
    """
    K12, backward: the Hermitian length-N spectrum of real lines from
    interleaved (cos, -sin) coefficients c (L points, L // 2 pairs):
    h[k] = (s0 or s) * (a_k + i b_k) for k <= Kmax (b_0 dropped unless
    `keep_b0`), zero above and past the pairs, truncated to N//2 + 1, and
    X[k] = conj(h[N - k]) for k > N//2: K10's input for the inverse.
    """
    if c.device.type == 'cpu':
        return fourier_unpack_plain(c, axis, N, Kmax, s0, s, keep_b0)
    from ..csrc import build
    c = c.contiguous()
    axis, outer, L, inner = _lines(c.shape, axis)
    _check_cuda('fourier_unpack', c, torch.float64)
    full = torch.empty(_with_axis(c.shape, axis, N), dtype=torch.complex128, device=c.device)
    build.check(build.library().k12_fourier_unpack_f64(
        c.data_ptr(), full.data_ptr(), outer, L, N, inner, int(min(Kmax, 2**30)), float(s0),
        float(s), int(keep_b0), _stream(c)), 'fourier_unpack')
    build.count(fourier_unpack)
    return full


fourier_unpack.launches = 0



# ---------------------------------------------------------------------------
# K12, complex form: the select and scatter of ordered complex coefficients
# (their plain forms; on the card they run inside K10: dft_select,
# dft_scatter)
# ---------------------------------------------------------------------------

def _ordered_wavenumbers(M):
    """The signed wavenumber of each of M ordered coefficients."""
    KM = (M - 1) // 2
    return (np.arange(M) + KM) % M - KM


def _select_index(M, N, Kmax, device):
    """(source index in the length-N spectrum, validity) of each ordered
    coefficient: k >= 0 at k, k < 0 at N + k, clipped into the line and
    masked where |k| > Kmax (as jnp.clip and `valid` in the reference)."""
    def build():
        k = _ordered_wavenumbers(M)
        idx = np.clip(np.where(k >= 0, k, N + k), 0, N - 1)
        return idx, np.abs(k) <= Kmax
    return _on(('select', M, N, int(Kmax)), device, build)


def _scatter_index(M, N, Kmax, device):
    """(source coefficient, validity) of each point of the length-N
    spectrum: n <= Kmax takes k = n, n >= N - Kmax takes k = n - N (the
    coefficient at k mod M); the rest is zero."""
    def build():
        n = np.arange(N)
        k = np.where(n <= N // 2, n, n - N)
        valid = np.abs(k) <= min(Kmax, (M - 1) // 2)
        return np.where(valid, k % M, 0), valid
    return _on(('scatter', M, N, int(Kmax)), device, build)


def fourier_select_plain(Z, axis, M, Kmax):
    axis = axis % Z.ndim
    idx, valid = _select_index(M, Z.shape[axis], Kmax, Z.device)
    return torch.index_select(Z, axis, idx) * _vec(valid, Z.ndim, axis)


def fourier_select(Z, axis, M, Kmax):
    """
    K12, complex forward: the M ordered coefficients (k = 0..KM, -KM..-1)
    of complex128 length-N spectra Z along `axis`: out[m] = Z[k] (k >= 0)
    or Z[N + k] (k < 0) for |k| <= Kmax, zero otherwise (the even-size
    slot KM + 1 and, when M > N, every mode past the grid's). The CPU
    route of dft_select; on the card the select is K10's store
    (dft_select), so a CUDA tensor raises.
    """
    if Z.device.type != 'cpu':
        raise ValueError("fourier_select: on the card the select runs in K10's store: "
                         "call dft_select")
    return fourier_select_plain(Z, axis, M, Kmax)


def fourier_scatter_plain(c, axis, N, Kmax):
    axis = axis % c.ndim
    idx, valid = _scatter_index(c.shape[axis], N, Kmax, c.device)
    return torch.index_select(c, axis, idx) * _vec(valid, c.ndim, axis)


def fourier_scatter(c, axis, N, Kmax):
    """
    K12, complex backward: the length-N spectra of M ordered complex128
    coefficients c along `axis`: point n takes the coefficient of k = n
    (n <= N//2) or k = n - N, for |k| <= Kmax and |k| <= (M-1)//2, zero
    elsewhere. The CPU route of dft_scatter; on the card the scatter is
    K10's load (dft_scatter), so a CUDA tensor raises.
    """
    if c.device.type != 'cpu':
        raise ValueError("fourier_scatter: on the card the scatter runs in K10's load: "
                         "call dft_scatter")
    return fourier_scatter_plain(c, axis, N, Kmax)


# ---------------------------------------------------------------------------
# K11b: the ultraspherical conversion and its inverse along an axis
# ---------------------------------------------------------------------------

# K11b's launch constants: csrc/conversion_kernels.cu's of the same names (its
# k11_geometry; the wrappers check the two agree)
K11_MAX_DIAGS = 16      # diagonals the apply takes
K11_APPLY_TILE = 256    # points of an outer slab a block of the apply
K11_APPLY_SLABS = 8     # outer slabs a block of the apply walks
K11_CHUNK = 32          # points of a line a stage of the solve's ring
K11_CSTRIDE = K11_CHUNK + 1     # a line's row in a stage (doubles)
K11_SOLVE_STAGES = 4    # stages of the ring of a warp's tile of 32 lines
K11_SOLVE_WIDTHS = (1, 2, 4, 8, 16)     # carries the solve is instantiated for
K11_GEOMETRY = (K11_MAX_DIAGS, K11_APPLY_TILE, K11_APPLY_SLABS, K11_CHUNK, K11_CSTRIDE,
                K11_SOLVE_STAGES)


class ConversionBand:
    """A banded upper-triangular (M, M) matrix by its diagonals:
    B[m, m + offsets[d]] = diags[d][m], offsets strictly ascending from 0;
    host f64 arrays, copied to each device once."""

    def __init__(self, diags, offsets):
        self.offsets = tuple(int(o) for o in offsets)
        if (not self.offsets or self.offsets[0] != 0
                or any(b <= a for a, b in zip(self.offsets, self.offsets[1:]))):
            raise ValueError("ConversionBand: offsets must ascend strictly from the main "
                             "diagonal")
        self.diags = np.ascontiguousarray(np.stack(diags), dtype=np.float64)
        self.M = self.diags.shape[1]
        self._dev = {}
        self._rows = {}

    def on(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (torch.as_tensor(self.diags, device=device),
                              torch.as_tensor(self.offsets, dtype=torch.int32, device=device))
        return self._dev[key]

    @property
    def width(self):
        """The solve's carry: the smallest of K11_SOLVE_WIDTHS at or above
        the largest offset, or past the widest (the general path) the
        largest offset itself."""
        for w in K11_SOLVE_WIDTHS:
            if w >= self.offsets[-1]:
                return w
        return self.offsets[-1]

    @property
    def general(self):
        """Whether K11b takes this band on its general paths: more than
        K11_MAX_DIAGS diagonals (the apply's general kernel) or a
        largest offset past the widest carry (the solve's general kernel)."""
        return len(self.offsets) > K11_MAX_DIAGS or self.offsets[-1] > K11_SOLVE_WIDTHS[-1]

    def solve_rows_host(self):
        """The dense solve form (width + 1, M), f64: row 0 the reciprocal
        of the main diagonal, row j the diagonal at offset j (zero where the
        band has none)."""
        rows = np.zeros((self.width + 1, self.M))
        rows[0] = 1.0 / self.diags[0]
        for d, off in enumerate(self.offsets[1:], start=1):
            rows[off] = self.diags[d]
        return rows

    def solve_rows(self, device):
        key = str(device)
        if key not in self._rows:
            self._rows[key] = torch.as_tensor(self.solve_rows_host(), device=device)
        return self._rows[key]


def conversion_apply_plain(band, x, axis):
    axis = axis % x.ndim
    D, _ = band.on(x.device)
    N, M = x.shape[axis], band.M
    out = torch.zeros(_with_axis(x.shape, axis, M), dtype=x.dtype, device=x.device)
    for d, off in enumerate(band.offsets):
        lo, hi = max(0, -off), min(M, N - off)
        if hi <= lo:
            continue
        seg = _vec(D[d, lo:hi], x.ndim, axis) * torch.narrow(x, axis, lo + off, hi - lo)
        torch.narrow(out, axis, lo, hi - lo).add_(seg)
    return out


def conversion_apply(band, x, axis):
    """K11b, apply: out[m] = sum_d diags[d][m] x[m + offsets[d]] along
    `axis` (the ultraspherical conversion after the DCT-II). On the card
    one launch: a block a tile of K11_APPLY_TILE points of a slab, the
    band's columns of the tile staged in shared memory for
    K11_APPLY_SLABS slabs; the plain twin's order of sums, bit for bit."""
    if x.device.type == 'cpu':
        return conversion_apply_plain(band, x, axis)
    from ..csrc import build
    x = x.contiguous()
    axis, outer, N, inner = _lines(x.shape, axis)
    D, offs = band.on(x.device)
    _check_cuda('conversion_apply', x, torch.float64)
    build.check_geometry('k11_geometry', K11_GEOMETRY)
    y = torch.empty(_with_axis(x.shape, axis, band.M), dtype=torch.float64, device=x.device)
    build.check(build.library().k11_conversion_apply_f64(
        D.data_ptr(), offs.data_ptr(), len(band.offsets), x.data_ptr(), y.data_ptr(), outer, N,
        band.M, inner, _stream(x)), 'conversion_apply')
    build.count(conversion_apply, 'general' if len(band.offsets) > K11_MAX_DIAGS else None)
    return y


conversion_apply.launches = conversion_apply.launches_general = 0


def conversion_solve_plain(band, b, axis):
    axis = axis % b.ndim
    D, _ = band.on(b.device)
    P = band.M
    bt = torch.movedim(torch.narrow(b, axis, 0, P), axis, -1)
    x = torch.zeros_like(bt)
    for m in range(P - 1, -1, -1):
        acc = bt[..., m]
        for d, off in enumerate(band.offsets[1:], start=1):
            if m + off < P:
                acc = acc - D[d, m] * x[..., m + off]
        x[..., m] = acc / D[0, m]
    return torch.movedim(x, -1, axis)


def conversion_solve(band, b, axis):
    """K11b, solve: back-substitution with the band's matrix (P = band.M)
    on the first P points of each line of b along `axis` (the inverse
    conversion before the DCT-III). On the card one launch on the band's
    dense solve form (`solve_rows`: the main diagonal's reciprocal, a
    carry of `width` values in registers): a warp walks a tile of 32 lines
    (consecutive lines along the last axis, consecutive inner indices of a
    slab along another) from the end through a ring of K11_SOLVE_STAGES
    chunks of K11_CHUNK points staged by coalesced cp.async."""
    if b.device.type == 'cpu':
        return conversion_solve_plain(band, b, axis)
    from ..csrc import build
    b = b.contiguous()
    axis, outer, L, inner = _lines(b.shape, axis)
    if L < band.M:
        raise ValueError(f"conversion_solve: lines of {L} points for a {band.M}-point band")
    Dw = band.solve_rows(b.device)
    _check_cuda('conversion_solve', b, torch.float64)
    build.check_geometry('k11_geometry', K11_GEOMETRY)
    x = torch.empty(_with_axis(b.shape, axis, band.M), dtype=torch.float64, device=b.device)
    build.check(build.library().k11_conversion_solve_f64(
        Dw.data_ptr(), band.width, b.data_ptr(), x.data_ptr(), outer, L, band.M, inner,
        _stream(b)), 'conversion_solve')
    build.count(conversion_solve, 'general' if band.width > K11_SOLVE_WIDTHS[-1] else None)
    return x


conversion_solve.launches = conversion_solve.launches_general = 0



# ---------------------------------------------------------------------------
# Resizing and the composite transforms
# ---------------------------------------------------------------------------

def resize_axis(data, new_size, axis):
    """Zero-pad or truncate `data` to `new_size` along `axis`: on a CUDA
    tensor one launch of K2a (ops/staging.py) writes the resized copy, on a
    CPU tensor its plain twin pads with zeros and torch.cat or narrows."""
    axis = axis % data.ndim
    old = data.shape[axis]
    if new_size == old:
        return data
    if data.device.type == 'cpu':
        return staging.resize_plain(data, new_size, axis)
    outer = int(np.prod(data.shape[:axis], dtype=np.int64))
    inner = int(np.prod(data.shape[axis + 1:], dtype=np.int64))
    out = staging.stage([data.reshape(outer, old, inner)], axis=1, size=new_size)
    return out.reshape(_with_axis(data.shape, axis, new_size))


def fft(x, axis=-1):
    """Complex DFT (np.fft.fft convention) of complex128 lines."""
    return dft(x, -1, axis)


def ifft(x, axis=-1):
    """Inverse complex DFT (np.fft.ifft convention, with 1/N)."""
    return dft(x, +1, axis, scale=1.0 / x.shape[axis])


def _rfft_load(N):
    return 'packed' if N % 2 == 0 and N >= 16 else 'real'


def rfft(x, axis=-1):
    """Real-input DFT, complex modes 0..N//2 (np.fft.rfft): the half-length
    packed DFT for even N >= 16, the full DFT otherwise."""
    N = x.shape[axis]
    load = _rfft_load(N)
    Z = dft(x, -1, axis, load=load)
    nk = N // 2 + 1
    ab = fourier_pack(Z, axis, N, 2 * nk, N // 2, 1.0, 1.0, load == 'packed')
    ab = torch.movedim(ab, axis, -1)
    c = torch.view_as_complex(ab.reshape(ab.shape[:-1] + (nk, 2)).contiguous())
    return torch.movedim(c, -1, axis)


def irfft(c, n, axis=-1):
    """Inverse real DFT (np.fft.irfft) of complex modes to length n."""
    ct = torch.movedim(c, axis, -1).contiguous()
    ab = torch.view_as_real(ct).reshape(ct.shape[:-1] + (2 * ct.shape[-1],))
    full = fourier_unpack(ab, -1, n, n // 2, 1.0, 1.0, keep_b0=True)
    y = dft(full, +1, -1, scale=1.0 / n, real_out=True)
    return torch.movedim(y, -1, axis)


def dct2(x, axis=-1):
    """DCT-II, unnormalized scipy convention: X[k] = 2 sum_j x_j cos(pi k (2j+1) / 2N)."""
    v = dct2_pre(x, axis)
    return dct2_post(dft(v, -1, axis, load='real'), axis, x.shape[axis])


def dct3(x, axis=-1):
    """DCT-III, unnormalized scipy convention (the inverse of dct2 up to 2N)."""
    N = x.shape[axis]
    v = dft(dct3_pre(x, axis, N), +1, axis, real_out=True)
    return dct3_post(v, axis)
