"""
Fast spectral transforms in complex128: the four-step DFT (K10), the DCT-II
and DCT-III wrapping (K11a), the ultraspherical conversion and its inverse
(K11b), the real-Fourier pack and unpack (K12) and the complex-Fourier
select and scatter (K12's complex form), each a kernel wrapper with its
plain torch twin beside it.

The counterpart of dedalus_tpu/ops/fft64.py and of the fast paths of
dedalus_tpu/ops/transforms.py. The JAX package carries complex values as
split (re, im) f64 pairs because its device has no complex128; the card has
it, so the port carries complex128 and keeps the algorithms: for N = N1*N2
(`good_factors`, the most balanced pair with N1 >= 4) the DFT is a length-N1
DFT over n1 with the twiddle W_N^{n2 k1} fused, then a length-N2 DFT over
n2, output index k = k1 + N1*k2; where N has no such pair or N < 16 it is
the direct N-point DFT. The DFT matrices and twiddles are built on the host
in f64 as the JAX package builds them and cached on each device per
(N, sign); sign -1 is forward, +1 inverse (1/N applied by the caller).

Every wrapper works along one axis of a contiguous tensor read as
(outer, L, inner), with L the axis length: the kernels take the axis where
it lies, so no transform copies its data to move the axis last. A CPU
tensor takes the plain twin; a CUDA tensor launches the kernel
(csrc/fft_kernels.cu: K10, K11a, K12 in both forms; csrc/conversion_kernels.cu: K11b) or
raises. Each wrapper counts its launches in `.launches`.

The composite transforms below (`fft`, `ifft`, `rfft`, `irfft`, `dct2`,
`dct3`) are the JAX package's functions of the same names
(fft64, ifft64, rfft64_split, irfft64_split, dct2_64, dct3_64) built from
these wrappers.
"""

import numpy as np
import torch

__all__ = ['good_factors', 'dft', 'dft_plain', 'dct2_pre', 'dct2_post', 'dct3_pre',
           'dct3_post', 'fourier_pack', 'fourier_unpack', 'fourier_select',
           'fourier_scatter', 'ConversionBand',
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


def dft(x, sign, axis=-1, load='complex', scale=1.0, real_out=False):
    """
    K10: the DFT (sign -1) or unscaled inverse DFT (sign +1) of every line
    of `x` along `axis`, times `scale`. `load` reads the lines as complex128
    ('complex'), as float64 with zero imaginary part ('real'), or as float64
    pairs z[n] = x[2n] + i x[2n+1] of half the axis length ('packed').
    Returns complex128, or float64 holding scale * Re(X) when `real_out`.
    """
    if x.device.type == 'cpu':
        return dft_plain(x, sign, axis, load, scale, real_out)
    from ..csrc import build
    x = x.contiguous()
    axis, outer, L, inner = _lines(x.shape, axis)
    N = L // 2 if load == 'packed' else L
    if load == 'packed' and L % 2:
        raise ValueError("dft: a packed load needs an even axis length")
    _check_cuda('dft', x, torch.complex128 if load == 'complex' else torch.float64)
    W1, _, W2, twT = dft_constants(N, sign, x.device)
    N1, N2 = plan(N)
    y = torch.empty(_with_axis(x.shape, axis, N), device=x.device,
                    dtype=torch.float64 if real_out else torch.complex128)
    lines = outer * inner
    scratch = None
    if 32 * N > DFT_SMEM_BYTES:
        scratch = torch.empty((lines, 2 * N), dtype=torch.complex128, device=x.device)
    build.check(build.library().k10_dft_c128(
        x.data_ptr(), LOADS[load], W1.data_ptr(), _ptr(twT), _ptr(W2), y.data_ptr(),
        int(real_out), float(scale), _ptr(scratch), outer, N1, N2, inner, _stream(x)), 'dft')
    dft.launches += 1
    return y


dft.launches = 0
# Shared memory of one K10 block (the line and its stage-1 result, 32 bytes
# per point); longer lines stage through a global scratch (N > 6400)
DFT_SMEM_BYTES = 200 * 1024


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
    dct2_pre.launches += 1
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
    dct2_post.launches += 1
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
    dct3_pre.launches += 1
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
    dct3_post.launches += 1
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
    fourier_pack.launches += 1
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
    fourier_unpack.launches += 1
    return full


fourier_unpack.launches = 0



# ---------------------------------------------------------------------------
# K12, complex form: the select and scatter of ordered complex coefficients
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
    slot KM + 1 and, when M > N, every mode past the grid's).
    """
    if Z.device.type == 'cpu':
        return fourier_select_plain(Z, axis, M, Kmax)
    from ..csrc import build
    Z = Z.contiguous()
    axis, outer, N, inner = _lines(Z.shape, axis)
    _check_cuda('fourier_select', Z, torch.complex128)
    out = torch.empty(_with_axis(Z.shape, axis, M), dtype=torch.complex128, device=Z.device)
    build.check(build.library().k12_fourier_select_c128(
        Z.data_ptr(), out.data_ptr(), outer, N, M, inner, int(min(Kmax, 2**30)), _stream(Z)),
        'fourier_select')
    fourier_select.launches += 1
    return out


fourier_select.launches = 0


def fourier_scatter_plain(c, axis, N, Kmax):
    axis = axis % c.ndim
    idx, valid = _scatter_index(c.shape[axis], N, Kmax, c.device)
    return torch.index_select(c, axis, idx) * _vec(valid, c.ndim, axis)


def fourier_scatter(c, axis, N, Kmax):
    """
    K12, complex backward: the length-N spectra of M ordered complex128
    coefficients c along `axis`: point n takes the coefficient of k = n
    (n <= N//2) or k = n - N, for |k| <= Kmax and |k| <= (M-1)//2, zero
    elsewhere; K10's input for the inverse.
    """
    if c.device.type == 'cpu':
        return fourier_scatter_plain(c, axis, N, Kmax)
    from ..csrc import build
    c = c.contiguous()
    axis, outer, M, inner = _lines(c.shape, axis)
    _check_cuda('fourier_scatter', c, torch.complex128)
    full = torch.empty(_with_axis(c.shape, axis, N), dtype=torch.complex128, device=c.device)
    build.check(build.library().k12_fourier_scatter_c128(
        c.data_ptr(), full.data_ptr(), outer, M, N, inner, int(min(Kmax, 2**30)), _stream(c)),
        'fourier_scatter')
    fourier_scatter.launches += 1
    return full


fourier_scatter.launches = 0


# ---------------------------------------------------------------------------
# K11b: the ultraspherical conversion and its inverse along an axis
# ---------------------------------------------------------------------------

class ConversionBand:
    """A banded upper-triangular (M, M) matrix by its diagonals:
    B[m, m + offsets[d]] = diags[d][m], offsets ascending from 0; host f64
    arrays, copied to each device once."""

    def __init__(self, diags, offsets):
        self.offsets = tuple(int(o) for o in offsets)
        if not self.offsets or self.offsets[0] != 0 or list(self.offsets) != sorted(self.offsets):
            raise ValueError("ConversionBand: offsets must ascend from the main diagonal")
        self.diags = np.ascontiguousarray(np.stack(diags), dtype=np.float64)
        self.M = self.diags.shape[1]
        self._dev = {}

    def on(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (torch.as_tensor(self.diags, device=device),
                              torch.as_tensor(self.offsets, dtype=torch.int32, device=device))
        return self._dev[key]


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
    `axis` (the ultraspherical conversion after the DCT-II)."""
    if x.device.type == 'cpu':
        return conversion_apply_plain(band, x, axis)
    from ..csrc import build
    x = x.contiguous()
    axis, outer, N, inner = _lines(x.shape, axis)
    D, offs = band.on(x.device)
    _check_cuda('conversion_apply', x, torch.float64)
    y = torch.empty(_with_axis(x.shape, axis, band.M), dtype=torch.float64, device=x.device)
    build.check(build.library().k11_conversion_apply_f64(
        D.data_ptr(), offs.data_ptr(), len(band.offsets), x.data_ptr(), y.data_ptr(), outer, N,
        band.M, inner, _stream(x)), 'conversion_apply')
    conversion_apply.launches += 1
    return y


conversion_apply.launches = 0


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
    conversion before the DCT-III)."""
    if b.device.type == 'cpu':
        return conversion_solve_plain(band, b, axis)
    from ..csrc import build
    b = b.contiguous()
    axis, outer, L, inner = _lines(b.shape, axis)
    if L < band.M:
        raise ValueError(f"conversion_solve: lines of {L} points for a {band.M}-point band")
    D, offs = band.on(b.device)
    _check_cuda('conversion_solve', b, torch.float64)
    x = torch.empty(_with_axis(b.shape, axis, band.M), dtype=torch.float64, device=b.device)
    build.check(build.library().k11_conversion_solve_f64(
        D.data_ptr(), offs.data_ptr(), len(band.offsets), b.data_ptr(), x.data_ptr(), outer, L,
        band.M, inner, _stream(b)), 'conversion_solve')
    conversion_solve.launches += 1
    return x


conversion_solve.launches = 0



# ---------------------------------------------------------------------------
# Resizing and the composite transforms
# ---------------------------------------------------------------------------

def resize_axis(data, new_size, axis):
    """Zero-pad or truncate `data` to `new_size` along `axis`."""
    axis = axis % data.ndim
    old = data.shape[axis]
    if new_size == old:
        return data
    if new_size < old:
        return torch.narrow(data, axis, 0, new_size)
    pad = torch.zeros(_with_axis(data.shape, axis, new_size - old), dtype=data.dtype,
                      device=data.device)
    return torch.cat([data, pad], dim=axis)


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
