"""
Spectral bases: the Jacobi family on an interval and the real and complex
Fourier bases, each bundling grids, dense transform matrices and sparse
operator matrices.

Mirrors dedalus_tpu/core/basis.py. All matrices are built on the host
exactly as in the JAX package; transforms apply them on the field's device
(MMT), or take the fast paths of ops/fft.py where `[transforms]
fourier_library` / `jacobi_library` ask for them, as the JAX package
dispatches (`_fast_enabled`). ComplexFourier requires complex fields; the
fast Jacobi transforms of complex data send the real and imaginary parts
through the same kernel launches as one batch of twice the lines.
"""

import numpy as np
import torch
from scipy import sparse

from ..utils.caching import CachedClass, CachedMethod, CachedAttribute
from ..utils.config import config
from ..spectral import jacobi as jacobi_lib
from ..spectral import clenshaw
from ..ops import transforms as ops_transforms
from ..ops import fft

# Size from which 'auto' takes the fast paths (dedalus_tpu/core/basis.py:24)
FAST_THRESHOLD = int(config.get('transforms', 'fast_threshold', fallback='8192'))


def _fast_enabled(library_key, size):
    """Transform plan selection, read at every call as the JAX package's
    (dedalus_tpu/core/basis.py:27-45): 'matrix' = always MMT, 'fast' = always
    the fast path, 'auto' = fast from FAST_THRESHOLD on."""
    lib = config.get('transforms', library_key, fallback='auto')
    if lib == 'matrix':
        return False
    if lib in ('fast', 'fft'):
        return True
    return size >= FAST_THRESHOLD

# Device copies of host matrices, keyed by (id(host matrix), device, dtype);
# the host matrix is kept alive beside its copy so the id stays unique.
_DEVICE_CACHE = {}


def device_copy(np_matrix, device, dtype=None):
    """The copy of a host matrix on `device`, cast to the torch `dtype`
    where given (a real operator matrix applied to complex data)."""
    key = (id(np_matrix), str(device), dtype)
    if key not in _DEVICE_CACHE:
        _DEVICE_CACHE[key] = (np_matrix, torch.as_tensor(np_matrix, device=device, dtype=dtype))
    return _DEVICE_CACHE[key][1]


class AffineCOV:
    """
    Affine change of variables between native coordinates (e.g. z in [-1,1])
    and problem coordinates (x in [x0, x1]).
    """

    def __init__(self, native_bounds, problem_bounds):
        self.native_bounds = tuple(map(float, native_bounds))
        self.problem_bounds = tuple(map(float, problem_bounds))
        n0, n1 = self.native_bounds
        p0, p1 = self.problem_bounds
        self.native_length = n1 - n0
        self.problem_length = p1 - p0
        # df/dx = stretch * df/dz
        self.stretch = self.native_length / self.problem_length

    def native_coord(self, problem_coord):
        p0, _ = self.problem_bounds
        n0, _ = self.native_bounds
        return n0 + (np.asarray(problem_coord) - p0) * self.stretch

    def problem_coord(self, native_coord):
        if isinstance(native_coord, str):
            if native_coord in ('left', 'lower'):
                return self.problem_bounds[0]
            if native_coord in ('right', 'upper'):
                return self.problem_bounds[1]
            if native_coord in ('center', 'middle'):
                return (self.problem_bounds[0] + self.problem_bounds[1]) / 2
            raise ValueError(f"Unknown position: {native_coord}")
        p0, _ = self.problem_bounds
        n0, _ = self.native_bounds
        return p0 + (np.asarray(native_coord) - n0) / self.stretch


class Basis(metaclass=CachedClass):
    """Base class for 1D spectral bases."""

    dim = 1
    constant = False
    ops_couple = False  # whether operator matrices couple modes along this axis

    def __init__(self, coord, size, bounds, dealias=1, dtype=None):
        self.coord = coord
        self.size = int(size)
        self.bounds = tuple(map(float, bounds))
        self.dealias = (float(dealias),)
        self.dtype = dtype

    @property
    def coeff_size(self):
        return self.size

    def grid_size(self, scale=1):
        return int(np.ceil(self.size * scale))

    def grid_shape(self, scales):
        scale = scales if np.isscalar(scales) else scales[0]
        return (self.grid_size(scale),)

    @property
    def group_shape(self):
        return (1,)

    def global_grid(self, scale=1):
        raise NotImplementedError

    # --- device transforms (dense matrices) ---

    def forward_transform(self, data, axis, scale, dtype, tensorsig=()):
        """grid -> coeff along axis (data at grid size for `scale`)."""
        matrix = device_copy(self._forward_matrix_host(scale, dtype), data.device)
        return ops_transforms.apply_matrix(matrix, data, axis)

    def backward_transform(self, data, axis, scale, dtype, tensorsig=()):
        """coeff -> grid along axis."""
        matrix = device_copy(self._backward_matrix_host(scale, dtype), data.device)
        return ops_transforms.apply_matrix(matrix, data, axis)

    @CachedMethod
    def _forward_matrix_host(self, scale, dtype):
        return self.forward_matrix(scale, dtype)

    @CachedMethod
    def _backward_matrix_host(self, scale, dtype):
        return self.backward_matrix(scale, dtype)

    # --- validity ---

    def valid_coeff_mask(self, tensorsig=()):
        """Validity of each coefficient (full axis)."""
        return np.ones(self.coeff_size, dtype=bool)

    def group_valid_mask(self, group, tensorsig=()):
        """Validity of each element within one mode group."""
        return np.ones(self.group_shape[0], dtype=bool)

    def conversion_matrix(self, out_basis):
        raise NotImplementedError

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


class Jacobi(Basis):
    """
    Jacobi polynomial basis on an interval: coefficients of orthonormal
    P_n^{(a,b)} on native z in [-1,1], with an affine map to problem bounds.
    Grid is the Gauss quadrature grid of the (a0, b0) "grid parameters".
    """

    ops_couple = True

    def __init__(self, coord, size, bounds, a, b, a0=None, b0=None, dealias=1, dtype=np.float64):
        super().__init__(coord, size, bounds, dealias=dealias, dtype=dtype)
        self.a = float(a)
        self.b = float(b)
        self.a0 = float(a if a0 is None else a0)
        self.b0 = float(b if b0 is None else b0)
        self.COV = AffineCOV((-1, 1), bounds)

    def clone_with(self, **kw):
        args = dict(coord=self.coord, size=self.size, bounds=self.bounds, a=self.a,
                    b=self.b, a0=self.a0, b0=self.b0, dealias=self.dealias[0], dtype=self.dtype)
        args.update(kw)
        return Jacobi(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(a=self.a + order, b=self.b + order)

    def global_grid(self, scale=1):
        N = self.grid_size(scale)
        z = jacobi_lib.build_grid(N, self.a0, self.b0)
        return self.COV.problem_coord(z)

    @CachedMethod
    def forward_matrix(self, scale, dtype):
        """Forward MMT: weighted projection onto (a,b) polynomials via (a0,b0) grid."""
        N = self.grid_size(scale)
        M = self.size
        z, w = jacobi_lib.quadrature(N, self.a0, self.b0, dtype=np.longdouble)
        if (self.a, self.b) == (self.a0, self.b0):
            P = jacobi_lib.polynomials(M, self.a, self.b, z, dtype=np.longdouble)
            mat = (P * w)
            mat[N:, :] = 0
        else:
            P = jacobi_lib.polynomials(M, self.a0, self.b0, z, dtype=np.longdouble)
            proj = (P * w)
            proj[N:, :] = 0
            conv = jacobi_lib.conversion_matrix(M, self.a0, self.b0, self.a, self.b)
            # conv is upper banded: the longdouble product conv @ proj summed
            # diagonal by diagonal (the dense product's order, without its
            # zero terms; numpy has no BLAS for longdouble)
            mat = np.zeros_like(proj)
            for d in range(M):
                cd = conv.diagonal(d)
                if np.any(cd):
                    mat[:M - d] += cd.astype(np.longdouble)[:, None] * proj[d:]
        return np.ascontiguousarray(mat.astype(dtype))

    @CachedMethod
    def backward_matrix(self, scale, dtype):
        N = self.grid_size(scale)
        M = self.size
        z = jacobi_lib.build_grid(N, self.a0, self.b0)
        P = jacobi_lib.polynomials(M, self.a, self.b, z)  # (M, N)
        P[N:, :] = 0
        return np.ascontiguousarray(P.T.astype(dtype))

    # --- fast (DCT) transform path ---
    # Valid when the grid is Gauss-Chebyshev (a0 = b0 = -1/2) and the coeff
    # params sit an integer number of ultraspherical conversions above it
    # (dedalus_tpu/core/basis.py:263-353). The grid is z-ascending
    # (theta-descending), so the grid data is reversed around the DCT.

    @CachedAttribute
    def _fast_da(self):
        """Integer ultraspherical offset, or None if the fast path is invalid."""
        if (self.a0, self.b0) != (-0.5, -0.5):
            return None
        da, db = self.a - self.a0, self.b - self.b0
        if da != db or da < 0 or da != round(da):
            return None
        return int(round(da))

    def _use_fast(self, N):
        return self._fast_da is not None and _fast_enabled('jacobi_library', max(N, self.size))

    @CachedMethod
    def _conversion_band(self, M):
        """The T -> (a,b) conversion (M x M) by its diagonals, for the
        conversion kernels of ops/fft.py."""
        K = jacobi_lib.conversion_matrix(M, self.a0, self.b0, self.a, self.b).tocsr()
        coo = K.tocoo()
        offsets = sorted(set((coo.col - coo.row).tolist()))
        diags = []
        for off in offsets:
            d = np.zeros(M)
            vals = K.diagonal(off)
            d[:len(vals)] = vals
            diags.append(d)
        return fft.ConversionBand(diags, offsets)

    @CachedMethod
    def _fast_scales(self, N):
        """Orthonormal-T scales of the DCT-II (forward) and DCT-III
        (backward) on N grid points, host f64."""
        fwd = np.full(N, np.sqrt(np.pi / 2) / N)
        fwd[0] = np.sqrt(np.pi) / (2 * N)
        bwd = np.full(N, 1 / np.sqrt(2 * np.pi))
        bwd[0] = 1 / np.sqrt(np.pi)
        return fwd, bwd

    def _fast_forward(self, data, axis, N):
        """Grid -> coeff: reverse, DCT-II, orthonormal-T scaling, resize to
        M, conversion (kernels K11a, K10, K11a, K11b)."""
        if data.is_complex():
            return _by_parts(self._fast_forward, data, axis, N)
        M = self.size
        scale = device_copy(self._fast_scales(N)[0], data.device)
        v = fft.dct2_pre(data, axis, flip=True)
        t = fft.dct2_post(fft.dft(v, -1, axis, load='real'), axis, M, scale)
        if self._fast_da:
            t = fft.conversion_apply(self._conversion_band(M), t, axis)
        return t

    def _fast_backward(self, data, axis, N):
        """Coeff -> grid: inverse conversion on the first min(M, N)
        coefficients, scaling, DCT-III, reverse (kernels K11b, K11a, K10,
        K11a)."""
        if data.is_complex():
            return _by_parts(self._fast_backward, data, axis, N)
        P = min(self.size, N)
        scale = device_copy(self._fast_scales(N)[1], data.device)
        if self._fast_da:
            data = fft.conversion_solve(self._conversion_band(P), data, axis)
        v = fft.dft(fft.dct3_pre(data, axis, N, scale), +1, axis, real_out=True)
        return fft.dct3_post(v, axis, flip=True)

    def forward_transform(self, data, axis, scale, dtype, tensorsig=()):
        N = self.grid_size(scale)
        if self._use_fast(N):
            return self._fast_forward(data, axis, N)
        return super().forward_transform(data, axis, scale, dtype, tensorsig)

    def backward_transform(self, data, axis, scale, dtype, tensorsig=()):
        N = self.grid_size(scale)
        if self._use_fast(N):
            return self._fast_backward(data, axis, N)
        return super().backward_transform(data, axis, scale, dtype, tensorsig)

    # --- operator matrices ---

    @CachedMethod
    def conversion_matrix(self, out_basis):
        return jacobi_lib.conversion_matrix(self.size, self.a, self.b, out_basis.a, out_basis.b)

    @CachedMethod
    def differentiation_matrix(self):
        """d/dx: (a,b) coeffs -> (a+1,b+1) coeffs, including the COV stretch."""
        D = jacobi_lib.differentiation_matrix(self.size, self.a, self.b)
        return self.COV.stretch * D

    @CachedMethod
    def interpolation_vector(self, position):
        zpos = self.COV.native_coord(self.COV.problem_coord(position) if isinstance(position, str) else position)
        E = jacobi_lib.interpolation_vector(self.size, self.a, self.b, zpos)
        return sparse.csr_matrix(E[None, :])

    @CachedMethod
    def integration_vector(self):
        I = jacobi_lib.integration_vector(self.size, self.a, self.b)
        return sparse.csr_matrix(I[None, :] / self.COV.stretch)

    @CachedMethod
    def lift_matrix(self, index):
        """Column mapping a size-1 tau coefficient onto polynomial `index` (e.g. -1)."""
        col = np.zeros((self.size, 1))
        col[index, 0] = 1
        return sparse.csr_matrix(col)

    def ncc_matrix(self, ncc_basis, out_basis, coeffs, cutoff=1e-6):
        """Multiplication matrix for an NCC with coefficients `coeffs` in
        `ncc_basis` acting on this (operand) basis, output in `out_basis`."""
        N = self.size
        da = int(round(out_basis.a - self.a))
        db = int(round(out_basis.b - self.b))
        # Pad to avoid truncation aliasing during Clenshaw, then truncate.
        Nmat = 3 * ((N + 1) // 2) + min((N + 1) // 2, (da + db + 1) // 2)
        Nmat = max(Nmat, N)
        J = jacobi_lib.jacobi_matrix(Nmat, self.a, self.b)
        S = clenshaw.matrix_clenshaw(np.ravel(coeffs), ncc_basis.a, ncc_basis.b, J, cutoff=cutoff)
        convert = jacobi_lib.conversion_matrix(Nmat, self.a, self.b, out_basis.a, out_basis.b)
        return sparse.csr_matrix((convert @ S)[:N, :N])

    def grid_spacing(self, scale=1):
        """The centred spacing of the grid nodes (one-sided at the ends)."""
        x = np.asarray(self.global_grid(scale))
        dx = np.zeros_like(x)
        dx[1:-1] = (x[2:] - x[:-2]) / 2
        dx[0] = x[1] - x[0]
        dx[-1] = x[-1] - x[-2]
        return np.abs(dx)

    def __repr__(self):
        return (f"Jacobi({self.coord.name}, size={self.size}, a={self.a}, b={self.b}, "
                f"a0={self.a0}, b0={self.b0})")

    def _key(self):
        return ('Jacobi', self.coord.name, self.size, self.bounds, self.a, self.b,
                self.a0, self.b0, self.dealias)

    def __eq__(self, other):
        if isinstance(other, Jacobi):
            return self._key() == other._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())


def ChebyshevT(coord, size, bounds, dealias=1, dtype=np.float64):
    """Chebyshev-T basis: Jacobi(-1/2, -1/2)."""
    return Jacobi(coord, size, bounds, a=-0.5, b=-0.5, dealias=dealias, dtype=dtype)


def ChebyshevU(coord, size, bounds, dealias=1, dtype=np.float64):
    """Chebyshev-U coefficients on the Chebyshev-T grid: Jacobi(1/2, 1/2)."""
    return Jacobi(coord, size, bounds, a=0.5, b=0.5, a0=-0.5, b0=-0.5, dealias=dealias,
                  dtype=dtype)


def ChebyshevV(coord, size, bounds, dealias=1, dtype=np.float64):
    """Jacobi(3/2, 3/2) coefficients on the Chebyshev-T grid."""
    return Jacobi(coord, size, bounds, a=1.5, b=1.5, a0=-0.5, b0=-0.5, dealias=dealias,
                  dtype=dtype)


def Legendre(coord, size, bounds, dealias=1, dtype=np.float64):
    """Legendre basis: Jacobi(0, 0) (no fast path)."""
    return Jacobi(coord, size, bounds, a=0, b=0, dealias=dealias, dtype=dtype)


def Ultraspherical(coord, size, bounds, alpha, alpha0=None, dealias=1, dtype=np.float64):
    """Gegenbauer C^(alpha) basis: Jacobi(alpha - 1/2, alpha - 1/2), on the
    grid of Jacobi(alpha0 - 1/2, alpha0 - 1/2) where alpha0 is given."""
    a = b = alpha - 0.5
    a0 = b0 = (alpha0 - 0.5) if alpha0 is not None else a
    return Jacobi(coord, size, bounds, a=a, b=b, a0=a0, b0=b0, dealias=dealias, dtype=dtype)


def _by_parts(transform, data, axis, N):
    """A real transform of complex data: the real and imaginary parts as a
    trailing axis of two (torch.view_as_real), so each kernel of the real
    transform runs once on twice the lines (the JAX package transforms the
    parts one after the other, dedalus_tpu/core/basis.py:303-341)."""
    axis = axis % data.dim()
    out = transform(torch.view_as_real(data.contiguous()), axis, N)
    return torch.view_as_complex(out.contiguous())


def _require_real(data):
    if data.is_complex():
        raise ValueError("RealFourier transforms take real data; complex data needs "
                         "ComplexFourier")


class FourierBase(Basis):
    """Common machinery for periodic Fourier bases."""

    def __init__(self, coord, size, bounds=(0, 2*np.pi), dealias=1, dtype=np.float64):
        super().__init__(coord, size, bounds, dealias=dealias, dtype=dtype)
        self.COV = AffineCOV((0, 2*np.pi), bounds)
        self.length = self.bounds[1] - self.bounds[0]

    def global_grid(self, scale=1):
        N = self.grid_size(scale)
        native = 2 * np.pi * np.arange(N) / N
        return self.COV.problem_coord(native)

    def grid_spacing(self, scale=1):
        N = self.grid_size(scale)
        return np.full(N, self.length / N)

    def derivative_basis(self, order=1):
        return self

    def Kmax_for(self, grid_size):
        KN = (grid_size - 1) // 2
        KM = (self.size - 1) // 2
        return min(KN, KM)


class RealFourier(FourierBase):
    """
    Real trigonometric basis with interleaved (cos, -sin) coefficient pairs:
        f(x) = sum_k a_k cos(k theta) - b_k sin(k theta),
    coefficients ordered [a0, b0, a1, b1, ...] (b0 identically zero).
    Group shape (2,) per wavenumber.
    """

    @property
    def wavenumbers_native(self):
        KM = (self.size - 1) // 2
        return np.repeat(np.arange(KM + 1), 2)[:max(self.size, 2)]

    @property
    def wavenumbers(self):
        return self.wavenumbers_native * self.COV.stretch

    @property
    def group_shape(self):
        # (cos, -sin) pairs; a size-1 basis holds only the constant mode
        return (min(self.size, 2),)

    @CachedMethod
    def forward_matrix(self, scale, dtype):
        N = self.grid_size(scale)
        M = max(2, self.size)
        Kmax = self.Kmax_for(N)
        K = self.wavenumbers_native[0::2][:, None]
        X = 2 * np.pi * np.arange(N)[None, :] / N
        mat = np.zeros((M, N))
        mat[0::2] = (2 / N) * np.cos(K * X)
        mat[1::2] = -(2 / N) * np.sin(K * X)
        mat[0] = 1 / N
        mat[1] = 0
        mat *= (self.wavenumbers_native[:, None] <= Kmax)
        mat = mat[:self.size]  # size-1 basis keeps only the mean row
        return np.ascontiguousarray(mat.astype(dtype))

    @CachedMethod
    def backward_matrix(self, scale, dtype):
        N = self.grid_size(scale)
        M = max(2, self.size)
        Kmax = self.Kmax_for(N)
        K = self.wavenumbers_native[None, 0::2]
        X = 2 * np.pi * np.arange(N)[:, None] / N
        mat = np.zeros((N, M))
        mat[:, 0::2] = np.cos(K * X)
        mat[:, 1::2] = -np.sin(K * X)
        mat *= (self.wavenumbers_native[None, :] <= Kmax)
        mat = mat[:, :self.size]
        return np.ascontiguousarray(mat.astype(dtype))

    def forward_transform(self, data, axis, scale, dtype, tensorsig=()):
        N = self.grid_size(scale)
        if self.size > 1 and _fast_enabled('fourier_library', max(N, self.size)):
            _require_real(data)
            return ops_transforms.real_fft_forward(data, axis, self.size, self.Kmax_for(N))
        return super().forward_transform(data, axis, scale, dtype, tensorsig)

    def backward_transform(self, data, axis, scale, dtype, tensorsig=()):
        N = self.grid_size(scale)
        if self.size > 1 and _fast_enabled('fourier_library', max(N, self.size)):
            _require_real(data)
            return ops_transforms.real_fft_backward(data, axis, N, self.Kmax_for(N))
        return super().backward_transform(data, axis, scale, dtype, tensorsig)

    def valid_coeff_mask(self, tensorsig=()):
        mask = np.ones(self.size, dtype=bool)
        if self.size > 1:
            mask[1] = False  # b_0 (the k=0 minus-sine coeff) is identically zero
        return mask

    def group_valid_mask(self, group, tensorsig=()):
        width = min(self.size, 2)
        if group == 0:
            return np.array([True, False])[:width]
        return np.ones(width, dtype=bool)

    # --- operator matrices (acting on interleaved (cos, -sin) pairs) ---

    @CachedMethod
    def differentiation_matrix(self):
        # d/dx [a cos(k th) - b sin(k th)]: per-pair block [[0, -k'], [k', 0]]
        M = self.size
        k = self.wavenumbers[0::2]
        upper = np.zeros(M - 1)
        lower = np.zeros(M - 1)
        upper[0::2] = -k
        lower[0::2] = k
        return sparse.diags([lower, upper], [-1, 1], shape=(M, M), format='csr')

    @CachedMethod
    def interpolation_vector(self, position):
        theta = self.COV.native_coord(position)
        E = np.zeros((1, self.size))
        k = self.wavenumbers_native
        E[0, 0::2] = np.cos(k[0::2] * theta)
        E[0, 1::2] = -np.sin(k[1::2] * theta)
        return sparse.csr_matrix(E)

    @CachedMethod
    def integration_vector(self):
        I = np.zeros(self.size)
        I[0] = self.length
        return sparse.csr_matrix(I[None, :])

    @CachedMethod
    def hilbert_matrix(self):
        """Hilbert transform H(exp(ikx)) = -1j sign(k) exp(ikx): pair blocks
        [[0, 1], [-1, 0]] for k > 0."""
        M = self.size
        upper = np.zeros(M - 1)
        lower = np.zeros(M - 1)
        k = self.wavenumbers_native[0::2]
        upper[0::2] = (k > 0).astype(float)
        lower[0::2] = -(k > 0).astype(float)
        return sparse.diags([lower, upper], [-1, 1], shape=(M, M), format='csr')

    def ncc_matrix(self, ncc_basis, out_basis, coeffs, cutoff=1e-6):
        """Multiplication by a real-Fourier NCC through the product-to-sum
        identities on the (cos, -sin) pairs (`_accum_pair`)."""
        M = self.size
        KM = (M - 1) // 2
        coeffs = np.ravel(coeffs)
        mat = np.zeros((M, M))
        for j in range(KM + 1):
            aj = coeffs[2*j]
            bj = coeffs[2*j + 1]
            for n in range(KM + 1):
                if abs(aj) > cutoff:
                    _accum_pair(mat, M, KM, j, n, aj, 'cc')
                    _accum_pair(mat, M, KM, j, n, aj, 'cs')
                if abs(bj) > cutoff:
                    _accum_pair(mat, M, KM, j, n, bj, 'sc')
                    _accum_pair(mat, M, KM, j, n, bj, 'ss')
        return sparse.csr_matrix(mat)

    def __repr__(self):
        return f"RealFourier({self.coord.name}, size={self.size})"

    def _key(self):
        return ('RealFourier', self.coord.name, self.size, self.bounds, self.dealias)

    def __eq__(self, other):
        if isinstance(other, RealFourier):
            return self._key() == other._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())


class ComplexFourier(FourierBase):
    """
    Complex exponential basis: unit-amplitude modes exp(i k theta), with the
    coefficients ordered k = 0, 1, ..., KM, (KM + 1 for even sizes: the
    zeroed Nyquist slot), -KM, ..., -1 (dedalus_tpu/core/basis.py:480-560).
    Group shape (1,): one signed wavenumber per group. Requires complex
    fields.
    """

    @property
    def wavenumbers_native(self):
        M = self.size
        KM = (M - 1) // 2
        return (np.arange(M) + KM) % M - KM

    @property
    def wavenumbers(self):
        return self.wavenumbers_native * self.COV.stretch

    @property
    def group_shape(self):
        return (1,)

    @CachedMethod
    def forward_matrix(self, scale, dtype):
        N = self.grid_size(scale)
        Kmax = self.Kmax_for(N)
        K = self.wavenumbers_native[:, None]
        X = 2 * np.pi * np.arange(N)[None, :] / N
        mat = np.exp(-1j * K * X) / N
        mat *= (np.abs(K) <= Kmax)
        return np.ascontiguousarray(mat.astype(dtype))

    @CachedMethod
    def backward_matrix(self, scale, dtype):
        N = self.grid_size(scale)
        Kmax = self.Kmax_for(N)
        K = self.wavenumbers_native[None, :]
        X = 2 * np.pi * np.arange(N)[:, None] / N
        mat = np.exp(1j * K * X)
        mat *= (np.abs(K) <= Kmax)
        return np.ascontiguousarray(mat.astype(dtype))

    def forward_transform(self, data, axis, scale, dtype, tensorsig=()):
        N = self.grid_size(scale)
        if _fast_enabled('fourier_library', max(N, self.size)):
            return ops_transforms.complex_fft_forward(data, axis, self.size, self.Kmax_for(N))
        return super().forward_transform(data, axis, scale, dtype, tensorsig)

    def backward_transform(self, data, axis, scale, dtype, tensorsig=()):
        N = self.grid_size(scale)
        if _fast_enabled('fourier_library', max(N, self.size)):
            return ops_transforms.complex_fft_backward(data, axis, N, self.Kmax_for(N))
        return super().backward_transform(data, axis, scale, dtype, tensorsig)

    def valid_coeff_mask(self, tensorsig=()):
        # For even sizes the wrap-around slot KM + 1 is the zeroed Nyquist mode
        mask = np.ones(self.size, dtype=bool)
        if self.size % 2 == 0:
            mask[(self.size - 1) // 2 + 1] = False
        return mask

    def group_valid_mask(self, group, tensorsig=()):
        KM = (self.size - 1) // 2
        return np.array([not (self.size % 2 == 0 and group == KM + 1)])

    # --- operator matrices ---

    @CachedMethod
    def differentiation_matrix(self):
        return sparse.diags(1j * self.wavenumbers, format='csr')

    @CachedMethod
    def interpolation_vector(self, position):
        theta = self.COV.native_coord(position)
        E = np.exp(1j * self.wavenumbers_native * theta)
        return sparse.csr_matrix(E[None, :])

    @CachedMethod
    def integration_vector(self):
        I = np.zeros(self.size, dtype=complex)
        I[0] = self.length
        return sparse.csr_matrix(I[None, :])

    @CachedMethod
    def hilbert_matrix(self):
        """Hilbert transform: the coefficients times -1j sign(k)."""
        return sparse.diags(-1j * np.sign(self.wavenumbers_native), format='csr')

    def ncc_matrix(self, ncc_basis, out_basis, coeffs, cutoff=1e-6):
        """Multiplication by an NCC: the convolution over wavenumbers."""
        M = self.size
        k = self.wavenumbers_native
        rows, cols, vals = [], [], []
        coeffs = np.ravel(coeffs)
        for j, kj in enumerate(k):
            if abs(coeffs[j]) <= cutoff:
                continue
            for n, kn in enumerate(k):
                hits = np.where(k == kj + kn)[0]
                if len(hits):
                    rows.append(hits[0])
                    cols.append(n)
                    vals.append(coeffs[j])
        return sparse.csr_matrix((vals, (rows, cols)), shape=(M, M))

    def __repr__(self):
        return f"ComplexFourier({self.coord.name}, size={self.size})"

    def _key(self):
        return ('ComplexFourier', self.coord.name, self.size, self.bounds, self.dealias)

    def __eq__(self, other):
        if isinstance(other, ComplexFourier):
            return self._key() == other._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())


class ExponentialFourier(FourierBase):
    """
    Complex exponential basis with paired (+k, -k) coefficient slots
    [e^0, (dead), e^{+i th}, e^{-i th}, e^{+2i th}, e^{-2i th}, ...]
    (dedalus_tpu/core/basis.py:784-900): group shape (2,) per |k|, as
    RealFourier's pairs, so the per-m machinery of the curvilinear bases
    batches signed wavenumbers (slot 0 = +m, slot 1 = -m). The k = 0 pair's
    second slot is a dead pad. The azimuth of complex curvilinear fields.
    Its transforms are the dense complex MMT (K1, torch.matmul), as the JAX
    package has no fast form for it either.
    """

    @CachedAttribute
    def wavenumbers_native(self):
        slot = np.arange(self.size)
        return np.where(slot % 2 == 0, slot // 2, -(slot // 2))

    @property
    def wavenumbers(self):
        return self.wavenumbers_native * self.COV.stretch

    @property
    def group_shape(self):
        return (min(self.size, 2),)

    def _dead_mask(self):
        """True on live slots; slot 1 (the -0 pad) is dead."""
        mask = np.ones(self.size, dtype=bool)
        if self.size > 1:
            mask[1] = False
        return mask

    def _live_kmax(self, N):
        return min(self.Kmax_for(N), (self.size - 1) // 2)

    @CachedMethod
    def forward_matrix(self, scale, dtype):
        N = self.grid_size(scale)
        K = self.wavenumbers_native[:, None]
        X = 2 * np.pi * np.arange(N)[None, :] / N
        mat = np.exp(-1j * K * X) / N
        mat *= (np.abs(K) <= self._live_kmax(N))
        mat *= self._dead_mask()[:, None]
        return np.ascontiguousarray(mat.astype(np.complex128))

    @CachedMethod
    def backward_matrix(self, scale, dtype):
        N = self.grid_size(scale)
        K = self.wavenumbers_native[None, :]
        X = 2 * np.pi * np.arange(N)[:, None] / N
        mat = np.exp(1j * K * X)
        mat *= (np.abs(K) <= self._live_kmax(N))
        mat *= self._dead_mask()[None, :]
        return np.ascontiguousarray(mat.astype(np.complex128))

    def valid_coeff_mask(self, tensorsig=()):
        return self._dead_mask()

    def group_valid_mask(self, group, tensorsig=()):
        width = min(self.size, 2)
        if group == 0:
            return np.array([True, False])[:width]
        return np.ones(width, dtype=bool)

    # --- operator matrices ---

    @CachedMethod
    def differentiation_matrix(self):
        return sparse.diags(1j * self.wavenumbers, format='csr')

    @CachedMethod
    def interpolation_vector(self, position):
        theta = self.COV.native_coord(position)
        E = np.exp(1j * self.wavenumbers_native * theta) * self._dead_mask()
        return sparse.csr_matrix(E[None, :].astype(complex))

    @CachedMethod
    def integration_vector(self):
        I = np.zeros(self.size, dtype=complex)
        I[0] = self.length
        return sparse.csr_matrix(I[None, :])

    @CachedMethod
    def hilbert_matrix(self):
        return sparse.diags(-1j * np.sign(self.wavenumbers_native).astype(complex),
                            format='csr')

    def ncc_matrix(self, ncc_basis, out_basis, coeffs, cutoff=1e-6):
        """Multiplication: the convolution over signed wavenumbers."""
        M = self.size
        k = self.wavenumbers_native
        live = self._dead_mask()
        slot_of = {}
        for slot in range(M):
            if live[slot] and k[slot] not in slot_of:
                slot_of[k[slot]] = slot
        coeffs = np.ravel(coeffs)
        rows, cols, vals = [], [], []
        for j in range(M):
            if not live[j] or abs(coeffs[j]) <= cutoff:
                continue
            for n in range(M):
                if live[n] and k[j] + k[n] in slot_of:
                    rows.append(slot_of[k[j] + k[n]])
                    cols.append(n)
                    vals.append(coeffs[j])
        return sparse.csr_matrix((vals, (rows, cols)), shape=(M, M))

    def __repr__(self):
        return f"ExponentialFourier({self.coord.name}, size={self.size})"

    def _key(self):
        return ('ExponentialFourier', self.coord.name, self.size, self.bounds, self.dealias)

    def __eq__(self, other):
        if isinstance(other, ExponentialFourier):
            return self._key() == other._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())


def _accum_pair(mat, M, KM, j, n, val, kind):
    """
    Accumulate the product-to-sum terms of NCC mode j (coefficient `val`)
    and operand mode n into the RealFourier NCC matrix; kind in
    {'cc', 'cs', 'sc', 'ss'} names (NCC part, operand part), c = cos and
    S = -sin:
      cos j cos n = 1/2 cos(j+n) + 1/2 cos(j-n)
      cos j S n   = 1/2 S(j+n) - 1/2 S(j-n)
      S j cos n   = 1/2 S(j+n) + 1/2 S(j-n)
      S j S n     = -1/2 cos(j+n) + 1/2 cos(j-n)
    with S(-k) = -S(k) and cos(-k) = cos(k).
    """
    def put(kout, part, amp):
        k = abs(kout)
        if k > KM:
            return
        if part == 's' and kout < 0:
            amp = -amp
        if part == 's' and k == 0:
            return
        row = 2 * k + (1 if part == 's' else 0)
        if row < M:
            mat[row, col] += amp

    if kind == 'cc':
        col = 2 * n
        put(j + n, 'c', val / 2)
        put(j - n, 'c', val / 2)
    elif kind == 'cs':
        col = 2 * n + 1
        put(j + n, 's', val / 2)
        put(j - n, 's', -val / 2)
    elif kind == 'sc':
        col = 2 * n
        put(j + n, 's', val / 2)
        put(j - n, 's', val / 2)
    elif kind == 'ss':
        col = 2 * n + 1
        put(j + n, 'c', -val / 2)
        put(j - n, 'c', val / 2)


def Fourier(*args, dtype=None, **kw):
    """RealFourier for float64, ComplexFourier for complex128
    (dedalus_tpu/core/basis.py:603)."""
    if dtype is None:
        raise ValueError("dtype must be specified")
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        return RealFourier(*args, **kw)
    if dtype == np.complex128:
        return ComplexFourier(*args, **kw)
    raise ValueError(f"Unrecognized dtype: {dtype}")
